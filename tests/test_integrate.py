"""Integrator, boundary, CFL, and energy-tally tests."""

import jax
import jax.numpy as jnp
import numpy as np

from smoothed_particle_hydrodynamics_tpu.config import SphConfig
from smoothed_particle_hydrodynamics_tpu.ops import physics
from smoothed_particle_hydrodynamics_tpu.ops.integrate import (
    energy_tally, kdk_integrate, reflect_boundary)
from smoothed_particle_hydrodynamics_tpu.state import ParticleState


def test_kdk_free_particle_drift():
    """Zero acceleration, zero central mass: pure drift."""
    cfg = SphConfig(num_particles=1, central_mass=0.0)
    state = ParticleState.from_arrays(
        jnp.asarray([[3.0, 3.0, 3.0]]), jnp.asarray([[1.0, 2.0, 3.0]]), cfg=cfg)
    acc = jnp.zeros((1, 3))
    new, _ = kdk_integrate(cfg, state, acc)
    expected = np.asarray([3.0, 3.0, 3.0]) + np.asarray([1.0, 2.0, 3.0]) * cfg.dt
    np.testing.assert_allclose(np.asarray(new.position[0]), expected, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(new.velocity[0]), [1.0, 2.0, 3.0], rtol=1e-6)


def test_kdk_matches_reference_sequence():
    """v_half = v + a dt/2; x' = x + v_half dt; v' = v_half + a_grav(x') dt
    (/root/reference/src/sph.cpp:959-995)."""
    cfg = SphConfig(num_particles=1)
    pos = jnp.asarray([[4.0, 3.2, 3.2]])
    vel = jnp.asarray([[0.0, 0.0, 10.0]])
    acc = jnp.asarray([[1.0, -2.0, 0.5]])
    state = ParticleState.from_arrays(pos, vel, cfg=cfg)
    new, _ = kdk_integrate(cfg, state, acc)

    v_half = np.asarray(vel) + np.asarray(acc) * cfg.dt * 0.5
    x_new = np.asarray(pos) + v_half * cfg.dt / cfg.sim_scale
    a2 = np.asarray(physics.central_gravity(cfg, jnp.asarray(x_new)))
    v_new = v_half + a2 * cfg.dt
    np.testing.assert_allclose(np.asarray(new.position), x_new, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(new.velocity), v_new, rtol=1e-6)


def test_central_gravity_points_inward():
    cfg = SphConfig()
    c = np.asarray(cfg.central_pos)
    pos = jnp.asarray([c + [1.0, 0.0, 0.0], c - [0.0, 2.0, 0.0]], jnp.float32)
    a = np.asarray(physics.central_gravity(cfg, pos))
    assert a[0, 0] < 0 and abs(a[0, 1]) < 1e-6
    assert a[1, 1] > 0


def test_cfl_clamp():
    cfg = SphConfig(cfl_limit=10.0)
    acc = jnp.asarray([[100.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    out = np.asarray(physics.cfl_clamp(cfg, acc))
    np.testing.assert_allclose(np.linalg.norm(out[0]), 10.0, rtol=1e-5)
    np.testing.assert_allclose(out[1], [1.0, 1.0, 1.0], rtol=1e-6)


def test_reflect_boundary_flips_and_stays_inside():
    cfg = SphConfig(boundary="reflect", damping=0.5)
    box = np.asarray(cfg.box_max)
    old = jnp.asarray([[0.05, 3.0, 3.0]])
    new = jnp.asarray([[-0.05, 3.0, 3.0]])           # crossed x=0
    vel = jnp.asarray([[-10.0, 0.0, 0.0]])
    out_pos, out_vel = reflect_boundary(cfg, old, new, vel)
    assert float(out_vel[0, 0]) == 10.0              # normal component flipped
    assert 0.0 <= float(out_pos[0, 0]) <= box[0]


def test_energy_tally_compat_vs_default():
    cfg = SphConfig()
    pos = jnp.asarray([[4.2, 3.2, 3.2]])
    vel = jnp.asarray([[0.0, 0.0, 5.0]])
    mass = jnp.asarray([2.0])
    t_default = energy_tally(cfg, pos, vel, mass)
    t_compat = energy_tally(cfg.replace(compat=True), pos, vel, mass)
    ke = 0.5 * 2.0 * 25.0
    np.testing.assert_allclose(float(t_default.kinetic), ke, rtol=1e-6)
    np.testing.assert_allclose(float(t_compat.kinetic), ke, rtol=1e-6)
    gm = cfg.grav_constant * cfg.central_mass
    d = 1.0
    soft = cfg.softening_eff
    np.testing.assert_allclose(float(t_default.potential), -gm * 2.0 / (d + soft), rtol=1e-5)
    # quirk 8: compat divides by (d+eps)^3
    np.testing.assert_allclose(float(t_compat.potential), -gm * 2.0 / (d + soft) ** 3, rtol=1e-5)
    # compat |L| is always 0 (reference's accumulation is commented out)
    assert float(t_compat.angular_momentum) == 0.0
    assert float(t_default.angular_momentum) > 0.0


def test_dam_break_stays_in_box():
    """Reflective boundary keeps a falling block inside over many steps."""
    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu.ops.step import run_steps

    cfg, state = make_scene("dam_break", num_particles=2048)
    final, diags = jax.jit(
        lambda s: run_steps(cfg, s, 25))(state)
    pos = np.asarray(final.position)
    box = np.asarray(cfg.box_max)
    assert (pos >= 0).all() and (pos <= box).all()
    assert np.isfinite(np.asarray(diags.kinetic_energy)).all()


def test_reflect_boundary_sim_scale_invariant():
    """Crossing geometry must be exact for sim_scale != 1 (displacement form)."""
    cfg1 = SphConfig(boundary="reflect", damping=0.5, sim_scale=1.0)
    cfg2 = SphConfig(boundary="reflect", damping=0.5, sim_scale=4.0)
    old = jnp.asarray([[0.05, 3.0, 3.0]])
    new = jnp.asarray([[-0.05, 3.0, 3.0]])
    vel1 = jnp.asarray([[-10.0, 0.0, 0.0]])
    vel2 = vel1 * 4.0  # same displacement: drift uses vel * dt / sim_scale
    p1, v1 = reflect_boundary(cfg1, old, new, vel1)
    p2, v2 = reflect_boundary(cfg2, old, new, vel2)
    # same displacement, same walls -> identical bounce position
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), rtol=1e-6)
    assert float(v1[0, 0]) == 10.0 and float(v2[0, 0]) == 40.0
    # bounce geometry: impact at x=0 half-way, damped reflected remainder
    np.testing.assert_allclose(float(p1[0, 0]), 0.025, rtol=1e-5)


def test_energy_tally_at_rest_has_potential():
    """Default mode must count at-rest particles in PE (dam-break step 0);
    compat keeps the reference's dot>0 exclusion (src/sph.cpp:1001-1013)."""
    cfg = SphConfig()
    pos = jnp.asarray([[4.2, 3.2, 3.2]])
    vel = jnp.zeros((1, 3))
    mass = jnp.asarray([2.0])
    t_default = energy_tally(cfg, pos, vel, mass)
    t_compat = energy_tally(cfg.replace(compat=True), pos, vel, mass)
    assert float(t_default.potential) < 0.0
    assert float(t_compat.potential) == 0.0
    assert float(t_default.kinetic) == 0.0


def test_dam_break_step0_nonzero_pe():
    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu.ops.step import step

    cfg, state = make_scene("dam_break", num_particles=2048,
                            central_mass=1e4)  # need a central mass for PE
    _, diag = jax.jit(lambda s: step(cfg, s))(state)
    assert float(diag.potential_energy) < 0.0


def test_energy_tally_stacked_matches_naive():
    """The stacked [N,5] reduction (one fused kernel)
    must agree with the per-scalar formulation, and l_vec must carry the
    UN-normed vector so distributed callers can psum it before the norm."""
    rng = np.random.default_rng(7)
    n = 4096
    cfg = SphConfig(num_particles=n)
    pos = jnp.asarray(rng.uniform(0.5, 6.0, (n, 3)), jnp.float32)
    vel = jnp.asarray(rng.normal(0.0, 2.0, (n, 3)), jnp.float32)
    mass = jnp.asarray(rng.uniform(0.5, 2.0, (n,)), jnp.float32)
    t = energy_tally(cfg, pos, vel, mass)

    center = np.asarray(cfg.central_pos, np.float64)
    rel = (np.asarray(pos, np.float64) - center) * cfg.sim_scale
    v = np.asarray(vel, np.float64)
    m = np.asarray(mass, np.float64)
    ke = 0.5 * np.sum(m * np.sum(v * v, axis=1))
    gm = cfg.grav_constant * cfg.central_mass
    pe = -np.sum(gm * m / (np.linalg.norm(rel, axis=1) + cfg.softening_eff))
    l_vec = np.sum(m[:, None] * np.cross(rel, v), axis=0)

    np.testing.assert_allclose(float(t.kinetic), ke, rtol=1e-5)
    np.testing.assert_allclose(float(t.potential), pe, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(t.l_vec), l_vec, rtol=1e-4)
    np.testing.assert_allclose(float(t.angular_momentum),
                               np.linalg.norm(l_vec), rtol=1e-4)

    # shard the particles two ways: psum(l_vec) then norm must equal the
    # global norm; the sum of per-shard norms must NOT be relied on
    ta = energy_tally(cfg, pos[: n // 2], vel[: n // 2], mass[: n // 2])
    tb = energy_tally(cfg, pos[n // 2:], vel[n // 2:], mass[n // 2:])
    np.testing.assert_allclose(
        float(jnp.linalg.norm(ta.l_vec + tb.l_vec)),
        np.linalg.norm(l_vec), rtol=1e-4)


def test_energy_tally_zero_gm_keeps_nan_canary():
    """With G*M == 0 the PE sqrt/divide pass is skipped statically, but
    non-finite POSITIONS must still surface as non-finite PE so
    detect_blowup keeps firing (the 0*x canary in energy_tally)."""
    cfg = SphConfig(central_mass=0.0)
    pos = jnp.asarray([[1.0, 1.0, 1.0], [jnp.nan, 1.0, 1.0]])
    vel = jnp.ones((2, 3))
    mass = jnp.ones((2,))
    t = energy_tally(cfg, pos, vel, mass)
    assert not np.isfinite(float(t.potential))
    assert np.isfinite(float(t.kinetic))
    # finite positions: PE exactly zero, KE unaffected
    t2 = energy_tally(cfg, jnp.ones((2, 3)), vel, mass)
    assert float(t2.potential) == 0.0
    assert float(t2.kinetic) > 0.0
