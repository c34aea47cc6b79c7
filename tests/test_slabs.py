"""Fully distributed slab engine (parallel/slabs.py) on the 8-device CPU mesh.

Checks the three contracts: (1) physics equals the single-device cell-list
path per particle id, (2) per-device memory is O(N/D + caps) by construction
(p_cap ≪ N), with cross-slab migration conserving particles, (3) capacity
misses are counted in diagnostics, never silent.
"""

import pytest

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from smoothed_particle_hydrodynamics_tpu.models import make_scene
from smoothed_particle_hydrodynamics_tpu.ops.step import step
from smoothed_particle_hydrodynamics_tpu.parallel import slabs
from smoothed_particle_hydrodynamics_tpu.parallel.sharding import make_mesh

# End-to-end / compiled-kernel tests: minutes each on the virtual CPU
# mesh.  Excluded from the default lane (pyproject addopts -m "not slow");
# run the full lane with:  pytest -q -m ""  (see README Testing).
pytestmark = pytest.mark.slow


def _scene(n=4096, **kw):
    base = dict(num_particles=n, grid_nx=16, grid_ny=16, grid_nz=16,
                cell_capacity=32, range_slice=64)
    base.update(kw)
    return make_scene("dam_break", **base)


def _run_single(cfg, state, steps):
    f = jax.jit(partial(step, cfg, backend="celllist"))
    for _ in range(steps):
        state, d = f(state)
    return state, d


def test_slab_step_matches_single_device():
    steps = 3
    cfg, state = _scene()
    mesh = make_mesh(8)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8)
    assert p_cap < cfg.num_particles, "p_cap must be O(N/D), not O(N)"

    carry = slabs.distribute(cfg, state, mesh, p_cap)
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False)
    for _ in range(steps):
        carry, diag = f(carry)
    got = slabs.collect(carry, cfg.num_particles)

    ref, ref_diag = _run_single(cfg, state, steps)

    assert int(diag.migration_dropped) == 0
    assert int(diag.halo_dropped) == 0
    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref.position),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.velocity),
                               np.asarray(ref.velocity),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(diag.kinetic_energy),
                               float(ref_diag.kinetic_energy), rtol=1e-4)
    # |L| must be the norm of the psum'd VECTOR, not the psum of per-shard
    # norms (those differ by ~12% on this scene)
    np.testing.assert_allclose(float(diag.angular_momentum),
                               float(ref_diag.angular_momentum), rtol=1e-4)
    np.testing.assert_allclose(float(diag.neighbor_mean),
                               float(ref_diag.neighbor_mean), rtol=1e-5)


def test_migration_conserves_particles():
    """Push every particle upward in z so slab crossings actually happen."""
    steps = 4
    cfg, state = _scene()
    # strong +z velocity: ~0.4 cells/step => guaranteed boundary crossings
    vz = 0.4 * cfg.cell_size / cfg.dt * cfg.sim_scale
    state = state._replace(
        velocity=state.velocity.at[:, 2].set(vz))
    mesh = make_mesh(8)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8, headroom=2.0)
    carry = slabs.distribute(cfg, state, mesh, p_cap)
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False)
    counts0 = int(np.asarray(carry.count).sum())
    migrated_any = False
    prev = np.asarray(carry.count)
    for _ in range(steps):
        carry, diag = f(carry)
        cur = np.asarray(carry.count)
        migrated_any = migrated_any or (cur != prev).any()
        prev = cur
    assert int(np.asarray(carry.count).sum()) == counts0
    assert int(diag.migration_dropped) == 0
    assert migrated_any, "no particle ever crossed a slab boundary"

    # physics still matches the single-device oracle after migrations
    got = slabs.collect(carry, cfg.num_particles)
    ref, _ = _run_single(cfg, state, steps)
    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref.position),
                               rtol=1e-5, atol=1e-5)


def test_undersized_halo_is_counted():
    """A halo window smaller than an edge plane's population must surface in
    halo_dropped (the plane rows the fixed window could not carry)."""
    cfg, state = _scene()
    mesh = make_mesh(8)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8)
    small_h = 64  # deliberately below the densest plane population
    carry = slabs.distribute(cfg, state, mesh, p_cap)
    f = slabs.make_slab_step(cfg, mesh, p_cap, small_h, m_cap, donate=False)
    _, diag = f(carry)
    zp = np.floor(np.asarray(state.position)[:, 2] / cfg.cell_size).astype(int)
    plane = np.bincount(np.clip(zp, 0, cfg.grid_nz - 1), minlength=cfg.grid_nz)
    if plane.max() > small_h:
        assert int(diag.halo_dropped) > 0
    else:  # scene too sparse for the starvation to trigger — fail loudly
        raise AssertionError("test scene no longer dense enough to starve h_cap")


def test_capacity_misses_are_counted():
    """A starved migration buffer must surface in migration_dropped."""
    cfg, state = _scene(n=2048)
    vz = 0.4 * cfg.cell_size / cfg.dt * cfg.sim_scale
    state = state._replace(velocity=state.velocity.at[:, 2].set(vz))
    mesh = make_mesh(8)
    p_cap, h_cap, _ = slabs.derive_slab_caps(cfg, state, 8, headroom=2.0)
    m_cap = 64  # deliberately tiny (derive_slab_caps floor)
    carry = slabs.distribute(cfg, state, mesh, p_cap)
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False)
    dropped = 0
    for _ in range(4):
        carry, diag = f(carry)
        dropped += int(diag.migration_dropped)
    total = int(np.asarray(carry.count).sum())
    assert total + dropped == cfg.num_particles, (
        "every lost particle must be accounted for in migration_dropped")


def test_multi_slab_hop_is_delivered():
    """A particle moving MORE than one slab between rebins is routed hop by
    hop to its destination (uniform while_loop) — nothing dropped, nothing
    mis-binned, physics equal to the single-device oracle.  (Each device
    owns 2 z-planes here, so 2.5 planes/step of drift jumps ≥ 2 devices.)"""
    steps = 2
    cfg, state = _scene(n=2048)
    vz = 2.5 * cfg.cell_size / cfg.dt * cfg.sim_scale
    state = state._replace(velocity=state.velocity.at[:, 2].set(vz))
    mesh = make_mesh(8)
    # generous p_cap: the streaming cloud re-concentrates upward and the
    # point of THIS test is routing, not capacity accounting (that is
    # test_capacity_misses_are_counted / test_dynamic_rebalance)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8, headroom=4.0)
    carry = slabs.distribute(cfg, state, mesh, p_cap)
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False)
    dropped = 0
    for _ in range(steps):
        carry, diag = f(carry)
        dropped += int(diag.migration_dropped)
    assert dropped == 0, "multi-hop routing must deliver, not drop"
    assert int(np.asarray(carry.count).sum()) == cfg.num_particles
    got = slabs.collect(carry, cfg.num_particles)
    ref, _ = _run_single(cfg, state, steps)
    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref.position),
                               rtol=1e-5, atol=1e-5)


def test_uniform_translation_never_rebins_slab():
    """Common-mode motion must not expire the frozen slab structure: the
    spread trigger sees zero RELATIVE drift while the cloud coasts across
    many cells (and slab boundaries get crossed only at the eventual rebin)."""
    steps = 6
    cfg, state = _scene(cell_size_factor=1.25)
    from smoothed_particle_hydrodynamics_tpu.ops.lazy import skin_half

    # uniform +z velocity: one FULL skin of common-mode drift per step —
    # the old per-particle trigger would rebin every step
    vz = skin_half(cfg) / (cfg.dt / cfg.sim_scale)
    state = state._replace(velocity=jnp.zeros_like(state.velocity)
                           .at[:, 2].set(vz))
    mesh = make_mesh(8)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8, headroom=2.0)
    carry = slabs.distribute(cfg, state, mesh, p_cap)
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False)
    for _ in range(steps):
        carry, diag = f(carry)
    rebins = int(np.asarray(carry.rebin_count)[0])
    assert rebins <= 1 + steps // 4, (
        f"coasting cloud rebinned {rebins}x in {steps} steps — the spread "
        "trigger is not seeing relative drift")
    assert int(diag.migration_dropped) == 0
    got = slabs.collect(carry, cfg.num_particles)
    ref, _ = _run_single(cfg, state, steps)
    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref.position),
                               rtol=1e-5, atol=1e-5)


def test_balanced_zsplit_matches_and_shrinks_pcap():
    """Occupancy-weighted plane partition: same physics as uniform slabs,
    but the densest device's capacity (= memory and sweep work) drops on a
    mass-concentrated scene."""
    steps = 2
    cfg, state = _scene()
    mesh = make_mesh(8)

    zsplit = slabs.derive_zsplit(cfg, state, 8)
    assert zsplit[0] == 0 and zsplit[-1] == cfg.grid_nz
    assert all(b - a >= 2 for a, b in zip(zsplit, zsplit[1:]))

    p_u, _, _ = slabs.derive_slab_caps(cfg, state, 8)
    p_b, h_b, m_b = slabs.derive_slab_caps(cfg, state, 8, zsplit=zsplit)
    assert p_b <= p_u, "balanced partition must not need more capacity"

    carry = slabs.distribute(cfg, state, mesh, p_b, zsplit=zsplit)
    f = slabs.make_slab_step(cfg, mesh, p_b, h_b, m_b, donate=False,
                             zsplit=zsplit)
    for _ in range(steps):
        carry, diag = f(carry)
    got = slabs.collect(carry, cfg.num_particles)
    ref, _ = _run_single(cfg, state, steps)
    assert int(diag.migration_dropped) == 0
    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref.position),
                               rtol=1e-5, atol=1e-5)


def test_lazy_slab_freezes_rebuilds_and_matches_eager():
    """Drift below the (cell-h)/2 skin: the lazy engine must freeze the sort
    + window tables across steps (rebin_count stays at the initial build) and
    still produce the same physics as rebinning every step — the frozen
    structure is a candidate SUPERSET and the kernels mask true distances."""
    steps = 6
    # 1.25h cells: 0.125h drift skin (the dam_break default is h-cells = zero
    # skin, which degrades the lazy engine to eager — correct, never faster)
    cfg, state = _scene(cell_size_factor=1.25)
    # zero velocities: drift/step ~2e-5 world units << the 0.0125 skin
    state = state._replace(velocity=state.velocity * 0.0)
    mesh = make_mesh(8)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8)

    results = {}
    for lazy in (True, False):
        carry = slabs.distribute(cfg, state, mesh, p_cap)
        f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap,
                                 donate=False, lazy=lazy)
        for _ in range(steps):
            carry, diag = f(carry)
        results[lazy] = (carry, slabs.collect(carry, cfg.num_particles), diag)

    lazy_carry, lazy_state, lazy_diag = results[True]
    eager_carry, eager_state, eager_diag = results[False]
    rebins_lazy = int(np.asarray(lazy_carry.rebin_count)[0])
    rebins_eager = int(np.asarray(eager_carry.rebin_count)[0])
    assert rebins_eager == steps
    assert rebins_lazy < steps, (
        f"lazy engine rebuilt every step ({rebins_lazy}/{steps}) — "
        "the drift skin never engaged")
    np.testing.assert_allclose(np.asarray(lazy_state.position),
                               np.asarray(eager_state.position),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(lazy_diag.kinetic_energy),
                               float(eager_diag.kinetic_energy), rtol=1e-5)
    np.testing.assert_allclose(float(lazy_diag.neighbor_mean),
                               float(eager_diag.neighbor_mean), rtol=1e-6)


def test_dynamic_rebalance_prevents_overflow():
    """Mass streaming toward the box floor overloads the t=0 partition: the
    static split overflows p_cap (counted drops), while host-side
    maybe_rebalance at block boundaries re-derives the split + caps from the
    CURRENT histogram and the same run completes clean."""

    steps, block = 12, 2
    cfg, state = _scene()
    vz = -0.3 * cfg.cell_size / cfg.dt * cfg.sim_scale
    state = state._replace(velocity=state.velocity.at[:, 2].set(vz))
    mesh = make_mesh(8)
    zsplit = slabs.derive_zsplit(cfg, state, 8)
    _, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8, headroom=2.0,
                                             zsplit=zsplit)
    # p_cap just above the initial max slab population: any concentration
    # beyond the t=0 layout overflows
    zp = np.floor(np.asarray(state.position)[:, 2] / cfg.cell_size).astype(int)
    plane = np.bincount(np.clip(zp, 0, cfg.grid_nz - 1), minlength=cfg.grid_nz)
    slab_pop = max(plane[a:b].sum() for a, b in zip(zsplit, zsplit[1:]))
    p_cap = -(-int(slab_pop + 64) // 128) * 128

    # --- static split: drops ---
    carry = slabs.distribute(cfg, state, mesh, p_cap, zsplit=zsplit)
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False,
                             zsplit=zsplit)
    dropped_static = 0
    for _ in range(steps):
        carry, diag = f(carry)
        dropped_static += int(diag.migration_dropped)
    assert dropped_static > 0, (
        "scene no longer overloads the static split — tighten p_cap")

    # --- with block-boundary rebalancing: clean ---
    carry = slabs.distribute(cfg, state, mesh, p_cap, zsplit=zsplit)
    caps = (p_cap, h_cap, m_cap)
    zs = zsplit
    f = slabs.make_slab_step(cfg, mesh, *caps, donate=False, zsplit=zs)
    dropped = 0
    rebalanced = 0
    for b in range(steps // block):
        for _ in range(block):
            carry, diag = f(carry)
            dropped += int(diag.migration_dropped)
        carry2, zs2, caps2, changed = slabs.maybe_rebalance(
            cfg, mesh, carry, cfg.num_particles, threshold=1.2)
        if changed:
            carry, zs, caps = carry2, zs2, caps2
            f = slabs.make_slab_step(cfg, mesh, *caps, donate=False, zsplit=zs)
            rebalanced += 1
    assert rebalanced > 0, "imbalance never crossed the rebalance threshold"
    assert dropped == 0, f"rebalanced run still dropped {dropped} particles"
    assert int(np.asarray(carry.count).sum()) == cfg.num_particles


def test_long_march_conservation():
    """60 steps of a tall-velocity dam break: particles stream across many
    slab boundaries; counts stay conserved, nothing drops, energies finite."""
    cfg, state = _scene(n=2048)
    vz = 0.25 * cfg.cell_size / cfg.dt * cfg.sim_scale
    state = state._replace(velocity=state.velocity.at[:, 2].set(vz))
    mesh = make_mesh(8)
    zsplit = slabs.derive_zsplit(cfg, state, 8)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8, headroom=3.0,
                                                 zsplit=zsplit)
    carry = slabs.distribute(cfg, state, mesh, p_cap, zsplit=zsplit)
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False,
                             zsplit=zsplit)
    for i in range(60):
        carry, diag = f(carry)
        if i % 20 == 19:
            assert int(diag.migration_dropped) == 0, f"step {i}"
            assert np.isfinite(float(diag.kinetic_energy)), f"step {i}"
            assert int(np.asarray(carry.count).sum()) == cfg.num_particles


def test_slab_scan_block_matches_per_step_dispatch():
    """scan_block=K (K steps per dispatch via lax.scan) must reproduce the
    per-step dispatch trajectory AND per-step diagnostics exactly — it is a
    dispatch-amortization dial, not a different engine."""
    steps, k = 6, 3
    cfg, state = _scene(cell_size_factor=1.25)
    mesh = make_mesh(8)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 8)

    carry = slabs.distribute(cfg, state, mesh, p_cap)
    f1 = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False)
    diags1 = []
    for _ in range(steps):
        carry, d = f1(carry)
        diags1.append(float(d.kinetic_energy))
    ref = slabs.collect(carry, cfg.num_particles)

    carry = slabs.distribute(cfg, state, mesh, p_cap)
    fk = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False,
                              scan_block=k)
    diagsk = []
    for _ in range(steps // k):
        carry, dk = fk(carry)
        assert dk.kinetic_energy.shape == (k,), dk.kinetic_energy.shape
        diagsk.extend(np.asarray(dk.kinetic_energy).tolist())
    got = slabs.collect(carry, cfg.num_particles)

    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref.position), rtol=0, atol=0)
    np.testing.assert_allclose(diagsk, diags1, rtol=1e-6)


