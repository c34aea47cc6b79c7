"""Lazy rebinning driver: correctness under frozen bins + forced rebins.

Covers the drift-bound contract of ``ops.lazy`` (module docstring): physics
under stale bins must match the eager per-step-rebin path exactly (the pair
mask tests true distances; the skin guarantees candidate coverage), rebins
must fire when drift crosses (cell_size - h)/2, and a zero-skin config must
degrade to rebinning every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from functools import partial

from smoothed_particle_hydrodynamics_tpu.models import make_scene
from smoothed_particle_hydrodynamics_tpu.ops import lazy
from smoothed_particle_hydrodynamics_tpu.ops.step import step

# End-to-end / compiled-kernel tests: minutes each on the virtual CPU
# mesh.  Excluded from the default lane (pyproject addopts -m "not slow");
# run the full lane with:  pytest -q -m ""  (see README Testing).
pytestmark = pytest.mark.slow


def _scene(**kw):
    base = dict(num_particles=768, pallas_interpret=True)
    base.update(kw)
    return make_scene("splash", **base)


def _run_lazy(cfg, state, steps):
    carry = jax.jit(partial(lazy.init_lazy, cfg))(state)
    f = jax.jit(partial(lazy.lazy_step, cfg))
    for _ in range(steps):
        carry, diag = f(carry)
    return carry, diag


def test_lazy_matches_eager_pallas():
    """With a 1.5h skin, several steps run on frozen bins — results must match
    the eager pallas path that rebins every step (same physics, both exact)."""
    steps = 6
    cfg, state = _scene(cell_size_factor=1.5)
    carry, _ = _run_lazy(cfg, state, steps)
    assert int(carry.rebin_count) < steps, "no step reused frozen bins"
    got = lazy.unsort_carry(carry)

    ref_state = state
    f = jax.jit(partial(step, cfg, backend="pallas"))
    for _ in range(steps):
        ref_state, _ = f(ref_state)

    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref_state.position),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.density),
                               np.asarray(ref_state.density),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.neighbor_count),
                                  np.asarray(ref_state.neighbor_count))


def test_forced_rebin_on_drift():
    """Artificially drift one particle past the skin: the next step must
    rebuild (rebin_count increments, steps_since resets)."""
    cfg, state = _scene(cell_size_factor=1.5)
    carry, _ = _run_lazy(cfg, state, 1)
    base_rebins = int(carry.rebin_count)

    kick = jnp.zeros_like(carry.state.position).at[0, 0].set(
        lazy.skin_half(cfg) * 2.5)
    carry = carry._replace(state=carry.state._replace(
        position=carry.state.position + kick))
    f = jax.jit(partial(lazy.lazy_step, cfg))
    carry, _ = f(carry)
    assert int(carry.rebin_count) == base_rebins + 1
    assert int(carry.steps_since) == 0


def test_zero_skin_rebins_every_step():
    """cell_size_factor=1 has zero skin: every step after the first must
    rebuild (correct-but-eager degradation)."""
    steps = 4
    cfg, state = _scene(cell_size_factor=1.0)
    carry, _ = _run_lazy(cfg, state, steps)
    assert int(carry.rebin_count) == steps - 1 or int(carry.rebin_count) == steps


def test_unsort_carry_roundtrip():
    """unsort_carry must restore the caller's particle order: masses are
    distinct per particle, so equality identifies the permutation."""
    cfg, state = _scene(cell_size_factor=1.5)
    state = state._replace(
        mass=jnp.arange(1, state.n + 1, dtype=jnp.float32))
    carry, _ = _run_lazy(cfg, state, 3)
    got = lazy.unsort_carry(carry)
    np.testing.assert_array_equal(np.asarray(got.mass), np.asarray(state.mass))


def test_validate_rejects_unsupported_modes():
    cfg, state = _scene(second_kick="full")
    with pytest.raises(ValueError):
        lazy.init_lazy(cfg, state)


def test_uniform_translation_never_rebins():
    """Common-mode motion must not expire frozen bins: the trigger is the
    per-axis displacement SPREAD (module docstring), so a cloud translating
    many skins of distance keeps its structure — and the frozen-bin physics
    still matches the eager per-step-rebin path exactly."""
    steps = 6
    cfg, state = make_scene("disk", num_particles=768,
                            pallas_interpret=True, cell_size_factor=1.5,
                            central_mass=0.0)
    # uniform velocity: one full skin_half of common drift per step — the
    # old per-particle bound would rebuild every step (6 skins total)
    v = lazy.skin_half(cfg) * cfg.sim_scale / cfg.dt
    state = state._replace(velocity=jnp.broadcast_to(
        jnp.asarray([v, 0.0, 0.0], jnp.float32), state.velocity.shape))
    carry, _ = _run_lazy(cfg, state, steps)
    assert int(carry.rebin_count) == 0, (
        f"translating cloud rebuilt {int(carry.rebin_count)}x — the spread "
        "trigger is not seeing relative drift")
    got = lazy.unsort_carry(carry)

    ref_state = state
    f = jax.jit(partial(step, cfg, backend="pallas"))
    for _ in range(steps):
        ref_state, _ = f(ref_state)
    np.testing.assert_allclose(np.asarray(got.position),
                               np.asarray(ref_state.position),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.neighbor_count),
                                  np.asarray(ref_state.neighbor_count))


def test_scan_block_matches_host_loop():
    """drive_loop_lazy(scan_block=K) must reproduce the host loop exactly:
    same final state, same per-step diagnostics (incl. a remainder tail
    when num_steps % K != 0)."""
    cfg, state = _scene()
    st_a, di_a = lazy.drive_loop_lazy(cfg, state, 7)
    st_b, di_b = lazy.drive_loop_lazy(cfg, state, 7, scan_block=3)
    np.testing.assert_array_equal(np.asarray(st_a.position),
                                  np.asarray(st_b.position))
    np.testing.assert_array_equal(np.asarray(st_a.velocity),
                                  np.asarray(st_b.velocity))
    for a, b in zip(jax.tree.leaves(di_a), jax.tree.leaves(di_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
