"""Unit tests for compat-emulation internals and the sweep window tables."""

import numpy as np
import jax
import jax.numpy as jnp

from smoothed_particle_hydrodynamics_tpu.compat.neighbors import (
    _trunc_mod, build_cell_table)
from smoothed_particle_hydrodynamics_tpu.config import SphConfig


def test_trunc_mod_matches_c_semantics():
    """C's % truncates toward zero; sign follows the dividend."""
    cases = [(7, 3, 1), (-7, 3, -1), (7, 1, 0), (-2147480000, 7, -2147480000 % -7 if False else None)]
    for a, b, expect in cases[:3]:
        got = int(_trunc_mod(jnp.int32(a), jnp.int32(b)))
        assert got == expect, (a, b, got)
    # bulk check vs python emulation of C
    rng = np.random.RandomState(0)
    a = rng.randint(-2**31, 2**31 - 1, size=1000).astype(np.int32)
    b = rng.randint(1, 1000, size=1000).astype(np.int32)
    got = np.asarray(_trunc_mod(jnp.asarray(a), jnp.asarray(b)))
    expect = np.fix(a / b).astype(np.int64) * b
    expect = a - expect.astype(np.int32)
    np.testing.assert_array_equal(got, expect)


def test_lcg_int32_wraparound():
    """The reference's LCG relies on int32 wraparound; jnp must match."""
    i = jnp.int32(2_000_000)
    lcg = jnp.int32(1664525) * i + jnp.int32(1013904223)
    expect = np.int32((1664525 * 2_000_000 + 1013904223) & 0xFFFFFFFF)
    assert int(lcg) == int(expect)


def test_cell_table_ascending_ids():
    cfg = SphConfig(num_particles=64, cell_capacity=16)
    key = jax.random.PRNGKey(1)
    pos = jax.random.uniform(key, (64, 3), jnp.float32) * 2.0 + 2.0
    table, counts, overflow = build_cell_table(cfg, pos)
    assert int(overflow) == 0
    t = np.asarray(table)
    c = np.asarray(counts)
    for cid in np.nonzero(c)[0]:
        ids = t[cid, :c[cid]]
        assert (np.diff(ids) > 0).all(), "bucket order must be ascending ids"
        assert (t[cid, c[cid]:] == 64).all()


def test_block_windows_from_cells():
    """Windows derive from the block's first/last cell: the centre rod covers
    the occupied cell's rows, rods whose cells are empty have length 0."""
    from smoothed_particle_hydrodynamics_tpu.ops.pallas_sweep import (
        block_windows)

    cfg = SphConfig(num_particles=8)
    # all particles in one interior cell
    cid = jnp.full((8,), (16 * cfg.grid_ny + 16) * cfg.grid_nx + 16, jnp.int32)
    ws, wl = block_windows(cfg, cid, block=8)
    ws, wl = np.asarray(ws), np.asarray(wl)
    assert ws.shape == wl.shape == (9,)
    assert (ws[4], wl[4]) == (0, 8)          # centre rod: the occupied cell
    # rods strictly before the cell start at row 0, rods after it at row 8;
    # both are empty
    assert (ws[0], wl[0]) == (0, 0)
    assert (ws[8], wl[8]) == (8, 0)
    assert (wl[[0, 1, 2, 3, 5, 6, 7, 8]] == 0).all()


def test_honey_scene_stable():
    """High-viscosity / low-stiffness regime must not blow up (config 4)."""
    from functools import partial

    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu.ops.step import run_steps

    cfg, state = make_scene("honey", num_particles=2048)
    final, diags = jax.jit(partial(run_steps, cfg, num_steps=30))(state)
    ke = np.asarray(diags.kinetic_energy)
    assert np.isfinite(ke).all()
    assert np.isfinite(np.asarray(final.position)).all()
    # viscous disk should not gain kinetic energy catastrophically
    assert ke[-1] < ke[0] * 10
