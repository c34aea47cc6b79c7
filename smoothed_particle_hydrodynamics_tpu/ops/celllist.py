"""Sorted cell-list backend: the production XLA compute path.

Replaces the reference's per-particle bucket walk
(/root/reference/src/sph.cpp:484-692, SSE inner loop at :651-663) with a
fully static-shape pipeline:

* particles sorted by linear cell id (see ``grid.py``) — x-adjacent cells are
  contiguous in sorted order, so each particle's neighborhood is a small set
  of **contiguous index ranges**: 9 ranges for the full 27-cell stencil, 4 for
  the octant stencil (the reference's 2x2x2 trick, README "Optimizations";
  valid because the interaction radius h is half the 2h cell size);
* per particle, a fixed-size slice of ``cfg.range_slice`` candidates is taken
  from each range (truncation is counted, not silently dropped);
* density and force sweeps run as ``lax.map`` over chunks of
  ``cfg.sweep_chunk`` particles, which bounds the candidate tensors
  ([chunk, R, S]) while XLA fuses the gather + mask + reduce.

Unlike the reference there is no 32-neighbor random subsample in default mode:
all in-range candidates contribute (physically correct); ``compat`` parity
paths live in ``..compat``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SphConfig
from ..state import ParticleState
from . import physics
from .grid import Grid, build_grid, unsort

_f32 = jnp.float32


class CellListAux(NamedTuple):
    """Diagnostics from a cell-list sweep."""

    neighbor_count: jnp.ndarray   # [N] int32 (original particle order)
    overflow_cells: jnp.ndarray   # scalar int32
    truncated_ranges: jnp.ndarray  # scalar int32: candidate ranges longer than range_slice


def _num_ranges(cfg: SphConfig) -> int:
    return 4 if cfg.neighborhood == "octant" else 9


def derive_range_slice(cfg: SphConfig, state: ParticleState,
                       headroom: float = 1.25) -> int:
    """Size ``range_slice`` from the state's ACTUAL rod-range lengths.

    Host-side, once per run: a candidate range is a run of <= 3 x-adjacent
    cells, so its length is bounded by the occupancy of 3-cell windows.
    The default 96 is sized for dense fluid scenes; dilute ones (the disk:
    mean occupancy ~4 on 2h cells) waste most of each gather slice — the
    measured win at 32k disk is 578 -> 268 ms/step for slice 96 -> 48 with
    zero truncation.  Truncation from later-run densification stays
    observable via StepDiagnostics.truncated_ranges + the CLI warning.
    """
    import numpy as np

    from .grid import cell_coords, linear_cell_id

    cid = np.asarray(linear_cell_id(cfg, cell_coords(cfg, state.position)))
    occ = np.bincount(cid, minlength=cfg.num_cells)
    runs = occ + np.roll(occ, -1) + np.roll(occ, 1)     # 3-cell x-windows
    need = int(runs.max())
    return max(-(-int(need * headroom) // 8) * 8, 16)


def _shift(a: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """a[c + d] over a flat [C] array; out-of-array reads become ``fill``."""
    if d == 0:
        return a
    if d > 0:
        return jnp.concatenate([a[d:], jnp.full((d,), fill, a.dtype)])
    return jnp.concatenate([jnp.full((-d,), fill, a.dtype), a[:d]])


def candidate_ranges(cfg: SphConfig, g: Grid, pos_sorted: jnp.ndarray
                     ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per sorted particle: [N, R] contiguous candidate ranges [start, end).

    Octant mode picks the x/y/z half-space by in-cell orientation exactly like
    the reference (/root/reference/src/sph.cpp:504-515): offset +1 if the
    in-cell coordinate exceeds h, else -1.

    Implementation: the ranges are assembled from a per-CELL table [C, 9, 4]
    built with shifted views of cell_start/cell_end (pure slices, no
    gathers), fetched with ONE row gather by cell id, then narrowed per
    particle with elementwise sign selects.
    """
    nx, ny, nz = cfg.grid_nx, cfg.grid_ny, cfg.grid_nz
    c_arange = jnp.arange(cfg.num_cells, dtype=jnp.int32)
    xc = c_arange % nx
    yc = (c_arange // nx) % ny
    zc = c_arange // (nx * ny)

    # Per-cell, per-rod ((dy,dz) in row-major (-1,0,1)^2 order) range pieces:
    #   s_lo = start of cell (x-1, y+dy, z+dz)   (x==0 -> start of x)
    #   s_0  = start of cell (x,   y+dy, z+dz)
    #   e_0  = end   of cell (x,   y+dy, z+dz)
    #   e_hi = end   of cell (x+1, y+dy, z+dz)   (x==nx-1 -> end of x)
    full = cfg.neighborhood != "cell27"   # cell27 needs only s_lo / e_hi
    pieces = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            delta = (dz * ny + dy) * nx
            ok = ((yc + dy >= 0) & (yc + dy < ny)
                  & (zc + dz >= 0) & (zc + dz < nz))
            s_0 = _shift(g.cell_start, delta, 0)
            e_0 = _shift(g.cell_end, delta, 0)
            s_lo = jnp.where(xc > 0, _shift(g.cell_start, delta - 1, 0), s_0)
            e_hi = jnp.where(xc < nx - 1, _shift(g.cell_end, delta + 1, 0), e_0)
            zero = jnp.zeros_like(s_0)
            pieces.append(jnp.where(ok, s_lo, zero))
            if full:
                pieces.append(jnp.where(ok, s_0, zero))
                pieces.append(jnp.where(ok, e_0, zero))
            pieces.append(jnp.where(ok, e_hi, zero))
    table = jnp.stack(pieces, axis=1)                      # [C, 36] or [C, 18]

    rows = table[g.cell_ids]                               # ONE row gather
    rows = rows.reshape(-1, 9, 4 if full else 2)

    if cfg.neighborhood == "cell27":
        start = rows[:, :, 0]                              # s_lo of all 9 rods
        end = rows[:, :, 1]                                # e_hi of all 9 rods
        return start.astype(jnp.int32), end.astype(jnp.int32)

    # octant: pick 4 rods by the y/z half-space signs, then narrow x by sx.
    orient = pos_sorted - g.coords.astype(jnp.float32) * _f32(cfg.cell_size)
    s = orient > _f32(cfg.h)                               # [N,3] bool: +1 if True
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]

    def rod(dy_idx, dz_idx):                               # indices in (-1,0,1)+1
        return rows[:, dy_idx * 3 + dz_idx, :]             # [N, 4]

    r00 = rod(1, 1)                                        # (0,0)
    r0z = jnp.where(sz[:, None], rod(1, 2), rod(1, 0))     # (0, sz)
    ry0 = jnp.where(sy[:, None], rod(2, 1), rod(0, 1))     # (sy, 0)
    ryz = jnp.where(sy[:, None],
                    jnp.where(sz[:, None], rod(2, 2), rod(2, 0)),
                    jnp.where(sz[:, None], rod(0, 2), rod(0, 0)))  # (sy, sz)

    quad = jnp.stack([r00, r0z, ry0, ryz], axis=1)         # [N, 4 rods, 4 pieces]
    start = jnp.where(sx[:, None], quad[:, :, 1], quad[:, :, 0])   # s_0 / s_lo
    end = jnp.where(sx[:, None], quad[:, :, 3], quad[:, :, 2])     # e_hi / e_0
    return start.astype(jnp.int32), end.astype(jnp.int32)


def _chunked(fn, row_args: tuple, n: int, chunk: int):
    """Pad rows to a multiple of ``chunk`` and lax.map ``fn`` over chunks
    (``chunk`` 0 = all rows in one chunk).

    ``row_args`` is a tuple of [N, ...] arrays; ``fn`` receives the chunked
    tuple ([chunk, ...]) and must return a pytree of [chunk, ...] arrays.
    """
    chunk = min(chunk or n, n)
    n_pad = -(-n // chunk) * chunk
    padded = tuple(
        jnp.pad(a, ((0, n_pad - n),) + ((0, 0),) * (a.ndim - 1)) for a in row_args
    )
    stacked = tuple(a.reshape((n_pad // chunk, chunk) + a.shape[1:]) for a in padded)
    out = jax.lax.map(fn, stacked)
    return jax.tree.map(
        lambda a: a.reshape((n_pad,) + a.shape[2:])[:n], out
    )


def _candidate_block(cfg: SphConfig, start: jnp.ndarray, end: jnp.ndarray,
                     own_idx: jnp.ndarray, n_total: int
                     ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Expand [chunk, R] ranges into candidate indices + masks.

    Returns (idx [chunk, R*S] clamped indices, mask [chunk, R*S],
             truncated [chunk] per-row truncated-range count).
    """
    s_len = cfg.range_slice
    offs = jnp.arange(s_len, dtype=jnp.int32)
    idx = start[:, :, None] + offs[None, None, :]            # [chunk, R, S]
    in_range = idx < end[:, :, None]
    not_self = idx != own_idx[:, None, None]
    mask = in_range & not_self
    truncated = jnp.sum((end - start) > s_len, axis=-1)
    idx = jnp.clip(idx, 0, n_total - 1)
    chunk = start.shape[0]
    return (idx.reshape(chunk, -1), mask.reshape(chunk, -1),
            truncated.astype(jnp.int32))


class Prepared(NamedTuple):
    """Sorted-order arrays + candidate ranges shared by both sweeps."""

    grid: Grid
    pos_s: jnp.ndarray       # [N,3]
    vel_s: jnp.ndarray       # [N,3]
    mass_s: jnp.ndarray      # [N]
    rng_start: jnp.ndarray   # [N,R]
    rng_end: jnp.ndarray     # [N,R]


def prepare(cfg: SphConfig, state: ParticleState) -> Prepared:
    """Binning + sort + candidate ranges — the 'voxelize/findNeighbors' analog.

    All fields are permuted with ONE row gather of a stacked [N, 7] matrix.
    """
    g = build_grid(cfg, state.position)
    stacked = jnp.concatenate(
        [state.position, state.velocity, state.mass[:, None]], axis=1)
    stacked_s = stacked[g.order]
    pos_s = stacked_s[:, 0:3]
    rng_start, rng_end = candidate_ranges(cfg, g, pos_s)
    return Prepared(
        grid=g,
        pos_s=pos_s,
        vel_s=stacked_s[:, 3:6],
        mass_s=stacked_s[:, 6],
        rng_start=rng_start,
        rng_end=rng_end,
    )


def density_rows(cfg: SphConfig, pos_s, mass_s, rng_start, rng_end, own_idx,
                 pos_i, m_i):
    """Density sweep over a row block.

    ``pos_s/mass_s`` are the FULL sorted arrays (gather sources);
    the remaining args are per-row and may be any contiguous block.
    Returns (rho, ncount, truncated) for the block rows.
    """
    n_total = pos_s.shape[0]
    n_rows = rng_start.shape[0]
    h2 = _f32(cfg.h2)
    sim_scale = _f32(cfg.sim_scale)

    def density_chunk(args):
        start, end, own, p_i, mm_i = args
        idx, mask, truncated = _candidate_block(cfg, start, end, own, n_total)
        pos_j = pos_s[idx]                                    # [chunk, K, 3]
        m_j = mass_s[idx]
        diff = p_i[:, None, :] - pos_j
        d2 = jnp.sum(diff * diff, axis=-1)
        mask = mask & (d2 < h2)                               # strict, like the SSE cmplt
        d = jnp.sqrt(d2) * sim_scale
        rho = physics.density_sum(cfg, m_j, d, mask, m_self=mm_i)
        ncount = jnp.sum(mask, axis=-1).astype(jnp.int32)
        return rho, ncount, truncated

    return _chunked(density_chunk, (rng_start, rng_end, own_idx, pos_i, m_i),
                    n_rows, cfg.sweep_chunk)


def force_rows(cfg: SphConfig, pos_s, vel_s, mass_s, rho_s,
               rng_start, rng_end, own_idx, pos_i, vel_i, rho_i):
    """Force sweep over a row block (needs the FULL rho_s of sweep 1)."""
    n_total = pos_s.shape[0]
    n_rows = rng_start.shape[0]
    h2 = _f32(cfg.h2)
    sim_scale = _f32(cfg.sim_scale)

    def force_chunk(args):
        start, end, own, p_i, v_i, r_i = args
        idx, mask, _ = _candidate_block(cfg, start, end, own, n_total)
        pos_j = pos_s[idx]
        vel_j = vel_s[idx]
        m_j = mass_s[idx]
        rho_j = rho_s[idx]
        diff = p_i[:, None, :] - pos_j
        d2 = jnp.sum(diff * diff, axis=-1)
        mask = mask & (d2 < h2)
        d = jnp.sqrt(d2) * sim_scale
        acc = physics.sph_acceleration(
            cfg, pos_i=p_i, vel_i=v_i, rho_i=r_i,
            pos_j=pos_j, vel_j=vel_j, rho_j=rho_j, m_j=m_j, d=d, mask=mask)
        return acc

    acc = _chunked(force_chunk,
                   (rng_start, rng_end, own_idx, pos_i, vel_i, rho_i),
                   n_rows, cfg.sweep_chunk)
    acc = acc + physics.central_gravity(cfg, pos_i)
    acc = acc + jnp.asarray(cfg.gravity, jnp.float32)
    return physics.cfl_clamp(cfg, acc)


def compute_step_quantities(
    cfg: SphConfig, state: ParticleState,
) -> tuple[jnp.ndarray, jnp.ndarray, CellListAux]:
    """Full per-step field evaluation: density + acceleration + diagnostics.

    Mirrors the reference's step phases voxelize -> findNeighbors ->
    density -> acceleration (/root/reference/src/sph.cpp:190-278) as two
    chunked sweeps over the sorted particle set.  Returns
    ``(acceleration [N,3], density [N], aux)`` in original particle order.
    """
    n = state.position.shape[0]
    p = prepare(cfg, state)
    own_idx = jnp.arange(n, dtype=jnp.int32)

    rho_s, ncount_s, truncated = density_rows(
        cfg, p.pos_s, p.mass_s, p.rng_start, p.rng_end, own_idx,
        p.pos_s, p.mass_s)

    acc_s = force_rows(
        cfg, p.pos_s, p.vel_s, p.mass_s, rho_s,
        p.rng_start, p.rng_end, own_idx, p.pos_s, p.vel_s, rho_s)

    g = p.grid
    aux = CellListAux(
        neighbor_count=unsort(g.order, ncount_s),
        overflow_cells=g.overflow_cells,
        truncated_ranges=jnp.sum(truncated).astype(jnp.int32),
    )
    return unsort(g.order, acc_s), unsort(g.order, rho_s), aux
