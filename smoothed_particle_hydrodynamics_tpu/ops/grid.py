"""Uniform-grid binning by sort.

The reference bins particles into 32^3 ``QList`` buckets by sequential
push_back (/root/reference/src/sph.cpp:429-481).  Dynamic lists don't exist
under XLA; the static-shape equivalent is *sort-based binning*:

1. compute each particle's linear cell id ``(z*ny + y)*nx + x``
   (src/sph.cpp:1151-1154), positions clamped into the grid exactly like the
   reference's voxel clamp (src/sph.cpp:456-463);
2. stable-argsort particle indices by cell id — within a cell, particles stay
   in ascending index order, which is *identical* to the reference's bucket
   order (its sequential push loop visits indices in ascending order);
3. per-cell [start, end) offsets via two ``searchsorted`` calls over the
   static cell-id range.

Everything is static-shaped; occupancy overflow versus ``cfg.cell_capacity``
is counted and surfaced in diagnostics instead of crashing.

A crucial layout property falls out of the linear id: cells adjacent in x are
adjacent in sorted order, so the 3 (or 2) x-neighbor cells of any cell form
ONE contiguous index range.  The 27-cell neighborhood therefore collapses to
9 contiguous ranges (the 8-cell octant to 4), which the candidate gather in
``celllist.py`` exploits to stay gather-light.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SphConfig

_f32 = jnp.float32


class Grid(NamedTuple):
    """Sorted-order grid view of a particle set."""

    order: jnp.ndarray        # [N] int32: sorted-position -> original particle index
    cell_ids: jnp.ndarray     # [N] int32: cell id per *sorted* particle
    cell_start: jnp.ndarray   # [C] int32: first sorted index of each cell
    cell_end: jnp.ndarray     # [C] int32: one-past-last sorted index of each cell
    coords: jnp.ndarray       # [N, 3] int32: (x,y,z) cell coords per sorted particle
    overflow_cells: jnp.ndarray  # scalar int32: cells with occupancy > cfg.cell_capacity


def cell_coords(cfg: SphConfig, pos: jnp.ndarray) -> jnp.ndarray:
    """floor(pos / 2h) clamped into the grid (src/sph.cpp:452-463). [N,3] int32."""
    v = jnp.floor(pos * _f32(cfg.inv_cell_size)).astype(jnp.int32)
    hi = jnp.asarray([cfg.grid_nx - 1, cfg.grid_ny - 1, cfg.grid_nz - 1], jnp.int32)
    return jnp.clip(v, 0, hi)


def linear_cell_id(cfg: SphConfig, coords: jnp.ndarray) -> jnp.ndarray:
    """(z*ny + y)*nx + x (src/sph.cpp:1151-1154)."""
    return (coords[..., 2] * cfg.grid_ny + coords[..., 1]) * cfg.grid_nx + coords[..., 0]


def build_grid(cfg: SphConfig, pos: jnp.ndarray) -> Grid:
    coords = cell_coords(cfg, pos)
    cid = linear_cell_id(cfg, coords)
    order = jnp.argsort(cid, stable=True).astype(jnp.int32)
    cid_sorted = cid[order]
    # Per-cell offsets via histogram + prefix sum.
    counts = jnp.bincount(cid, length=cfg.num_cells).astype(jnp.int32)
    cell_end = jnp.cumsum(counts, dtype=jnp.int32)
    cell_start = cell_end - counts
    overflow = jnp.sum(counts > cfg.cell_capacity).astype(jnp.int32)
    return Grid(
        order=order,
        cell_ids=cid_sorted,
        cell_start=cell_start,
        cell_end=cell_end,
        coords=coords[order],
        overflow_cells=overflow,
    )


def unsort(order: jnp.ndarray, sorted_values: jnp.ndarray) -> jnp.ndarray:
    """Scatter sorted-order values back to original particle order.

    Hot paths that un-permute several arrays build the inverse permutation
    once via ``inverse_order`` and gather with ``unsort_stacked`` instead."""
    out_shape = (sorted_values.shape[0],) + sorted_values.shape[1:]
    return jnp.zeros(out_shape, sorted_values.dtype).at[order].set(sorted_values)


def inverse_order(order: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a permutation via one pair sort (no scatter)."""
    n = order.shape[0]
    return jax.lax.sort(
        (order, jnp.arange(n, dtype=jnp.int32)), num_keys=1)[1]


def unsort_stacked(inv_order: jnp.ndarray, columns: list[jnp.ndarray]
                   ) -> list[jnp.ndarray]:
    """Un-permute several [N] / [N,k] arrays with ONE stacked row gather.

    f32/i32 columns are gathered together as f32 (exact for int32 magnitudes
    below 2^24, which holds for neighbor counts)."""
    parts = []
    for c in columns:
        c2 = c[:, None] if c.ndim == 1 else c
        parts.append(c2.astype(jnp.float32))
    stacked = jnp.concatenate(parts, axis=1)[inv_order]
    out = []
    ofs = 0
    for c in columns:
        k = 1 if c.ndim == 1 else c.shape[1]
        sl = stacked[:, ofs:ofs + k]
        sl = sl[:, 0] if c.ndim == 1 else sl
        out.append(sl.astype(c.dtype))
        ofs += k
    return out
