"""Pallas neighbour sweeps for the GPU, lowered through Triton.

The XLA cell-list backend (``celllist.py``) expands every particle into
``9 x range_slice`` padded candidate slots and gathers ``[chunk, K, 3]``
tensors.  Here the sorted frame is used directly: for a block of ``block``
consecutive *sorted* particles, each (dy, dz) stencil rod covers ONE
contiguous row interval of the sorted arrays (x-adjacent cells are adjacent
in sorted order, see ``grid.py``).  One program walks its block's 9 rod
windows in coalesced ``tile``-row loads, with an exact trip count per rod,
and keeps the pair sums in registers: no candidate tensor ever reaches
device memory.

Pair validity is decided in-kernel from integer cell ids: candidate j lies
in rod delta of particle i's cell iff ``|cid_j - cid_i - delta| <= 1``.
Rows outside a rod's window always fail that test (their cells lie beyond
the window's first/last cell), so window tails need no extra mask; and
linear-id wraparound pairs are more than ``h`` apart on grids of at least
3 cells per axis, so the ``d^2 < h^2`` test rejects them.

Candidate fields are float32 columns (structure of arrays), padded with
``tile`` inert rows so that every load stays in bounds.

Reference counterpart: the density and force loops at the reference's
src/sph.cpp:721-766,778-934 (default-mode physics only;
compat quirks are order-dependent and stay on the XLA/compat path).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ..config import SphConfig
from ..state import ParticleState
from . import celllist, physics
from .grid import cell_coords, inverse_order, linear_cell_id, unsort_stacked

_f32 = jnp.float32

# Measured on an H100 over B in {8..64}, tile in {16, 32, 64}, 1-8 warps
# (PERF.md, "Kernel decisions"): the fastest at both splash 1M and disk 32k.
BLOCK = 16          # sorted particles per program
TILE = 16           # candidate rows per loop iteration
NUM_WARPS = 4
NUM_STAGES = 2
_INERT_CID = -(1 << 30)   # cell id of padding rows: fails every rod test

# The 9 stencil rods in (dy, dz) row-major order.
_RODS = [(dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def _rod_deltas(cfg: SphConfig) -> list[int]:
    """Linear cell-id offset of each rod's centre cell."""
    return [(dz * cfg.grid_ny + dy) * cfg.grid_nx for dy, dz in _RODS]


def validate(cfg: SphConfig) -> None:
    if cfg.compat:
        raise ValueError("the pallas backend supports default mode only")
    if min(cfg.grid_nx, cfg.grid_ny, cfg.grid_nz) < 3:
        # the in-kernel rod test assumes rod deltas (multiples of grid_nx)
        # are >= 3 apart and that linear-id-wrapped cells are > h away
        raise ValueError(
            "the pallas backend needs grid dims >= 3 in every axis "
            f"(got {cfg.grid_nx}x{cfg.grid_ny}x{cfg.grid_nz}); "
            "use the celllist backend for degenerate grids")


class Frame(NamedTuple):
    """Sorted particle frame + per-(block, rod) candidate windows."""

    order: jnp.ndarray   # [N] i32: sorted row -> input row
    pos_s: jnp.ndarray   # [N, 3] sorted
    vel_s: jnp.ndarray   # [N, 3] sorted
    mass_s: jnp.ndarray  # [N] sorted
    cid: jnp.ndarray     # [N] i32 sorted cell ids
    ws: jnp.ndarray      # [nblocks * 9] i32 window start rows
    wl: jnp.ndarray      # [nblocks * 9] i32 window lengths (rows)


def block_windows(cfg: SphConfig, cid_sorted: jnp.ndarray, block: int
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per (block, rod) row window [start, start + len) of the sorted frame.

    The window of rod delta for a block whose cells span [c_first, c_last]
    is every row in cells [c_first + delta - 1, c_last + delta + 1]: one
    bincount + cumsum over the grid and a [nblocks, 9] gather of bounds.
    """
    n = cid_sorted.shape[0]
    nblocks = -(-n // block)
    cid_p = jnp.pad(cid_sorted, (0, nblocks * block - n), mode="edge")
    blocks = cid_p.reshape(nblocks, block)
    deltas = jnp.asarray(_rod_deltas(cfg), jnp.int32)
    c = cfg.num_cells
    lo = jnp.clip(blocks[:, :1] + deltas[None, :] - 1, 0, c - 1)
    hi = jnp.clip(blocks[:, -1:] + deltas[None, :] + 1, 0, c - 1)
    counts = jnp.bincount(cid_sorted, length=c)
    cum = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                           jnp.cumsum(counts).astype(jnp.int32)])
    start = cum[lo]
    return start.reshape(-1), (cum[hi + 1] - start).reshape(-1)


def prepare(cfg: SphConfig, state: ParticleState, block: int = BLOCK) -> Frame:
    """Binning + one pair sort + the window tables."""
    validate(cfg)
    n = state.position.shape[0]
    cid = linear_cell_id(cfg, cell_coords(cfg, state.position))
    cid_sorted, order = jax.lax.sort(
        (cid, jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    stacked = jnp.concatenate(
        [state.position, state.velocity, state.mass[:, None]], axis=1)[order]
    ws, wl = block_windows(cfg, cid_sorted, block)
    return Frame(order=order, pos_s=stacked[:, 0:3], vel_s=stacked[:, 3:6],
                 mass_s=stacked[:, 6], cid=cid_sorted, ws=ws, wl=wl)


# ---------------------------------------------------------------------------
# Kernels: one program = one block of sorted particles
# ---------------------------------------------------------------------------

def _sweep(cfg: SphConfig, block: int, ws_ref, wl_ref, cid_ref, self_cols,
           cand_refs, init, pair):
    """Walk the 9 rod windows of this program's block.

    ``self_cols`` are the block's own [block] columns, ``cand_refs`` the
    candidate column refs; ``pair(carry, cand, mask, dx, dy, dz, d2)``
    folds one [block, TILE] tile into the carry.
    """
    b = pl.program_id(0)
    row0 = b * block
    own = row0 + jnp.arange(block, dtype=jnp.int32)
    xi, yi, zi, ci = self_cols
    h2 = _f32(cfg.h2)
    carry = init
    for r, delta in enumerate(_rod_deltas(cfg)):
        start = ws_ref[b * 9 + r]
        trips = (wl_ref[b * 9 + r] + TILE - 1) // TILE

        def body(k, carry, start=start, delta=delta):
            j0 = start + k * TILE
            sl = pl.ds(j0, TILE)
            jj = j0 + jnp.arange(TILE, dtype=jnp.int32)
            cj = cid_ref[sl]
            cand = [ref[sl] for ref in cand_refs]
            dx = cand[0][None, :] - xi[:, None]
            dy = cand[1][None, :] - yi[:, None]
            dz = cand[2][None, :] - zi[:, None]
            d2 = dx * dx + dy * dy + dz * dz
            mask = ((jnp.abs(cj[None, :] - ci[:, None] - delta) <= 1)
                    & (jj[None, :] != own[:, None]) & (d2 < h2))
            return pair(carry, cand, mask, dx, dy, dz, d2)

        carry = jax.lax.fori_loop(0, trips, body, carry)
    return carry


def _density_kernel(cfg: SphConfig, block: int, ws_ref, wl_ref, cid_ref,
                    x_ref, y_ref, z_ref, m_ref, rho_ref, nc_ref):
    sl = pl.ds(pl.program_id(0) * block, block)
    mi = m_ref[sl]
    h2s = _f32(cfg.h_scaled2)
    scale2 = _f32(cfg.sim_scale * cfg.sim_scale)
    norm = _f32(cfg.poly6_norm)

    def pair(carry, cand, mask, dx, dy, dz, d2):
        rho, nc = carry
        t = h2s - d2 * scale2
        w = cand[3][None, :] * (norm * t * t * t)
        rho = rho + jnp.sum(jnp.where(mask, w, 0.0), axis=1)
        nc = nc + jnp.sum(mask.astype(jnp.int32), axis=1)
        return rho, nc

    init = (jnp.zeros((block,), _f32), jnp.zeros((block,), jnp.int32))
    rho, nc = _sweep(cfg, block, ws_ref, wl_ref, cid_ref,
                     (x_ref[sl], y_ref[sl], z_ref[sl], cid_ref[sl]),
                     (x_ref, y_ref, z_ref, m_ref), init, pair)
    if cfg.include_self_density:
        rho = rho + mi * (norm * h2s * h2s * h2s)
    rho_ref[sl] = rho
    nc_ref[sl] = nc


def _force_kernel(cfg: SphConfig, block: int, ws_ref, wl_ref, cid_ref,
                  x_ref, y_ref, z_ref, vx_ref, vy_ref, vz_ref, m_ref,
                  mpw_ref, rim_ref, rho_ref, ax_ref, ay_ref, az_ref):
    """Pressure (symmetric p/rho^2) + viscosity, exactly
    ``physics.sph_acceleration`` in default mode.  Candidate columns carry
    ``mpw = m p / rho^2`` and ``rim = m / rho`` precomputed per particle."""
    sl = pl.ds(pl.program_id(0) * block, block)
    vxi, vyi, vzi = vx_ref[sl], vy_ref[sl], vz_ref[sl]
    rhoi = rho_ref[sl]
    rhoi_inv = 1.0 / jnp.where(rhoi > 0.0, rhoi, 1.0)
    pwi = (rhoi - _f32(cfg.rho0)) * _f32(cfg.stiffness) * rhoi_inv * rhoi_inv
    h = _f32(cfg.h_scaled)
    scale = _f32(cfg.sim_scale)
    eps = _f32(cfg.pressure_softening)

    def pair(carry, cand, mask, dx, dy, dz, d2):
        px, py, pz, qx, qy, qz = carry
        _, _, _, vxj, vyj, vzj, mj, mpwj, rimj = cand
        d = jnp.sqrt(d2) * scale
        hd = h - d
        # dx = x_j - x_i, so the pressure direction (x_i - x_j) is -dx
        c = -(hd * hd * (mj[None, :] * pwi[:, None] + mpwj[None, :])
              * scale / (d + eps))
        w = hd * rimj[None, :]

        def red(v):
            return jnp.sum(jnp.where(mask, v, 0.0), axis=1)

        return (px + red(dx * c), py + red(dy * c), pz + red(dz * c),
                qx + red((vxj[None, :] - vxi[:, None]) * w),
                qy + red((vyj[None, :] - vyi[:, None]) * w),
                qz + red((vzj[None, :] - vzi[:, None]) * w))

    zero = jnp.zeros((block,), _f32)
    px, py, pz, qx, qy, qz = _sweep(
        cfg, block, ws_ref, wl_ref, cid_ref,
        (x_ref[sl], y_ref[sl], z_ref[sl], cid_ref[sl]),
        (x_ref, y_ref, z_ref, vx_ref, vy_ref, vz_ref, m_ref, mpw_ref,
         rim_ref), (zero,) * 6, pair)
    norm = _f32(cfg.visc_lap_norm)
    visc = _f32(cfg.viscosity) * rhoi_inv * norm
    ax_ref[sl] = norm * px + visc * qx
    ay_ref[sl] = norm * py + visc * qy
    az_ref[sl] = norm * pz + visc * qz


# ---------------------------------------------------------------------------
# pallas_call wrappers
# ---------------------------------------------------------------------------

def _columns(cols, rows: int, fills) -> list[jnp.ndarray]:
    """Pad each [N] column to ``rows`` with its inert fill value."""
    return [jnp.pad(c, (0, rows - c.shape[0]), constant_values=f)
            for c, f in zip(cols, fills)]


def _call(cfg: SphConfig, kernel, block: int, nblocks: int, out_dtypes,
          *args):
    rows = nblocks * block + TILE
    return pl.pallas_call(
        partial(kernel, cfg, block),
        out_shape=[jax.ShapeDtypeStruct((rows,), dt) for dt in out_dtypes],
        grid=(nblocks,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=NUM_STAGES),
        interpret=cfg.pallas_interpret,
        name=kernel.__name__.strip("_"),
    )(*args)


def density_sweep(cfg: SphConfig, f: Frame, block: int = BLOCK
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(rho_s, ncount_s) in sorted order."""
    n = f.pos_s.shape[0]
    nblocks = f.ws.shape[0] // 9
    rows = nblocks * block + TILE
    cid, x, y, z, m = _columns(
        [f.cid, f.pos_s[:, 0], f.pos_s[:, 1], f.pos_s[:, 2], f.mass_s], rows,
        [_INERT_CID, 1e30, 1e30, 1e30, 0.0])
    rho, nc = _call(cfg, _density_kernel, block, nblocks,
                    (_f32, jnp.int32), f.ws, f.wl, cid, x, y, z, m)
    return rho[:n], nc[:n]


def force_sweep(cfg: SphConfig, f: Frame, rho_s: jnp.ndarray,
                block: int = BLOCK) -> jnp.ndarray:
    """acc_s [N, 3] in sorted order (hydro only; gravity/CFL by the caller)."""
    n = f.pos_s.shape[0]
    nblocks = f.ws.shape[0] // 9
    rows = nblocks * block + TILE
    rho_inv = 1.0 / jnp.where(rho_s > 0.0, rho_s, 1.0)
    mpw = f.mass_s * physics.pressure_from_density(cfg, rho_s) \
        * rho_inv * rho_inv
    rim = f.mass_s * rho_inv
    cols = _columns(
        [f.cid, f.pos_s[:, 0], f.pos_s[:, 1], f.pos_s[:, 2], f.vel_s[:, 0],
         f.vel_s[:, 1], f.vel_s[:, 2], f.mass_s, mpw, rim, rho_s], rows,
        [_INERT_CID, 1e30, 1e30, 1e30] + [0.0] * 7)
    ax, ay, az = _call(cfg, _force_kernel, block, nblocks, (_f32,) * 3,
                       f.ws, f.wl, *cols)
    return jnp.stack([ax[:n], ay[:n], az[:n]], axis=1)


def sweeps_sorted(cfg: SphConfig, f: Frame, block: int = BLOCK
                  ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Both sweeps + gravity + CFL clamp, all in the SORTED frame.

    The sorted-frame contract lets the lazy driver (``ops.lazy``) keep the
    state permanently sorted and skip the inverse permutation.
    """
    rho_s, ncount_s = density_sweep(cfg, f, block)
    acc_s = force_sweep(cfg, f, rho_s, block)
    acc_s = acc_s + physics.central_gravity(cfg, f.pos_s)
    acc_s = acc_s + jnp.asarray(cfg.gravity, _f32)
    return physics.cfl_clamp(cfg, acc_s), rho_s, ncount_s


def compute_step_quantities(cfg: SphConfig, state: ParticleState,
                            block: int = BLOCK
                            ) -> tuple[jnp.ndarray, jnp.ndarray,
                                       celllist.CellListAux]:
    """(acceleration, density, aux) in input order, like
    ``celllist.compute_step_quantities``.  Windows are exact, so nothing
    can overflow or be truncated."""
    f = prepare(cfg, state, block)
    acc_s, rho_s, ncount_s = sweeps_sorted(cfg, f, block)
    acc, rho, ncount = unsort_stacked(inverse_order(f.order),
                                      [acc_s, rho_s, ncount_s])
    zero = jnp.zeros((), jnp.int32)
    return acc, rho, celllist.CellListAux(
        neighbor_count=ncount, overflow_cells=zero, truncated_ranges=zero)
