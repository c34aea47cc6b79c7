"""Fully distributed SPH step: fixed z-slab ownership, local sort, halo +
migration between neighbour devices — per-device memory is O(N/D + capacities).

This is the weak-scaling replacement for ``sharding.step_sharded_halo``,
whose binning/sort still ran replicated on every device.  Here NOTHING is
global: each device owns the particles inside a fixed band of z cell-planes,
bins and sorts only those, exchanges one cell-plane of halo rows with each
mesh neighbor per step (``lax.ppermute``), and hands off particles that
drift across a slab boundary through fixed-capacity migration buffers.

The reference has no distributed layer at all (SURVEY.md §2 "parallelism
inventory": hand SSE + commented-out OpenMP, /root/reference/src/sph.cpp:27,
651-663,215); this module is the framework's from-scratch design for it.

Static-shape contract (everything jit/SPMD-safe):

* ``fields``: ``[D * p_cap, 8]`` f32 — rows are (pos xyz, vel xyz, mass,
  orig_id); a device's slice is its slab population padded to ``p_cap``.
  Invalid rows carry ``orig_id == -1``, far-away positions and zero mass so
  they fall out of every pair mask and tally.
* halo: each device sends its ``h_cap`` tail/head sorted rows (a superset of
  its edge cell-plane) to each neighbor; senders re-pad rows outside the
  edge plane so receivers see a sorted, maskable segment.
* migration: at rebins, leavers are compacted by a pair sort and routed one
  device per hop toward their destination slab (a uniform while_loop repeats
  hops until every mover lands — multi-slab coasting between rebins is legal
  under the spread trigger); ``m_cap`` rows per direction per hop.  Capacity
  misses are COUNTED (``migration_dropped``), never silent.

Capacity sizing belongs to the caller (``derive_slab_caps``): p_cap from the
max slab population + drift headroom, h_cap from the densest plane pair,
m_cap from the flux through a plane.  Undersizing shows up in diagnostics,
not in wrong physics for the particles that remain.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import SphConfig
from ..state import ParticleState, StepDiagnostics
from ..ops import celllist
from ..ops.integrate import kdk_integrate

_f32 = jnp.float32
_BIG = jnp.float32(1e30)
_AXIS = "data"

# fields column layout
_POS = slice(0, 3)
_VEL = slice(3, 6)
_MASS = 6
_OID = 7
_NCOLS = 8


class SlabCarry(NamedTuple):
    """Distributed particle store (leading axis sharded over the mesh)."""

    fields: jnp.ndarray       # [D*p_cap, 8] f32
    count: jnp.ndarray        # [D] i32 valid rows per device


def _nzs(cfg: SphConfig, ndev: int) -> int:
    if cfg.grid_nz % ndev:
        raise ValueError(f"grid_nz={cfg.grid_nz} must divide by {ndev} devices")
    nzs = cfg.grid_nz // ndev
    if nzs < 2:
        raise ValueError("need >= 2 z cell-planes per device")
    return nzs


def _zplane(cfg: SphConfig, z: jnp.ndarray) -> jnp.ndarray:
    """z coordinate -> clamped z cell-plane index."""
    zp = jnp.floor(z * _f32(cfg.inv_cell_size)).astype(jnp.int32)
    return jnp.clip(zp, 0, cfg.grid_nz - 1)


def uniform_zsplit(cfg: SphConfig, ndev: int) -> tuple[int, ...]:
    """Equal-VOLUME partition: ndev equal runs of z cell-planes."""
    nzs = _nzs(cfg, ndev)
    return tuple(range(0, cfg.grid_nz + 1, nzs))


def derive_zsplit(cfg: SphConfig, state: ParticleState,
                  ndev: int) -> tuple[int, ...]:
    """Occupancy-WEIGHTED partition: contiguous plane runs of near-equal
    particle count (each >= 2 planes).  Fixed equal-volume slabs carry a
    large load imbalance on mass-concentrated scenes (the splash);
    balancing by the initial histogram makes p_cap —
    and per-device sweep work — O(N/D) with a small constant.  Drift away
    from the initial distribution shows up as slab-capacity overflow in
    ``migration_dropped`` long before physics goes wrong."""
    import numpy as np

    _nzs(cfg, ndev)
    nz = cfg.grid_nz
    zp = np.asarray(_zplane(cfg, state.position[:, 2]))
    plane = np.bincount(zp, minlength=nz).astype(np.int64)
    cum = np.cumsum(plane)
    total = int(cum[-1])
    splits = [0]
    for k in range(1, ndev):
        z = int(np.searchsorted(cum, total * k / ndev)) + 1
        z = max(splits[-1] + 2, min(z, nz - 2 * (ndev - k)))
        splits.append(z)
    splits.append(nz)
    return tuple(splits)


def derive_slab_caps(cfg: SphConfig, state: ParticleState, ndev: int,
                     headroom: float = 1.5,
                     zsplit: tuple[int, ...] | None = None
                     ) -> tuple[int, int, int]:
    """(p_cap, h_cap, m_cap) from the initial state's plane occupancy."""
    import numpy as np

    _nzs(cfg, ndev)
    if zsplit is None:
        zsplit = uniform_zsplit(cfg, ndev)
    zp = np.asarray(_zplane(cfg, state.position[:, 2]))
    plane = np.bincount(zp, minlength=cfg.grid_nz).astype(np.int64)
    slab = np.asarray([plane[zsplit[d]:zsplit[d + 1]].sum()
                       for d in range(ndev)])
    p_cap = int(max(slab.max(), 1) * headroom) + 64
    h_cap = int(max(plane.max(), 1) * headroom) + 64
    # one full plane of migration capacity per direction per hop: under the
    # spread trigger a coasting cloud can cross whole planes between rebins
    m_cap = max(h_cap, 64)
    return p_cap, h_cap, m_cap


def distribute(cfg: SphConfig, state: ParticleState, mesh: Mesh,
               p_cap: int, zsplit: tuple[int, ...] | None = None) -> SlabCarry:
    """Partition a host state into the sharded slab store."""
    import numpy as np

    ndev = math.prod(mesh.devices.shape)
    _nzs(cfg, ndev)
    if zsplit is None:
        zsplit = uniform_zsplit(cfg, ndev)
    n = state.position.shape[0]
    zp = np.asarray(_zplane(cfg, state.position[:, 2]))
    dest = np.clip(np.searchsorted(zsplit, zp, side="right") - 1, 0, ndev - 1)

    fields = np.zeros((ndev * p_cap, _NCOLS), np.float32)
    fields[:, 0:3] = _BIG
    fields[:, _OID] = -1.0
    count = np.zeros((ndev,), np.int32)
    pos = np.asarray(state.position)
    vel = np.asarray(state.velocity)
    mass = np.asarray(state.mass)
    for d in range(ndev):
        rows = np.nonzero(dest == d)[0]
        if len(rows) > p_cap:
            raise ValueError(f"slab {d} population {len(rows)} > p_cap {p_cap}")
        base = d * p_cap
        k = len(rows)
        fields[base:base + k, 0:3] = pos[rows]
        fields[base:base + k, 3:6] = vel[rows]
        fields[base:base + k, _MASS] = mass[rows]
        fields[base:base + k, _OID] = rows.astype(np.float32)
        count[d] = k
    sh = NamedSharding(mesh, P(_AXIS))
    return SlabCarry(fields=jax.device_put(jnp.asarray(fields), sh),
                     count=jax.device_put(jnp.asarray(count), sh))


def collect(carry: SlabCarry, n: int) -> ParticleState:
    """Gather the slab store back into a host ParticleState (original order)."""
    import numpy as np

    fields = np.asarray(carry.fields)
    oid = fields[:, _OID].astype(np.int64)
    valid = oid >= 0
    out_pos = np.zeros((n, 3), np.float32)
    out_vel = np.zeros((n, 3), np.float32)
    out_mass = np.zeros((n,), np.float32)
    out_pos[oid[valid]] = fields[valid][:, 0:3]
    out_vel[oid[valid]] = fields[valid][:, 3:6]
    out_mass[oid[valid]] = fields[valid][:, _MASS]
    return ParticleState.from_arrays(out_pos, out_vel, mass=out_mass)


def _sort_local(cfg: SphConfig, fields: jnp.ndarray, slab_hi: jnp.ndarray
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sort a device's rows by global linear cell id (invalid rows last).

    Invalid rows get cid = slab_hi - 1 (the slab's LAST own cell): the stable
    sort keeps them after every valid row (valid rows precede them in storage
    by construction), and — unlike a num_cells sentinel — the extended array
    [left halo | local | right halo] stays globally ascending, which
    ``_local_ranges``'s searchsorted requires.  Inert fields (mass 0,
    position 1e30) keep them out of every pair mask.
    """
    valid = fields[:, _OID] >= 0.0
    coords = jnp.floor(fields[:, 0:3] * _f32(cfg.inv_cell_size)).astype(jnp.int32)
    hi = jnp.asarray([cfg.grid_nx - 1, cfg.grid_ny - 1, cfg.grid_nz - 1], jnp.int32)
    coords = jnp.clip(coords, 0, hi)
    cid = (coords[:, 2] * cfg.grid_ny + coords[:, 1]) * cfg.grid_nx + coords[:, 0]
    cid = jnp.where(valid, cid, slab_hi - 1)
    cid_sorted, perm = jax.lax.sort(
        (cid, jnp.arange(fields.shape[0], dtype=jnp.int32)), num_keys=1)
    return fields[perm], cid_sorted


def _edge_window(fields_s, cid_s, cnt, h_cap: int, tail: bool):
    """A device's h_cap sorted rows nearest one slab edge, sent RAW.

    The tail window [cnt - h_cap, cnt) may reach below the edge plane; those
    rows keep their true (lower) cell ids — the receiver's stencil only ever
    queries the adjacent plane's cells, so extra rows are never candidates,
    and true cids preserve the global sortedness ``_local_ranges`` needs.
    (Re-padding them into the plane range instead was measured to pile fake
    rows into the plane's first cell and truncate real candidates.)  Invalid
    rows cannot enter the tail window (they sort after row cnt) and in the
    head window carry cid slab_hi - 1 > every queried cell of the left
    neighbor — also never candidates.
    """
    if tail:
        start = jnp.maximum(cnt - h_cap, 0)
    else:
        start = jnp.zeros((), jnp.int32)
    rows = jax.lax.dynamic_slice_in_dim(fields_s, start, h_cap)
    cids = jax.lax.dynamic_slice_in_dim(cid_s, start, h_cap)
    return rows, cids


def _local_ranges(cfg: SphConfig, cid_ext: jnp.ndarray, cid_rows: jnp.ndarray,
                  row_valid: jnp.ndarray, n_ext: int
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """[rows, 9] contiguous candidate ranges into the extended sorted array.

    ``cid_ext`` is the sorted cell id of every extended row (halo|local|halo,
    globally ascending); ranges are found by searchsorted on the 27-stencil
    rod bounds — O(rows * log n_ext), all local.
    """
    nx, ny, nz = cfg.grid_nx, cfg.grid_ny, cfg.grid_nz
    x = cid_rows % nx
    y = (cid_rows // nx) % ny
    z = cid_rows // (nx * ny)
    starts, ends = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            ok = row_valid & (y + dy >= 0) & (y + dy < ny) \
                & (z + dz >= 0) & (z + dz < nz)
            base = cid_rows + (dz * ny + dy) * nx
            lo = base - jnp.where(x > 0, 1, 0)
            hi = base + jnp.where(x < nx - 1, 1, 0)
            s = jnp.searchsorted(cid_ext, lo, side="left").astype(jnp.int32)
            e = jnp.searchsorted(cid_ext, hi + 1, side="left").astype(jnp.int32)
            starts.append(jnp.where(ok, s, 0))
            ends.append(jnp.where(ok, e, 0))
    return jnp.stack(starts, axis=1), jnp.stack(ends, axis=1)


def _perm(ndev: int, shift: int):
    return [(d, (d + shift) % ndev) for d in range(ndev)]


class LazySlabCarry(NamedTuple):
    """Slab store + frozen binning structure (lazy rebinning).

    Between rebins the row ORDER of ``fields`` is frozen (sorted by bin-time
    cell id); only the values evolve.  ``pos_bin``/``cid``/``tabs`` are the
    frozen structure, rebuilt when the global per-axis displacement SPREAD
    exceeds cell - h — the same relative-drift invariant as the single-chip
    lazy driver (``ops.lazy`` module docstring; common-mode translation
    never expires bins).  Migration runs only at rebins and routes movers
    hop-by-hop until they land (multi-slab coasting between rebins is legal
    under the spread trigger).

    ``tabs`` holds the frozen per-row candidate ranges (rng_s, rng_e).
    """

    fields: jnp.ndarray       # [D*p_cap, 8] f32, bin-time sorted order
    count: jnp.ndarray        # [D] i32 valid rows per device
    pos_bin: jnp.ndarray      # [D*p_cap, 3] positions at bin time
    cid: jnp.ndarray          # [D*p_cap] i32 frozen sorted cell ids
    tabs: tuple               # frozen engine tables (see docstring)
    steps_since: jnp.ndarray  # [D] i32, -1 = initial build pending
    rebin_count: jnp.ndarray  # [D] i32 total rebins so far


def slab_step_body(cfg: SphConfig, ndev: int, p_cap: int, h_cap: int,
                   m_cap: int, zsplit: tuple[int, ...], lazy: bool,
                   fields: jnp.ndarray, count: jnp.ndarray,
                   pos_bin: jnp.ndarray, cid_frozen: jnp.ndarray,
                   tabs: tuple,
                   steps_since: jnp.ndarray, rebin_count: jnp.ndarray):
    """shard_map body: one full physics step on one device's slab.

    The rebin predicate is a ``pmax``, so every device takes the SAME
    ``lax.cond`` branch — which makes it legal to put the migration
    collectives INSIDE the rebuild branch (uniform-branch collectives
    cannot diverge/deadlock).  Between rebins the step therefore runs zero
    migration traffic; only the halo/rho value exchanges and the diagnostic
    reductions execute every step.
    """
    from ..ops.lazy import skin_half

    nxny = cfg.grid_nx * cfg.grid_ny
    d = jax.lax.axis_index(_AXIS)
    cnt = count[0]
    zs = jnp.asarray(zsplit, jnp.int32)       # [D+1] plane split table
    slab_lo = zs[d] * nxny                    # first own cell id
    slab_hi = zs[d + 1] * nxny                # one-past-last own cell id
    inert_row = jnp.zeros((1, _NCOLS), jnp.float32) \
        .at[0, 0:3].set(_BIG).at[0, _OID].set(-1.0)
    inert_m = jnp.broadcast_to(inert_row, (m_cap, _NCOLS))

    # ---- rebin decision (globally uniform) --------------------------------
    # Per-axis displacement SPREAD, like the single-chip driver (ops/lazy.py
    # module docstring): only RELATIVE drift expires frozen bins — a
    # uniformly-falling cloud rebins never.  max/min are reduced globally
    # (pmax/pmin), so `need` is uniform across devices by construction —
    # which keeps the migration collectives inside the rebuild branch legal.
    valid0 = fields[:, _OID] >= 0.0
    delta = fields[:, 0:3] - pos_bin
    d_hi = jax.lax.pmax(
        jnp.max(jnp.where(valid0[:, None], delta, -_BIG), axis=0), _AXIS)
    d_lo = -jax.lax.pmax(
        jnp.max(jnp.where(valid0[:, None], -delta, -_BIG), axis=0), _AXIS)
    spread = jnp.max(d_hi - d_lo)
    fresh = jax.lax.pmax((steps_since[0] < 0).astype(jnp.int32), _AXIS) > 0
    need = fresh | (spread > _f32(2.0 * skin_half(cfg)))
    if not lazy:
        need = need | True

    # ---- migration + local re-sort (rebins only, one uniform cond) --------
    # MULTI-HOP exchange: each hop routes movers one device toward their
    # destination; a uniform while_loop (psum'd pending count) repeats until
    # every mover has landed.  Under the old per-particle drift skin one hop
    # always sufficed; the spread trigger lets a uniformly-translating cloud
    # coast across MANY slab boundaries between rebins, so multi-slab movers
    # are now routine, not a blow-up symptom.  m_cap starvation per hop is
    # still dropped AND counted.
    def _dest(f):
        zp = jnp.clip(jnp.floor(f[:, 2] * _f32(cfg.inv_cell_size))
                      .astype(jnp.int32), 0, cfg.grid_nz - 1)
        return jnp.clip(jnp.searchsorted(zs, zp, side="right") - 1,
                        0, ndev - 1)

    def _pending(f):
        moving = (f[:, _OID] >= 0.0) & (_dest(f) != d)
        return jax.lax.psum(jnp.sum(moving.astype(jnp.int32)), _AXIS)

    def pack(f):
        valid_f = f[:, _OID] >= 0.0
        dest = _dest(f)
        go_left = valid_f & (dest < d)
        go_right = valid_f & (dest > d)
        stay = valid_f & (dest == d)
        # compact: stayers (0) | left (1) | right (2) | inert (3)
        key = jnp.where(stay, 0, jnp.where(go_left, 1,
                                           jnp.where(go_right, 2, 3)))
        _, perm2 = jax.lax.sort(
            (key.astype(jnp.int32), jnp.arange(p_cap, dtype=jnp.int32)),
            num_keys=1)
        packed_f = f[perm2]
        n_stay = jnp.sum(stay.astype(jnp.int32))
        n_left = jnp.sum(go_left.astype(jnp.int32))
        n_right = jnp.sum(go_right.astype(jnp.int32))
        # pad so take()'s dynamic start (<= p_cap) never clamps into stayers
        packed_pad = jnp.concatenate([packed_f, inert_m], axis=0)

        def take(start, n_take):
            rows = jax.lax.dynamic_slice_in_dim(packed_pad, start, m_cap)
            live = jnp.arange(m_cap, dtype=jnp.int32) < n_take
            return jnp.where(live[:, None], rows, inert_row)

        dropped = (jnp.maximum(n_left - m_cap, 0)
                   + jnp.maximum(n_right - m_cap, 0))
        out_l = take(n_stay, jnp.minimum(n_left, m_cap))
        out_r = take(n_stay + n_left, jnp.minimum(n_right, m_cap))
        return packed_f, n_stay, out_l, out_r, dropped

    def _hop(f):
        """One routing hop: send movers one device toward their dest."""
        packed_f, n_stay, out_left, out_right, dropped = pack(f)

        in_from_right = jax.lax.ppermute(out_left, _AXIS, _perm(ndev, -1))
        in_from_left = jax.lax.ppermute(out_right, _AXIS, _perm(ndev, 1))
        in_from_right = jnp.where(d == ndev - 1, inert_m, in_from_right)
        in_from_left = jnp.where(d == 0, inert_m, in_from_left)
        n_in_l = jnp.sum(in_from_left[:, _OID] >= 0.0).astype(jnp.int32)
        n_in_r = jnp.sum(in_from_right[:, _OID] >= 0.0).astype(jnp.int32)

        base = jnp.zeros((p_cap + 2 * m_cap, _NCOLS), jnp.float32) \
            .at[:, 0:3].set(_BIG).at[:, _OID].set(-1.0)
        live_stay = jnp.arange(p_cap, dtype=jnp.int32) < n_stay
        base = base.at[0:p_cap].set(
            jnp.where(live_stay[:, None], packed_f, inert_row))
        base = jax.lax.dynamic_update_slice_in_dim(
            base, in_from_left, n_stay, axis=0)
        base = jax.lax.dynamic_update_slice_in_dim(
            base, in_from_right, n_stay + n_in_l, axis=0)
        new_count = n_stay + n_in_l + n_in_r
        overflow = jnp.maximum(new_count - p_cap, 0)
        return base[0:p_cap], overflow, dropped

    def rebuild_store(f):
        """Route movers to their slabs (collectives included — the predicate
        is uniform), then re-sort the slab by cell id."""
        def cond(state):
            return state[3] > 0

        def body(state):
            buf, overflow, dropped, _ = state
            buf, ov, dr = _hop(buf)
            return (buf, overflow + ov, dropped + dr, _pending(buf))

        zero = jnp.zeros((), jnp.int32)
        buf, overflow, dropped, _ = jax.lax.while_loop(
            cond, body, (f, zero, zero, _pending(f)))
        cnt2 = jnp.sum(buf[:, _OID] >= 0.0).astype(jnp.int32)

        f_s, c_s = _sort_local(cfg, buf, slab_hi)
        return f_s, c_s, f_s[:, 0:3], cnt2, overflow, dropped

    def frozen_store(f):
        zero = jnp.zeros((), jnp.int32)
        return f, cid_frozen, pos_bin, cnt, zero, zero

    fields_s, cid_s, pos_bin2, cnt2, overflow, mig_dropped = jax.lax.cond(
        need, rebuild_store, frozen_store, fields)

    # ---- halo exchange (every step: values move, structure is frozen) -----
    # When not rebinning, cnt2 and cid_s are frozen, so the window starts and
    # exchanged cids re-derive the exact frozen structure; only the VALUES
    # (positions/velocities) the receiver sees are fresh — which is the point.
    send_up, cid_up = _edge_window(        # my top plane, for right neighbor
        fields_s, cid_s, cnt2, h_cap, tail=True)
    send_dn, cid_dn = _edge_window(        # my bottom plane, for left neighbor
        fields_s, cid_s, cnt2, h_cap, tail=False)
    from_left = jax.lax.ppermute(send_up, _AXIS, _perm(ndev, 1))
    cid_left = jax.lax.ppermute(cid_up, _AXIS, _perm(ndev, 1))
    from_right = jax.lax.ppermute(send_dn, _AXIS, _perm(ndev, -1))
    cid_right = jax.lax.ppermute(cid_dn, _AXIS, _perm(ndev, -1))
    # chain ends: no wrap-around space
    inert_h = jnp.zeros((h_cap, _NCOLS), jnp.float32).at[:, 0:3].set(_BIG)
    inert_h = inert_h.at[:, _OID].set(-1.0)
    # chain-end sentinel cids sit OUTSIDE every queryable cell ([-1] below,
    # [num_cells] above) so inert rows can never inflate a real cell's range
    from_left = jnp.where(d == 0, inert_h, from_left)
    cid_left = jnp.where(d == 0, -1, cid_left)
    from_right = jnp.where(d == ndev - 1, inert_h, from_right)
    cid_right = jnp.where(d == ndev - 1, cfg.num_cells, cid_right)

    ext = jnp.concatenate([from_left, fields_s, from_right], axis=0)
    cid_ext = jnp.concatenate([cid_left, cid_s, cid_right])

    # ---- frozen window tables (rebins only) --------------------------------
    row_valid = ext[h_cap:h_cap + p_cap, _OID] >= 0.0

    def build_tabs(_):
        return _local_ranges(cfg, cid_ext, cid_s, row_valid, ext.shape[0])

    tabs2 = jax.lax.cond(need, build_tabs, lambda _: tabs, None)

    # ---- sweeps ------------------------------------------------------------
    pos_i = fields_s[:, _POS]
    vel_i = fields_s[:, _VEL]
    mass_i = fields_s[:, _MASS]
    rng_s, rng_e = tabs2
    own_idx = h_cap + jnp.arange(p_cap, dtype=jnp.int32)
    pos_e, vel_e, mass_e = ext[:, _POS], ext[:, _VEL], ext[:, _MASS]
    rho_l, nc_l, trunc = celllist.density_rows(
        cfg, pos_e, mass_e, rng_s, rng_e, own_idx, pos_i, mass_i)

    # force needs halo densities: exchange rho for the same edge windows
    rho_up = jax.lax.dynamic_slice_in_dim(rho_l, jnp.maximum(cnt2 - h_cap, 0),
                                          h_cap)
    rho_dn = jax.lax.dynamic_slice_in_dim(rho_l, 0, h_cap)
    rho_left = jax.lax.ppermute(rho_up, _AXIS, _perm(ndev, 1))
    rho_right = jax.lax.ppermute(rho_dn, _AXIS, _perm(ndev, -1))
    rho_left = jnp.where(d == 0, 0.0, rho_left)
    rho_right = jnp.where(d == ndev - 1, 0.0, rho_right)
    rho_e = jnp.concatenate([rho_left, rho_l, rho_right])

    acc_l = celllist.force_rows(
        cfg, pos_e, vel_e, mass_e, rho_e, rng_s, rng_e, own_idx,
        pos_i, vel_i, rho_l)

    # ---- integrate (inert rows stay inert: acc 0, vel 0) ------------------
    # Inert rows ride through the integrator at a SAFE in-box point: the
    # far-away sentinel position would blow up reflect_boundary's crossing
    # times (inf/NaN) and poison the NaN-propagating PE tally; mass 0 keeps
    # every tally contribution at zero, and the store is re-written to the
    # inert sentinel after integration regardless.
    safe = jnp.asarray(cfg.central_pos, jnp.float32)
    acc_l = jnp.where(row_valid[:, None], acc_l, 0.0)
    local_state = ParticleState(
        position=jnp.where(row_valid[:, None], pos_i, safe),
        velocity=jnp.where(row_valid[:, None], vel_i, 0.0),
        mass=jnp.where(row_valid, mass_i, 0.0),
        density=rho_l,
        acceleration=acc_l,
        neighbor_count=nc_l,
    )
    new_state, tally = kdk_integrate(cfg, local_state, acc_l)
    new_fields = jnp.concatenate(
        [new_state.position, new_state.velocity,
         mass_i[:, None], fields_s[:, _OID:_OID + 1]], axis=1)
    new_fields = jnp.where(row_valid[:, None], new_fields, inert_row)

    # ---- tallies + diagnostics (fused collectives) -------------------------
    # Inert rows contribute mass 0 / vel 0 -> KE 0, but PE uses G*M*m/(r):
    # mass 0 zeroes it; NaN-safety holds since positions finite.  |L| must
    # psum the VECTOR before taking the norm (sum of per-shard norms is not
    # the norm of the global sum) — kdk's tally carries l_vec for exactly
    # this.  Every psum-able per-step scalar rides ONE [10] psum and both
    # neighbor extrema ride ONE pmax (pmin(x) = -pmax(-x)): every
    # collective is a per-step latency on a real mesh.
    valid_n = new_fields[:, _OID] >= 0.0
    nc_w = jnp.where(row_valid, nc_l, 0)
    # an undersized halo window misses plane rows: COUNT them (valid rows in
    # an edge plane minus those the fixed window could carry).  The two edge
    # occupancy sums ride the same stacked reduce as the neighbor stats.
    top_plane = row_valid & (cid_s >= slab_hi - nxny)
    bot_plane = row_valid & (cid_s < slab_lo + nxny)
    nc_cols = jnp.stack([valid_n, nc_w.astype(jnp.float32),
                         top_plane, bot_plane], axis=1)
    s_nc = jnp.sum(nc_cols, axis=0)   # [4]: n_valid, nc_sum, pop_top, pop_bot
    halo_missed = (jnp.maximum(s_nc[2] - h_cap, 0.0)
                   + jnp.maximum(s_nc[3] - h_cap, 0.0))
    sums = jnp.stack([
        tally.kinetic, tally.potential,
        tally.l_vec[0], tally.l_vec[1], tally.l_vec[2],
        s_nc[0], s_nc[1],
        jnp.sum(trunc).astype(jnp.float32),
        halo_missed,
        (mig_dropped + overflow).astype(jnp.float32)])
    S = jax.lax.psum(sums, _AXIS)
    extrema = jax.lax.pmax(jnp.stack([
        jnp.max(nc_w).astype(jnp.float32),
        -jnp.min(jnp.where(row_valid, nc_l, jnp.int32(2**30)))
        .astype(jnp.float32)]), _AXIS)
    if cfg.compat:
        am = jnp.zeros((), jnp.float32)   # reference always logs 0 (quirk 8)
    else:
        am = jnp.linalg.norm(S[2:5])

    diag_vec = jnp.stack([
        S[0], S[1], am,
        S[6] / jnp.maximum(S[5], 1.0),
        extrema[0], -extrema[1],
        S[7], S[8], S[9]])
    steps2 = jnp.where(need, 0, steps_since[0] + 1)
    rebin2 = rebin_count[0] + need.astype(jnp.int32)
    return (new_fields, cnt2[None], pos_bin2, cid_s, tabs2,
            steps2[None], rebin2[None], diag_vec[None])


def init_lazy_slab(cfg: SphConfig, mesh: Mesh, carry: SlabCarry,
                   p_cap: int) -> LazySlabCarry:
    """Wrap a freshly distributed store with empty frozen structure.

    ``steps_since = -1`` forces the first step to migrate/sort/build tables.
    """
    ndev = math.prod(mesh.devices.shape)
    sh = NamedSharding(mesh, P(_AXIS))
    put = lambda x: jax.device_put(x, sh)
    return LazySlabCarry(
        fields=carry.fields, count=carry.count,
        pos_bin=put(jnp.zeros((ndev * p_cap, 3), jnp.float32)),
        cid=put(jnp.zeros((ndev * p_cap,), jnp.int32)),
        tabs=(put(jnp.zeros((ndev * p_cap, 9), jnp.int32)),
              put(jnp.zeros((ndev * p_cap, 9), jnp.int32))),
        steps_since=put(jnp.full((ndev,), -1, jnp.int32)),
        rebin_count=put(jnp.zeros((ndev,), jnp.int32)),
    )


def slab_imbalance(carry) -> float:
    """max/mean ratio of per-device valid-row counts (1.0 = perfect)."""
    import numpy as np

    counts = np.asarray(carry.count).astype(np.float64)
    return float(counts.max() / max(counts.mean(), 1.0))


def maybe_rebalance(cfg: SphConfig, mesh: Mesh, carry, n: int,
                    threshold: float = 1.5, headroom: float = 1.5):
    """Host-side dynamic re-partition (call at block/checkpoint boundaries).

    The zsplit frozen at t=0 goes stale when mass re-concentrates (a splash
    collapsing to the box floor); the only guard inside the step is counted
    drops.  This recomputes the z-plane histogram from the CURRENT particle
    distribution and, when the per-device load imbalance exceeds
    ``threshold``, re-collects and re-distributes the store under a fresh
    occupancy-weighted split (same machinery as ``derive_zsplit`` at t=0).

    Returns ``(carry, zsplit, caps, changed)``; when ``changed`` the caller
    must rebuild its step function for the new ``zsplit``/``caps`` (a
    recompile — which is why this belongs at block boundaries, like the
    CLI's mid-run --apply).
    Collectives never run here: pure host work.
    """
    ndev = math.prod(mesh.devices.shape)
    if slab_imbalance(carry) <= threshold:
        return carry, None, None, False
    state = collect(carry, n)
    zsplit = derive_zsplit(cfg, state, ndev)
    caps = derive_slab_caps(cfg, state, ndev, headroom=headroom, zsplit=zsplit)
    new_carry = distribute(cfg, state, mesh, caps[0], zsplit=zsplit)
    return new_carry, zsplit, caps, True


def make_slab_step(cfg: SphConfig, mesh: Mesh, p_cap: int, h_cap: int,
                   m_cap: int, donate: bool = True,
                   zsplit: tuple[int, ...] | None = None, lazy: bool = True,
                   scan_block: int = 0
                   ) -> Callable[[SlabCarry | LazySlabCarry],
                                 tuple[LazySlabCarry, StepDiagnostics]]:
    """Fully-distributed step over ``mesh`` (see module docstring), with the
    XLA cell-list sweeps inside each device's shard.

    ``lazy=True`` (default) freezes the per-device sort + candidate ranges
    between rebins under the cell - h displacement-SPREAD skin — the
    distributed port of the single-device lazy driver, amortizing the
    per-step rebuild the reference pays on every step
    (/root/reference/src/sph.cpp:438-481).  ``lazy=False`` rebins (and
    migrates) every step.

    ``scan_block=K`` (K > 1) runs K physics steps per dispatch via
    ``lax.scan``: the returned callable advances K steps per call and its
    ``StepDiagnostics`` leaves carry a leading [K] axis.

    Accepts a plain ``SlabCarry`` (auto-initialized) or a ``LazySlabCarry``
    from a previous call; returns a ``LazySlabCarry``.
    """
    ndev = math.prod(mesh.devices.shape)
    _nzs(cfg, ndev)
    if zsplit is None:
        zsplit = uniform_zsplit(cfg, ndev)
    zsplit = tuple(int(z) for z in zsplit)
    if (len(zsplit) != ndev + 1 or zsplit[0] != 0
            or zsplit[-1] != cfg.grid_nz
            or any(b - a < 2 for a, b in zip(zsplit, zsplit[1:]))):
        raise ValueError(f"invalid zsplit {zsplit}: need {ndev + 1} "
                         "monotone entries spanning [0, grid_nz], >= 2 "
                         "planes per device")

    body = partial(slab_step_body, cfg, ndev, p_cap, h_cap, m_cap, zsplit,
                   lazy)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(_AXIS),) * 4 + (P(_AXIS),) + (P(_AXIS),) * 2,
        out_specs=(P(_AXIS),) * 4 + (P(_AXIS),) + (P(_AXIS),) * 3,
        # the body is manually-sharded SPMD (explicit ppermute/psum)
        check_vma=False,
    )

    def _diag(dv) -> StepDiagnostics:
        """[..., 9] psum'd diagnostic vector -> StepDiagnostics pytree."""
        zeros = jnp.zeros(dv.shape[:-1], jnp.int32)
        return StepDiagnostics(
            kinetic_energy=dv[..., 0], potential_energy=dv[..., 1],
            angular_momentum=dv[..., 2], neighbor_mean=dv[..., 3],
            neighbor_max=dv[..., 4].astype(jnp.int32),
            neighbor_min=dv[..., 5].astype(jnp.int32),
            overflow_cells=zeros,
            truncated_ranges=dv[..., 6].astype(jnp.int32),
            halo_dropped=dv[..., 7].astype(jnp.int32),
            migration_dropped=dv[..., 8].astype(jnp.int32),
        )

    def _step(carry: LazySlabCarry) -> tuple[LazySlabCarry, StepDiagnostics]:
        (fields, count, pos_bin, cid, tabs, steps_since, rebins,
         diag_rows) = sharded(carry.fields, carry.count, carry.pos_bin,
                              carry.cid, carry.tabs,
                              carry.steps_since, carry.rebin_count)
        return LazySlabCarry(fields, count, pos_bin, cid, tabs,
                             steps_since, rebins), _diag(diag_rows[0])

    def _step_scan(carry: LazySlabCarry
                   ) -> tuple[LazySlabCarry, StepDiagnostics]:
        def body(c: LazySlabCarry, _):
            (fields, count, pos_bin, cid, tabs, steps_since, rebins,
             diag_rows) = sharded(c.fields, c.count, c.pos_bin, c.cid,
                                  c.tabs, c.steps_since, c.rebin_count)
            return (LazySlabCarry(fields, count, pos_bin, cid, tabs,
                                  steps_since, rebins), diag_rows[0])

        carry, dvs = jax.lax.scan(body, carry, None, length=scan_block)
        return carry, _diag(dvs)   # [K, 9] -> leaves with leading [K]

    jitted = jax.jit(_step_scan if scan_block > 1 else _step,
                     donate_argnums=(0,) if donate else ())

    def step(carry):
        if not isinstance(carry, LazySlabCarry):
            carry = init_lazy_slab(cfg, mesh, carry, p_cap)
        return jitted(carry)

    return step
