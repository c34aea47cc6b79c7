"""Lazy rebinning: keep state sorted, rebuild the cell structure only on drift.

The reference rebins every step (reference src/sph.cpp:438-481).  The
rebin (pair sort + window tables) and the frame changes around it (field
gather into sorted order, inverse-permute of the outputs) are unnecessary
most steps, because particles move a small fraction of a cell per step.

``cli run`` uses it for the pallas backend unless ``--no-lazy`` (rule:
``applies``).  On an H100 it measured slower than rebinning every step
through ``ops.step.drive_loop`` (PERF.md, "Kernel decisions"): a GPU rebin
is cheap next to what the per-step ``lax.cond`` costs.

Design
------
* The authoritative state lives permanently in the SORTED frame (sorted by
  the cell id of the *bin-time* positions).  Sweeps, integration, and
  diagnostics all run in that frame; nothing is un-permuted per step.
  ``LazyCarry.order`` tracks the accumulated permutation so callers can
  recover the original particle indexing at the end of a run.
* The window tables and candidate cell ids are FROZEN between rebins.  The
  pair mask in the kernels tests true (current-position) distances, so stale
  bins only affect which candidates are *considered*, never the physics.
  The sweeps are the Pallas kernels of ``ops.pallas_sweep``.

Correctness bound
-----------------
Let c = cell_size, h = support radius, and δ_i = x_i(now) - x_i(bin) the
per-particle displacement VECTOR since binning.  For a true pair
(|dx(now)| < h per axis) the bin-time separation obeys, per axis a,
|dx(bin)^a| = |dx(now)^a - (δ_i^a - δ_j^a)| <= h + (max_k δ_k^a - min_k δ_k^a).
Bin-time cells are adjacent (the 27-stencil covers the pair) whenever
|dx(bin)| < c per axis, so the frozen structure is a superset of the true
neighbor graph as long as the per-axis displacement SPREAD obeys

    max_k δ_k^a - min_k δ_k^a <= c - h        for every axis a.

Only RELATIVE drift matters: a uniformly translating cloud (the falling
phase of the splash scene, or the drop while the pool rests) never expires
its bins no matter how far it falls — the common-mode displacement cancels
out of every pair separation.  (The per-particle bound max|δ| <= (c-h)/2 is
the special case of displacements symmetric about 0; the spread bound
strictly dominates it.)

``lazy_step`` checks this bound against the positions the sweep is about to
use and rebuilds *first* when it would be violated, so the invariant holds
exactly at every sweep.  With ``cell_size_factor == 1`` the skin is zero and
the driver degrades to rebinning every step — still correct, never faster.
``StepDiagnostics`` are unaffected (all reductions are permutation-invariant
up to f32 summation order).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import SphConfig
from ..state import (ParticleState, StepDiagnostics, make_step_diagnostics,
                     stack_diagnostics)
from .grid import inverse_order, unsort_stacked
from .integrate import kdk_integrate
from .pallas_sweep import Frame, prepare, sweeps_sorted


class LazyCarry(NamedTuple):
    """Sorted-frame state + frozen binning structure."""

    state: ParticleState     # sorted frame
    order: jnp.ndarray       # [N] i32: state[i] == initial_state[order[i]]
    pos_bin: jnp.ndarray     # [N,3] sorted-frame positions at bin time
    cid: jnp.ndarray         # [N] i32 frozen cell ids
    ws: jnp.ndarray          # [nblocks*9] frozen window starts
    wl: jnp.ndarray          # [nblocks*9] frozen window lengths
    steps_since: jnp.ndarray  # i32 scalar: steps since last rebin
    rebin_count: jnp.ndarray  # i32 scalar: total rebins so far


def skin_half(cfg: SphConfig) -> float:
    """Half the tolerated per-axis displacement SPREAD (world units) under
    frozen bins; the full budget is ``2 * skin_half = cell_size - h``."""
    return max(0.5 * (cfg.cell_size - cfg.h), 0.0)


def drift_spread(position: jnp.ndarray, pos_bin: jnp.ndarray) -> jnp.ndarray:
    """Max over axes of the displacement spread (max_k δ^a - min_k δ^a)."""
    delta = position - pos_bin
    return jnp.max(jnp.max(delta, axis=0) - jnp.min(delta, axis=0))


def applies(cfg: SphConfig, backend: str) -> bool:
    """Whether ``--lazy`` auto runs ``backend`` for ``cfg`` under this
    driver: the pallas sweeps in default mode with a gravity-only or no
    closing kick."""
    return (backend == "pallas" and not cfg.compat
            and cfg.second_kick != "full")


def _validate(cfg: SphConfig) -> None:
    if not applies(cfg, "pallas"):
        raise ValueError("lazy driver supports default mode with "
                         "second_kick in ('gravity', 'none') only — 'full' "
                         "re-evaluates forces inside the integrator")


def _carry_fields(cfg: SphConfig, state: ParticleState):
    """(sorted_state, order, pos_bin, cid, ws, wl) from scratch."""
    f = prepare(cfg, state)
    zeros = jnp.zeros_like(f.mass_s)
    sorted_state = state._replace(
        position=f.pos_s, velocity=f.vel_s, mass=f.mass_s,
        density=zeros,
        acceleration=jnp.zeros_like(f.pos_s),
        neighbor_count=jnp.zeros_like(f.mass_s, dtype=jnp.int32),
    )
    return sorted_state, f.order, f.pos_s, f.cid, f.ws, f.wl


def init_lazy(cfg: SphConfig, state: ParticleState) -> LazyCarry:
    """Sort the initial state and build the first binning structure."""
    _validate(cfg)
    zero = jnp.zeros((), jnp.int32)
    return LazyCarry(*_carry_fields(cfg, state), steps_since=zero,
                     rebin_count=zero)


def lazy_step(cfg: SphConfig, carry: LazyCarry
              ) -> tuple[LazyCarry, StepDiagnostics]:
    """One physics step under frozen bins, rebuilding first if drift demands.

    Call under jit.  The drift check runs against exactly the positions the
    sweeps consume, so the spread bound in the module docstring holds at
    every sweep by construction.
    """
    need = (drift_spread(carry.state.position, carry.pos_bin)
            > jnp.float32(2.0 * skin_half(cfg)))

    def rebuild(c: LazyCarry):
        st, perm, pos_bin, cid, ws, wl = _carry_fields(cfg, c.state)
        return LazyCarry(st, c.order[perm], pos_bin, cid, ws, wl,
                         jnp.zeros((), jnp.int32), c.rebin_count + 1)

    def keep(c: LazyCarry):
        return c._replace(steps_since=c.steps_since + 1)

    carry = jax.lax.cond(need, rebuild, keep, carry)
    state = carry.state
    f = Frame(order=carry.order, pos_s=state.position, vel_s=state.velocity,
              mass_s=state.mass, cid=carry.cid, ws=carry.ws, wl=carry.wl)
    acc_s, rho_s, ncount_s = sweeps_sorted(cfg, f)
    state = state._replace(density=rho_s, neighbor_count=ncount_s)
    new_state, tally = kdk_integrate(cfg, state, acc_s)

    zero = jnp.zeros((), jnp.int32)
    diag = make_step_diagnostics(tally, ncount_s, overflow_cells=zero,
                                 truncated_ranges=zero)
    return carry._replace(state=new_state), diag


@jax.jit
def unsort_carry(carry: LazyCarry) -> ParticleState:
    """Recover the original particle indexing from a lazy run's carry.

    Jitted: run op by op, its sort and gathers cost more than a whole
    32k-particle step on the GPU."""
    st = carry.state
    inv = inverse_order(carry.order)
    pos, vel, acc, mass, rho, ncount = unsort_stacked(
        inv, [st.position, st.velocity, st.acceleration,
              st.mass, st.density, st.neighbor_count])
    return st._replace(position=pos, velocity=vel, acceleration=acc,
                       mass=mass, density=rho, neighbor_count=ncount)


_LAZY_CACHE: dict = {}


def _cached_lazy_step(cfg: SphConfig):
    if cfg not in _LAZY_CACHE:
        _LAZY_CACHE[cfg] = jax.jit(partial(lazy_step, cfg), donate_argnums=(0,))
    return _LAZY_CACHE[cfg]


def _cached_lazy_scan(cfg: SphConfig, k: int):
    """K lazy steps inside ONE jit call (per-step diagnostics as scan ys).

    Amortizes the per-dispatch host overhead K-fold where it is a large
    share of a small step; opt-in via ``drive_loop_lazy(scan_block=K)``.
    """
    key = (cfg, k)
    if key not in _LAZY_CACHE:
        def block(carry: LazyCarry):
            def body(c, _):
                return lazy_step(cfg, c)
            return jax.lax.scan(body, carry, None, length=k)
        _LAZY_CACHE[key] = jax.jit(block, donate_argnums=(0,))
    return _LAZY_CACHE[key]


def drive_loop_lazy(cfg: SphConfig, state: ParticleState, num_steps: int,
                    collect_diags: bool = True, carry: LazyCarry | None = None,
                    keep_carry: bool = False, scan_block: int = 0):
    """Host-driven lazy loop (the pallas production driver).

    Returns ``(state, diags)`` like ``ops.step.drive_loop``; the returned
    state is restored to the caller's particle order.  Pass ``keep_carry=True``
    to get ``(carry, diags)`` instead for chained blocks without the
    per-block unsort.  ``scan_block=K`` (K > 1) runs K steps per dispatch via
    ``lax.scan`` — a dispatch-amortization dial for small scenes; per-step
    diagnostics are preserved as scan ys.
    """
    if carry is None:
        carry = jax.jit(partial(init_lazy, cfg))(state)
    f = _cached_lazy_step(cfg)
    diags = []
    remaining = num_steps
    if scan_block > 1:
        fk = _cached_lazy_scan(cfg, scan_block)
        while remaining >= scan_block:
            carry, dk = fk(carry)
            remaining -= scan_block
            if collect_diags:
                diags.extend(jax.tree.map(lambda x, i=i: x[i], dk)
                             for i in range(scan_block))
    for _ in range(remaining):
        carry, d = f(carry)
        if collect_diags:
            diags.append(d)
    stacked = (stack_diagnostics(diags)
               if collect_diags else None)
    if keep_carry:
        return carry, stacked
    return unsort_carry(carry), stacked
