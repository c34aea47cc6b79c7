"""Step orchestration: one physics step and the scanned whole-run loop.

The reference's ``SPH::step`` sequences voxelize -> findNeighbors -> density ->
(pressure inlined) -> acceleration -> integrate on a worker thread
(/root/reference/src/sph.cpp:190-304).  Here a step is one pure function
``state -> (state, diagnostics)``; a whole run is ``lax.scan`` over it, traced
once and compiled once.  Thread control (src/sph.cpp:120-147) has no
counterpart here — dispatch is synchronous, execution is async on-device.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Literal

import jax
import jax.numpy as jnp

from ..config import SphConfig
from ..state import (ParticleState, StepDiagnostics, make_step_diagnostics,
                     stack_diagnostics)
from . import celllist, pairwise
from .integrate import kdk_integrate

Backend = Literal["celllist", "pairwise", "pallas", "compat"]


def default_backend(platform: str) -> Backend:
    """The single-device backend ``--backend auto`` runs on ``platform``
    (``jax.devices()[0].platform``): the Pallas sweeps on a GPU, the XLA
    cell list elsewhere."""
    return "pallas" if platform == "gpu" else "celllist"


def compute_forces(cfg: SphConfig, state: ParticleState, backend: Backend = "celllist"
                   ) -> tuple[jnp.ndarray, jnp.ndarray, celllist.CellListAux]:
    """(acceleration, density, aux) for the current positions/velocities."""
    if backend == "celllist":
        return celllist.compute_step_quantities(cfg, state)
    if backend == "pallas":
        from . import pallas_sweep

        return pallas_sweep.compute_step_quantities(cfg, state)
    if backend == "compat":
        from ..compat.step import compute_compat_quantities

        return compute_compat_quantities(cfg, state)
    if backend == "pairwise":
        rho = pairwise.compute_density(cfg, state)
        acc = pairwise.compute_acceleration(cfg, state, rho)
        aux = celllist.CellListAux(
            neighbor_count=pairwise.neighbor_counts(cfg, state),
            overflow_cells=jnp.zeros((), jnp.int32),
            truncated_ranges=jnp.zeros((), jnp.int32),
        )
        return acc, rho, aux
    raise ValueError(f"unknown backend: {backend}")


def step(cfg: SphConfig, state: ParticleState, backend: Backend = "celllist"
         ) -> tuple[ParticleState, StepDiagnostics]:
    """One full physics step (forces + KDK integration + diagnostics)."""
    if backend == "compat" or (cfg.compat and backend != "pairwise"):
        from ..compat.step import compat_step

        return compat_step(cfg, state)
    acc, rho, aux = compute_forces(cfg, state, backend)
    state = state._replace(density=rho, neighbor_count=aux.neighbor_count)
    if cfg.second_kick == "full":
        new_state, tally = _kdk_full(cfg, state, acc, backend)
    else:
        new_state, tally = kdk_integrate(cfg, state, acc)
    diag = make_step_diagnostics(tally, aux.neighbor_count, aux.overflow_cells,
                                 truncated_ranges=aux.truncated_ranges)
    return new_state, diag


def _kdk_full(cfg: SphConfig, state: ParticleState, acc,
              backend: Backend) -> tuple[ParticleState, "object"]:
    """True 2nd-order leapfrog: the closing half-kick re-evaluates the FULL
    force (hydro + gravity) at the drifted positions.

    The reference's closing kick is gravity-only and uses a full dt
    (/root/reference/src/sph.cpp:972-995, second_kick="gravity"); this is the
    corrected symmetric integrator at ~2x cost per step.
    """
    import jax.numpy as jnp

    from .integrate import energy_tally, reflect_boundary

    dt = jnp.float32(cfg.dt)
    v_half = state.velocity + acc * (dt * 0.5)
    new_pos = state.position + v_half * (dt / jnp.float32(cfg.sim_scale))
    mid = state._replace(position=new_pos, velocity=v_half)
    acc2, rho2, aux2 = compute_forces(cfg, mid, backend)
    new_vel = v_half + acc2 * (dt * 0.5)
    if cfg.boundary == "reflect":
        new_pos, new_vel = reflect_boundary(cfg, state.position, new_pos, new_vel)
    tally = energy_tally(cfg, new_pos, new_vel, state.mass)
    new_state = state._replace(position=new_pos, velocity=new_vel,
                               acceleration=acc2, density=rho2)
    return new_state, tally


def make_step(cfg: SphConfig, backend: Backend = "celllist",
              donate: bool = True) -> Callable[[ParticleState], tuple[ParticleState, StepDiagnostics]]:
    """A jitted single-step function with the config baked in."""
    f = partial(step, cfg, backend=backend)
    return jax.jit(f, donate_argnums=(0,) if donate else ())


def run_steps(cfg: SphConfig, state: ParticleState, num_steps: int,
              backend: Backend = "celllist") -> tuple[ParticleState, StepDiagnostics]:
    """``num_steps`` steps under one ``lax.scan``; diagnostics stacked per step.

    This is the whole-run loop the reference implements as a QThread while-loop
    (/root/reference/src/sph.cpp:171-181), compiled as a single XLA program.
    """

    def body(carry, _):
        new_state, diag = step(cfg, carry, backend)
        return new_state, diag

    final, diags = jax.lax.scan(body, state, None, length=num_steps)
    return final, diags


_STEP_CACHE: dict = {}


def _cached_step(cfg: SphConfig, backend: Backend):
    key = (cfg, backend)
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = jax.jit(partial(step, cfg, backend=backend),
                                   donate_argnums=(0,))
    return _STEP_CACHE[key]


def drive_loop(cfg: SphConfig, state: ParticleState, num_steps: int,
               backend: Backend = "celllist",
               collect_diags: bool = True
               ) -> tuple[ParticleState, StepDiagnostics | None]:
    """Host-driven step loop with buffer donation, one jitted step per call.

    Diagnostics are device scalars fetched lazily; with
    ``collect_diags=False`` nothing is fetched until the caller syncs.
    """
    f = _cached_step(cfg, backend)
    diags = []
    for _ in range(num_steps):
        state, d = f(state)
        if collect_diags:
            diags.append(d)
    if not collect_diags:
        return state, None
    stacked = stack_diagnostics(diags)
    return state, stacked


def simulate(cfg: SphConfig, state: ParticleState, backend: Backend = "celllist",
             steps_per_block: int = 50, callback=None) -> tuple[ParticleState, StepDiagnostics]:
    """Full simulation honouring cfg.num_steps, in scan blocks.

    Runs ``lax.scan`` blocks of ``steps_per_block`` under jit and invokes
    ``callback(step_index, state, diags_block)`` on host between blocks (for
    file diagnostics, rendering, checkpointing) — the analogue of the
    reference's per-step file writes (src/sph.cpp:176-178).
    """
    total = cfg.num_steps + 1  # ref loop runs stepCount <= totalSteps
    all_diags = []
    done = 0
    while done < total:
        n = min(steps_per_block, total - done)
        state, diags = drive_loop(cfg, state, n, backend=backend)
        if callback is not None:
            callback(done, state, diags)
        all_diags.append(diags)
        done += n
    merged = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *all_diags)
    return state, merged
