"""Per-phase profiling harness.

The reference brackets each of its six step phases with QElapsedTimer and
writes per-step times to out/timing.txt (/root/reference/src/sph.cpp:192-299).
Under jit the phases fuse into one program, so per-phase numbers require
running the phases as separate jitted calls, each fenced with
``jax.block_until_ready`` — exactly what :func:`profile_phases` does.  Use it
for tuning; production runs report the fused step time.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..config import SphConfig
from ..state import ParticleState


def timeit(fn: Callable, *args, iters: int = 10) -> float:
    """Mean wall-clock of a jitted callable, ms per call."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters * 1000.0


def profile_phases(cfg: SphConfig, state: ParticleState, iters: int = 10
                   ) -> dict[str, float]:
    """Phase timings [ms] in the reference's timing.txt vocabulary.

    voxelize   = binning + sort (ops.grid.build_grid)
    neighbors  = candidate-range construction
    density    = density sweep
    pressure   = 0 (inlined into forces, exactly like the reference's
                 empty computePressure pass, src/sph.cpp:256-262)
    acceleration = force sweep (+gravity +CFL)
    integrate  = KDK + tallies
    """
    from ..ops import celllist
    from ..ops.grid import build_grid
    from ..ops.integrate import kdk_integrate

    times: dict[str, float] = {}
    grid_fn = jax.jit(partial(build_grid, cfg))
    times["voxelize"] = timeit(grid_fn, state.position, iters=iters)

    prep_fn = jax.jit(partial(celllist.prepare, cfg))
    prep = prep_fn(state)
    times["neighbors"] = max(timeit(prep_fn, state, iters=iters) - times["voxelize"], 0.0)

    n = state.position.shape[0]
    own = jnp.arange(n, dtype=jnp.int32)
    dens_fn = jax.jit(partial(celllist.density_rows, cfg))
    rho_s, _, _ = dens_fn(prep.pos_s, prep.mass_s, prep.rng_start, prep.rng_end,
                          own, prep.pos_s, prep.mass_s)
    times["density"] = timeit(dens_fn, prep.pos_s, prep.mass_s, prep.rng_start,
                              prep.rng_end, own, prep.pos_s, prep.mass_s,
                              iters=iters)
    times["pressure"] = 0.0

    force_fn = jax.jit(partial(celllist.force_rows, cfg))
    times["acceleration"] = timeit(
        force_fn, prep.pos_s, prep.vel_s, prep.mass_s, rho_s,
        prep.rng_start, prep.rng_end, own, prep.pos_s, prep.vel_s, rho_s,
        iters=iters)

    acc = jnp.zeros_like(state.position)
    integ_fn = jax.jit(partial(kdk_integrate, cfg))
    times["integrate"] = timeit(integ_fn, state, acc, iters=iters)
    return times


def profile_step(cfg: SphConfig, state: ParticleState, backend: str = "celllist",
                 iters: int = 10) -> float:
    """Fused whole-step time [ms] for the given backend."""
    from ..ops.step import step

    fn = jax.jit(partial(step, cfg, backend=backend))
    return timeit(fn, state, iters=iters)
