"""Phase-by-phase timing of the cell-list step on the current device.

Usage: python tools/profile_step.py [N] [SWEEP_CHUNK]   (default: SphConfig's)
"""

import time
from functools import partial

import jax
import jax.numpy as jnp

from smoothed_particle_hydrodynamics_tpu.models import make_scene
from smoothed_particle_hydrodynamics_tpu.ops import celllist
from smoothed_particle_hydrodynamics_tpu.ops.grid import build_grid, unsort
from smoothed_particle_hydrodynamics_tpu.ops.step import step


def bench(name, fn, *args, iters=20):
    out = jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters * 1000
    print(f"{name:28s} {dt:8.3f} ms")
    return out


def main(n=32768, chunk=None):
    extra = {} if chunk is None else {"sweep_chunk": chunk}
    cfg, state = make_scene("disk", num_particles=n, **extra)
    print(f"n={n} chunk={cfg.sweep_chunk} device={jax.devices()[0]}")

    grid_fn = jax.jit(partial(build_grid, cfg))
    g = bench("build_grid (sort+offsets)", grid_fn, state.position)

    prep_fn = jax.jit(partial(celllist.prepare, cfg))
    p = bench("prepare (grid+ranges)", prep_fn, state)

    own = jnp.arange(n, dtype=jnp.int32)

    dens_fn = jax.jit(partial(celllist.density_rows, cfg))
    rho_s, nc, tr = bench(
        "density sweep", dens_fn,
        p.pos_s, p.mass_s, p.rng_start, p.rng_end, own, p.pos_s, p.mass_s)

    force_fn = jax.jit(partial(celllist.force_rows, cfg))
    acc_s = bench(
        "force sweep", force_fn,
        p.pos_s, p.vel_s, p.mass_s, rho_s,
        p.rng_start, p.rng_end, own, p.pos_s, p.vel_s, rho_s)

    uns_fn = jax.jit(unsort)
    bench("unsort", uns_fn, p.grid.order, acc_s)

    step_fn = jax.jit(partial(step, cfg))
    bench("full step", step_fn, state, iters=10)


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else None
    main(n, chunk)
