#!/usr/bin/env python
"""Throughput benchmark on one GPU: prints one JSON line per result.

Rows, all in this one process (a second JAX process could not take the
card's memory):

* headline — particle-steps/s of the scene (default the 1M splash) through
  the backend ``--backend auto`` resolves to, and the lazy driver where it
  applies (``ops.lazy.applies``, the same rule as ``cli run``);
* parity — the pallas sweeps against the ``celllist`` reference on this
  device (``utils.benchmark.run_parity_check``);
* slab_1dev — the distributed slab engine on a 1-device mesh.

Every line carries the device (platform, ``device_kind``, count, card name
and power limit).  Without a GPU the script fails: it never reports a CPU
run under the device metric.

Usage: python bench.py [--scene SCENE] [-n N] [--steps STEPS] [--backend B]
"""

import argparse
import json
import sys


def _emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="splash")
    ap.add_argument("-n", "--num-particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--backend", default="auto",
                    help="auto = ops.step.default_backend of this device")
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the pallas-vs-celllist parity row")
    ap.add_argument("--no-slab", action="store_true",
                    help="skip the slab-engine 1-device-mesh row")
    args = ap.parse_args()

    from smoothed_particle_hydrodynamics_tpu.utils.cache import (
        enable_compile_cache)

    enable_compile_cache()

    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu.ops import lazy
    from smoothed_particle_hydrodynamics_tpu.ops.step import default_backend
    from smoothed_particle_hydrodynamics_tpu.utils.benchmark import (
        device_info, require_gpu, run_benchmark, run_parity_check,
        run_slab_benchmark)

    device = require_gpu()
    backend = args.backend
    if backend == "auto":
        backend = default_backend(device.platform)
    overrides = {"num_particles": args.num_particles}
    cfg, _ = make_scene(args.scene, **overrides)
    result = run_benchmark(scene=args.scene, backend=backend,
                           steps=args.steps, warmup=args.warmup,
                           overrides=overrides,
                           lazy=lazy.applies(cfg, backend))
    _emit({"row": "headline", **result})

    if not args.no_parity:
        _emit({"row": "parity", **run_parity_check(),
               "device": device_info()})
    if not args.no_slab:
        _emit({"row": "slab_1dev",
               **run_slab_benchmark(n=args.num_particles,
                                    steps=max(args.steps // 3, 10))})
    return 0


if __name__ == "__main__":
    sys.exit(main())
