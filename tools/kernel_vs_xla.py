"""Time the Pallas sweeps against XLA's cell-list sweeps, end to end.

Every number is the median ms/step of ``cli run`` (5 blocks of 10 steps
after a warm-up block; ``utils.benchmark.time_cli_run``) on the current GPU:

* the XLA ``celllist`` backend at each ``sweep_chunk`` of the sweep
  (0 = all rows in one chunk);
* the ``pallas`` backend (the lazy driver over the Pallas sweeps).

Usage: python tools/kernel_vs_xla.py [--scenes splash,disk] [--chunks ...]
Prints one JSON line per run; the first line names the card.
"""

import argparse
import json

from smoothed_particle_hydrodynamics_tpu.utils.benchmark import (
    device_info, require_gpu, time_cli_run)
from smoothed_particle_hydrodynamics_tpu.utils.cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default="splash,disk")
    ap.add_argument("--chunks", default="1024,16384,131072,0")
    args = ap.parse_args()
    enable_compile_cache()
    require_gpu()
    print(json.dumps({"device": device_info()}), flush=True)
    for scene in args.scenes.split(","):
        for chunk in args.chunks.split(","):
            print(json.dumps(time_cli_run(
                scene, "celllist", extra=("--set", f"sweep_chunk={chunk}"))),
                flush=True)
        print(json.dumps(time_cli_run(scene, "pallas")), flush=True)


if __name__ == "__main__":
    main()
