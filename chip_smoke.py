#!/usr/bin/env python
"""Smoke test of the SPH engine on one GPU (``--four``: on four GPUs).

Phases, in order; any failure exits non-zero before the result line:

1. the card (nvidia-smi name and power limit) and JAX's devices; stop
   unless JAX runs on a GPU;
2. build ``native/libsphio.so`` (``make -C native``) and report whether the
   native IO writer is used;
3. the main path through ``cli run`` with ``--backend auto``: the 1M splash
   and the reference's full workload (disk 32k x 1001 steps, |L| drift
   <= 1e-3); no abort, finite diagnostics, no truncated or overflowing
   cells, ``final_state.npz`` written;
4. the Pallas sweeps against the plain references at real widths: splash
   1M and dam_break 100k against ``celllist``, disk 16k against
   ``pairwise`` (the largest disk whose [N, N, 3] pair tensors fit);
5. ms/step of ``cli run`` with the Pallas sweeps against the XLA cell-list
   sweeps, and the step's ``memory_analysis()``.

``--four`` runs only the slab engine on 4 cards (``cli run --devices 4``,
dam_break_10m) against the single-card run of the same scene in this one
process, and checks each card's memory.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--four]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a) -> None:
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def phase_device(count: int):
    import jax

    from smoothed_particle_hydrodynamics_tpu.utils.benchmark import (
        card_name_power)

    card = card_name_power()
    check(card is not None, "nvidia-smi reports no card")
    devices = jax.devices()
    d = devices[0]
    log(f"[1] card: {card}")
    log(f"[1] jax: platform={d.platform} kind={d.device_kind} "
        f"count={len(devices)} {devices}")
    check(d.platform == "gpu", f"JAX runs on {d.platform!r}, not a GPU")
    check(len(devices) >= count, f"need {count} GPUs, found {len(devices)}")
    return card, {"platform": d.platform, "kind": d.device_kind,
                  "count": count}


def phase_native() -> None:
    out = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"make -C native: {out.stderr[-2000:]}")
    from smoothed_particle_hydrodynamics_tpu.utils import native

    log(f"[2] native/libsphio.so built; native IO used: {native.have_native()}")


def run_cli(out: str, *args: str) -> list[dict]:
    """One ``cli run``; returns its diagnostics rows after the common checks."""
    import numpy as np

    from smoothed_particle_hydrodynamics_tpu.cli import main
    from smoothed_particle_hydrodynamics_tpu.utils.benchmark import read_run

    t0 = time.perf_counter()
    rc = main(["run", "--out", out, "--quiet", *args])
    log(f"    cli run {' '.join(args)}: rc={rc} "
        f"in {time.perf_counter() - t0:.1f}s")
    check(rc == 0, f"cli run {args} exited {rc}")
    rows = read_run(out)
    check(len(rows) > 0, "no diagnostics rows")
    for key in ("kinetic_energy", "potential_energy", "angular_momentum",
                "neighbor_mean"):
        check(bool(np.isfinite([r[key] for r in rows]).all()),
              f"non-finite {key}")
    for key in ("overflow_cells", "truncated_ranges", "halo_dropped",
                "migration_dropped"):
        check(all(r[key] == 0 for r in rows), f"{key} != 0")
    check(os.path.exists(os.path.join(out, "final_state.npz")),
          "final_state.npz missing")
    return rows


def phase_main_path(tmp: str) -> None:
    rows = run_cli(os.path.join(tmp, "splash"), "--scene", "splash",
                   "--steps", "40", "--block", "20")
    log(f"[3] splash 1M x 40: backend auto, last step "
        f"{rows[-1]['step_ms']:.2f} ms/step, neighbor mean "
        f"{rows[-1]['neighbor_mean']:.2f}")
    rows = run_cli(os.path.join(tmp, "disk"), "--scene", "disk")
    l0, l1 = rows[0]["angular_momentum"], rows[-1]["angular_momentum"]
    drift = abs(l1 - l0) / abs(l0)
    log(f"[3] disk 32k x {len(rows)}: |L| drift {drift:.3e} "
        f"(bound 1e-3), last step {rows[-1]['step_ms']:.2f} ms/step")
    check(len(rows) == 1001, f"disk ran {len(rows)} steps, not 1001")
    check(drift <= 1e-3, f"|L| drift {drift:.3e} > 1e-3")


def phase_parity() -> None:
    from smoothed_particle_hydrodynamics_tpu.utils.benchmark import (
        GPU_PARITY_CASES, run_parity_check)

    # the bodies of tests/test_gpu.py, which skip off the card
    for scene, n, ref in GPU_PARITY_CASES:
        res = run_parity_check(n=n, scene=scene, reference=ref)
        log(f"[4] parity {json.dumps(res)}")
        check(res["pass"], f"parity {scene} {n} vs {ref}")


def phase_timing(card: str) -> None:
    from functools import partial

    import jax

    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu.ops import lazy
    from smoothed_particle_hydrodynamics_tpu.utils.benchmark import (
        time_cli_run)

    # XLA at its default chunk and at its fastest (one chunk, PERF.md)
    for scene in ("splash", "disk"):
        for backend, extra in (("pallas", ()), ("celllist", ()),
                               ("celllist", ("--set", "sweep_chunk=0"))):
            res = time_cli_run(scene, backend, extra=extra)
            log(f"[5] {card}: {json.dumps(res)}")
    cfg, state = make_scene("splash")
    carry = jax.jit(partial(lazy.init_lazy, cfg))(state)
    compiled = jax.jit(partial(lazy.lazy_step, cfg)).lower(carry).compile()
    log(f"[5] splash 1M lazy step (the auto path) memory_analysis: "
        f"{compiled.memory_analysis()}")


def phase_four(tmp: str) -> None:
    import jax

    steps = ["--scene", "dam_break_10m", "--steps", "10", "--block", "10"]
    slab = run_cli(os.path.join(tmp, "slab4"), *steps, "--devices", "4",
                   "--partition", "slab")
    peaks = [d.memory_stats()["peak_bytes_in_use"] for d in jax.devices()[:4]]
    log(f"[4x] slab engine on 4 cards: peak bytes per card {peaks}")
    check(min(peaks) >= 0.2 * max(peaks),
          "the slab store is not spread over the 4 cards")
    single = run_cli(os.path.join(tmp, "single"), *steps)
    a, b = slab[-1], single[-1]

    def rel(key):
        return abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)

    res = {"kinetic_energy_rel": rel("kinetic_energy"),
           "angular_momentum_rel": rel("angular_momentum"),
           "neighbor_mean_abs": abs(a["neighbor_mean"] - b["neighbor_mean"]),
           "slab_ms_per_step": a["step_ms"], "single_ms_per_step": b["step_ms"]}
    log(f"[4x] slab (4 cards) vs single card after 10 steps: "
        f"{json.dumps(res)}")
    check(res["kinetic_energy_rel"] <= 1e-3, "KE differs")
    check(res["angular_momentum_rel"] <= 1e-3, "|L| differs")
    check(res["neighbor_mean_abs"] <= 1e-2, "neighbor mean differs")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card slab engine and its "
                         "single-card comparison")
    args = ap.parse_args()
    # the package must come from this checkout, never from an installation
    check(os.path.isdir(os.path.join(REPO, "smoothed_particle_hydrodynamics_tpu")),
          f"no smoothed_particle_hydrodynamics_tpu package beside {__file__}")
    sys.path.insert(0, REPO)
    from smoothed_particle_hydrodynamics_tpu.utils.cache import (
        enable_compile_cache)

    enable_compile_cache()
    card, device = phase_device(4 if args.four else 1)
    with tempfile.TemporaryDirectory() as tmp:
        if args.four:
            phase_four(tmp)
        else:
            phase_native()
            phase_main_path(tmp)
            phase_parity()
            phase_timing(card)
    log(card)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
