"""Throughput benchmark and on-device parity harness.

Every result names the device it ran on (``device_info``).  A measurement
of the device fails without a GPU (``require_gpu``); nothing falls back to
the CPU under a device metric's name.  Steps are fenced with
``jax.block_until_ready``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import time

import jax
import numpy as np

from ..models import make_scene


def require_gpu() -> jax.Device:
    """The first device, which must be a GPU."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise RuntimeError(f"this measurement needs a GPU; JAX found "
                           f"{device.platform!r} ({device.device_kind})")
    return device


def card_name_power() -> str | None:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_info() -> dict:
    """The device a result was measured on, as JAX and nvidia-smi see it."""
    device = jax.devices()[0]
    return {"platform": device.platform, "kind": device.device_kind,
            "count": len(jax.devices()), "card": card_name_power()}


def run_benchmark(scene: str = "disk", backend: str = "celllist",
                  steps: int = 100, warmup: int = 10,
                  overrides: dict | None = None, lazy: bool = False) -> dict:
    """Steady-state particle-steps/s of the single-device drivers."""
    from ..ops.step import drive_loop

    if lazy and backend != "pallas":
        # the lazy driver always runs the pallas sweeps; accepting another
        # backend name here would record a row labeled with an engine that
        # never executed
        raise ValueError(f"lazy=True benchmarks the pallas backend; got "
                         f"backend={backend!r}")
    cfg, state = make_scene(scene, **(overrides or {}))

    if lazy:
        from ..ops.lazy import drive_loop_lazy

        def advance(st_or_carry, n, first=False):
            return drive_loop_lazy(cfg, st_or_carry if first else None, n,
                                   collect_diags=False, keep_carry=True,
                                   carry=None if first else st_or_carry)[0]
    else:
        def advance(st, n, first=False):
            return drive_loop(cfg, st, n, backend=backend,
                              collect_diags=False)[0]

    t0 = time.perf_counter()
    state = jax.block_until_ready(advance(state, max(warmup, 1), first=True))
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    state = jax.block_until_ready(advance(state, steps))
    elapsed = time.perf_counter() - t0

    n = cfg.num_particles
    return {
        "metric": "particle-steps/s",
        "value": n * steps / elapsed,
        "scene": scene,
        "backend": backend,
        "lazy": lazy,
        "num_particles": n,
        "steps": steps,
        "ms_per_step": elapsed * 1000.0 / steps,
        "warmup_s": compile_s,
        "device": device_info(),
    }


def run_slab_benchmark(n: int = 1_000_000, steps: int = 15, warmup: int = 3,
                       headroom: float = 1.05,
                       overrides: dict | None = None,
                       scan_block: int = 0) -> dict:
    """Distributed slab engine on a 1-device mesh of the current device:
    the per-device cost of the local sort + halo/migration machinery."""
    from jax.sharding import Mesh

    from ..parallel import slabs

    ov = dict(num_particles=n, cell_size_factor=1.25)
    ov.update(overrides or {})
    cfg, state = make_scene("splash", **ov)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    zsplit = slabs.derive_zsplit(cfg, state, 1)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 1, zsplit=zsplit,
                                                 headroom=headroom)
    carry = slabs.distribute(cfg, state, mesh, p_cap, zsplit=zsplit)
    step = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap,
                                zsplit=zsplit, donate=True,
                                scan_block=scan_block)
    k = max(scan_block, 1)

    t0 = time.perf_counter()
    for _ in range(max(-(-warmup // k), 1)):
        carry, diag = step(carry)
    jax.block_until_ready(carry)
    compile_s = time.perf_counter() - t0

    calls = max(steps // k, 1)
    t0 = time.perf_counter()
    for _ in range(calls):
        carry, diag = step(carry)
    jax.block_until_ready(carry)
    elapsed = time.perf_counter() - t0
    steps_run = calls * k
    return {
        "metric": "slab-engine particle-steps/s (1-device mesh)",
        "value": n * steps_run / elapsed,
        "ms_per_step": elapsed * 1000.0 / steps_run,
        "num_particles": n,
        "steps": steps_run,
        "scan_block": scan_block,
        "p_cap": p_cap, "h_cap": h_cap, "m_cap": m_cap,
        "rebins": int(np.asarray(carry.rebin_count)[0]),
        "migration_dropped": int(np.ravel(diag.migration_dropped)[-1]),
        "halo_dropped": int(np.ravel(diag.halo_dropped)[-1]),
        "warmup_s": compile_s,
        "device": device_info(),
    }


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# (scene, n, reference) of the on-card parity checks at real widths; disk
# 16k is the largest disk whose [N, N, 3] pairwise tensors fit one card
GPU_PARITY_CASES = (("splash", 1_000_000, "celllist"),
                    ("dam_break", 100_000, "celllist"),
                    ("disk", 16384, "pairwise"))


def run_parity_check(n: int = 32768, scene: str = "disk",
                     reference: str = "celllist", interpret: bool = False,
                     overrides: dict | None = None) -> dict:
    """The pallas sweeps against a plain XLA reference on one state.

    Compiled for the GPU unless ``interpret`` (the CPU tests); without a GPU
    and without ``interpret`` it raises.  Bounds: density rel-L2 <= 1e-5,
    acceleration rel-L2 <= 1e-4 (f32 sums in another order), identical
    neighbor counts.
    """
    from functools import partial

    from ..ops.step import compute_forces

    if not interpret:
        require_gpu()
    cfg, state = make_scene(scene, num_particles=n, pallas_interpret=interpret,
                            **(overrides or {}))
    acc_p, rho_p, aux_p = jax.jit(partial(compute_forces, cfg,
                                          backend="pallas"))(state)
    acc_c, rho_c, aux_c = jax.jit(partial(compute_forces, cfg,
                                          backend=reference))(state)
    nc_equal = bool((np.asarray(aux_p.neighbor_count)
                     == np.asarray(aux_c.neighbor_count)).all())
    rho_l2 = rel_l2(rho_p, rho_c)
    acc_l2 = rel_l2(acc_p, acc_c)
    return {
        "n": n,
        "scene": scene,
        "reference": reference,
        "interpret": interpret,
        "neighbor_mean": float(np.asarray(aux_c.neighbor_count).mean()),
        "neighbor_counts_equal": nc_equal,
        "rho_rel_l2": rho_l2,
        "acc_rel_l2": acc_l2,
        "pass": nc_equal and rho_l2 <= 1e-5 and acc_l2 <= 1e-4,
    }


def read_run(out_dir: str) -> list[dict]:
    """The per-step rows a ``cli run`` wrote to ``diagnostics.jsonl``."""
    with open(os.path.join(out_dir, "diagnostics.jsonl")) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def time_cli_run(scene: str, backend: str, blocks: int = 5, block: int = 10,
                 extra: tuple[str, ...] = ()) -> dict:
    """Median ms/step of ``cli run`` end to end.

    ``cli run`` times each block of ``block`` steps; the first block
    (compilation included) is dropped and the median is over the per-step
    rows of the next ``blocks`` blocks.
    """
    from ..cli import main

    with tempfile.TemporaryDirectory() as out:
        rc = main(["run", "--scene", scene, "--backend", backend,
                   "--steps", str((blocks + 1) * block), "--block", str(block),
                   "--out", out, "--quiet", *extra])
        if rc != 0:
            raise RuntimeError(f"cli run {scene} {backend} exited {rc}")
        ms = [r["step_ms"] for r in read_run(out)][block:]
    return {"scene": scene, "backend": backend, "extra": list(extra),
            "steps": len(ms), "median_ms": float(np.median(ms)),
            "q1_ms": float(np.percentile(ms, 25)),
            "q3_ms": float(np.percentile(ms, 75))}
