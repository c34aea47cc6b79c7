"""Command-line entry points.

The reference's only CLI is ``./sph r`` for a headless run
(/root/reference/src/main.cpp:23-28); everything else is the Qt GUI.  Here the
terminal is the interface:

* ``run``    — simulate a scene, stream out/*.txt diagnostics, checkpoints,
               optional GIF render.
* ``bench``  — throughput benchmark (same harness as bench.py).
* ``render`` — render a saved state/checkpoint to PNG.
* ``info``   — print the resolved config for a scene.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .config import SphConfig
from .models import make_scene


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="disk", help="scene name (see models.SCENES)")
    p.add_argument("-n", "--num-particles", type=int, default=None)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "celllist", "pairwise", "pallas", "compat"],
                   help="auto = the Pallas sweeps on a GPU, celllist "
                        "elsewhere and on several devices; celllist and "
                        "pairwise are the plain XLA references")
    p.add_argument("--compat", action="store_true",
                   help="reproduce the C++ reference's quirks (SURVEY.md §2.1)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any SphConfig field, e.g. --set viscosity=0.1")


def _resolve_backend(args) -> None:
    """Resolve ``--backend auto`` (``ops.step.default_backend``)."""
    if getattr(args, "backend", None) != "auto":
        return
    if getattr(args, "compat", False):
        args.backend = "compat"
        return
    if getattr(args, "devices", 0) and args.devices > 1:
        args.backend = "celllist"  # both multi-device engines sweep cell lists
        return
    import jax

    from .ops.step import default_backend

    args.backend = default_backend(jax.devices()[0].platform)


def _apply_overrides(args) -> dict:
    overrides = {}
    if args.num_particles:
        overrides["num_particles"] = args.num_particles
    if args.compat:
        overrides["compat"] = True
    for kv in args.set:
        key, _, value = kv.partition("=")
        field_types = {f.name: f.type for f in SphConfig.__dataclass_fields__.values()}
        if key not in field_types:
            raise SystemExit(f"unknown config field: {key}")
        try:
            overrides[key] = json.loads(value)
        except json.JSONDecodeError:
            overrides[key] = value
    return overrides


def cmd_run(args) -> int:
    import signal

    import jax

    from .state import stack_diagnostics
    from .utils.diagnostics import DiagnosticsWriter, detect_blowup, detect_truncation
    from .utils import io as ckpt_io

    _resolve_backend(args)
    overrides = _apply_overrides(args)
    if args.resume:
        path = ckpt_io.latest_checkpoint(args.checkpoint_dir)
        if path is None:
            raise SystemExit(f"--resume: no checkpoint under {args.checkpoint_dir}")
        start_step, cfg, state = ckpt_io.load_checkpoint(path)
        print(f"resumed from {path} at step {start_step}")
    else:
        if getattr(args, "exact_ic", False):
            if args.scene != "disk":
                raise SystemExit("--exact-ic only applies to the disk scene")
            overrides["exact_ic"] = True
        cfg, state = make_scene(args.scene, **overrides)
        start_step = 0
    cfg.validate()
    if cfg.range_slice == 0:
        # auto candidate-slice: size from this scene's 3-cell occupancy
        from .ops.celllist import derive_range_slice

        cfg = cfg.replace(range_slice=derive_range_slice(cfg, state))
        print(f"derived range_slice={cfg.range_slice}")
    total = (cfg.num_steps + 1) if args.steps is None else args.steps

    from functools import partial

    post_block = None  # slab partition installs a rebalance hook

    if args.devices and args.devices > 1:
        # both multi-device engines run the XLA cell-list sweeps inside each
        # shard — honouring another backend silently would run something
        # the user didn't ask for
        if args.backend != "celllist":
            raise SystemExit(
                f"--devices {args.devices} runs the cell-list sweeps in each "
                f"shard; --backend {args.backend} is single-device only")
        from .parallel import make_mesh

        mesh = make_mesh(args.devices)

        if args.partition == "slab":
            # fully distributed engine: per-device local sort, halo windows,
            # fixed-capacity migration — O(N/D) memory (parallel/slabs.py)
            from .parallel import (collect, derive_slab_caps, derive_zsplit,
                                   distribute, make_slab_step)
            from .parallel.slabs import maybe_rebalance

            zsplit = derive_zsplit(cfg, state, args.devices)
            caps = derive_slab_caps(cfg, state, args.devices, zsplit=zsplit)
            slab_ctx = {"carry": distribute(cfg, state, mesh, caps[0],
                                            zsplit=zsplit),
                        "zsplit": zsplit, "caps": caps}

            def make_run(run_cfg):
                slab_step = make_slab_step(run_cfg, mesh, *slab_ctx["caps"],
                                           zsplit=slab_ctx["zsplit"])
                k = max(args.scan_block, 1)
                slab_scan = (make_slab_step(
                    run_cfg, mesh, *slab_ctx["caps"],
                    zsplit=slab_ctx["zsplit"], scan_block=k)
                    if k > 1 else None)

                def run(s, num_steps):
                    carry = slab_ctx["carry"]
                    diags = []
                    remaining = num_steps
                    while slab_scan is not None and remaining >= k:
                        carry, dk = slab_scan(carry)   # K steps, [K] diags
                        remaining -= k
                        diags.extend(jax.tree.map(lambda x, i=i: x[i], dk)
                                     for i in range(k))
                    for _ in range(remaining):
                        carry, d = slab_step(carry)
                        diags.append(d)
                    slab_ctx["carry"] = carry
                    return (collect(carry, run_cfg.num_particles),
                            stack_diagnostics(diags))
                return run

            def post_block(run_cfg):
                # dynamic re-partition: the t=0 zsplit goes stale when mass
                # re-concentrates; re-derive it from the CURRENT histogram at
                # block boundaries (host-side, recompiles like --apply)
                if not args.rebalance_threshold:
                    return None
                carry2, zs2, caps2, changed = maybe_rebalance(
                    run_cfg, mesh, slab_ctx["carry"], run_cfg.num_particles,
                    threshold=args.rebalance_threshold)
                if not changed:
                    return None
                slab_ctx.update(carry=carry2, zsplit=zs2, caps=caps2)
                print(f"rebalanced slabs: p_cap={caps2[0]} zsplit={zs2}")
                return make_run(run_cfg)
        else:
            from .parallel import make_sharded_step
            from .parallel.sharding import shard_state

            state = shard_state(mesh, state)

            def make_run(run_cfg):
                # host loop, like single-device
                sharded_step = make_sharded_step(run_cfg, mesh)

                def run(s, num_steps):
                    diags = []
                    for _ in range(num_steps):
                        s, d = sharded_step(s)
                        diags.append(d)
                    return s, stack_diagnostics(diags)
                return run
    else:
        from .ops import lazy

        use_lazy = args.lazy
        if use_lazy is None:
            use_lazy = lazy.applies(cfg, args.backend)
        if use_lazy:
            # lazy rebinning (ops.lazy): state stays sorted, bins rebuild only
            # when drift crosses (cell_size - h)/2
            from .ops.lazy import drive_loop_lazy, unsort_carry

            def make_run(run_cfg):
                lazy_ctx = {"carry": None}

                def run(s, num_steps):
                    carry, diags = drive_loop_lazy(
                        run_cfg, s, num_steps, carry=lazy_ctx["carry"],
                        keep_carry=True, scan_block=args.scan_block)
                    lazy_ctx["carry"] = carry
                    return unsort_carry(carry), diags
                return run
        else:
            # host loop with donation, one jitted step per call
            from .ops.step import drive_loop

            def make_run(run_cfg):
                def run(s, num_steps):
                    return drive_loop(run_cfg, s, num_steps, backend=args.backend)
                return run

    run = make_run(cfg)

    # Mid-run parameter apply — the reference's Apply button
    # (/root/reference/src/sphconfig.cpp:76-95 writes gravity/stiffness/
    # viscosity/damping/dt/CFL into the running sim).  Config is static under
    # jit, so applies land at block boundaries and swap in a freshly-compiled
    # step; schedule with --apply STEP:key=value (repeatable).
    pending_applies: dict[int, dict] = {}
    for spec in args.apply or []:
        at, _, kv = spec.partition(":")
        key, _, value = kv.partition("=")
        if key not in SphConfig.__dataclass_fields__:
            raise SystemExit(f"--apply: unknown config field {key!r}")
        try:
            parsed = json.loads(value)
        except json.JSONDecodeError:
            parsed = value
        pending_applies.setdefault(int(at), {})[key] = parsed

    # ctrl-C = checkpoint and exit cleanly (the reference's stop button just
    # drops everything; see SURVEY.md §5 checkpoint/resume)
    interrupted = {"flag": False}

    def on_sigint(signum, frame):
        interrupted["flag"] = True
        print("\ninterrupt: will checkpoint at the end of this block...",
              file=sys.stderr)

    signal.signal(signal.SIGINT, on_sigint)

    # SIGUSR1 = pause/resume in place — the reference's run/pause button
    # (/root/reference/src/sph.cpp:307-312 flips a mutexed flag the sim loop
    # polls each step; here the poll happens at block boundaries, the unit of
    # host control under jit).  `kill -USR1 <pid>` toggles.
    paused = {"flag": False}

    def on_sigusr1(signum, frame):
        paused["flag"] = not paused["flag"]
        print("\npaused — SIGUSR1 again to resume" if paused["flag"]
              else "\nresumed", file=sys.stderr)

    if hasattr(signal, "SIGUSR1"):
        signal.signal(signal.SIGUSR1, on_sigusr1)

    print(f"scene={args.scene} n={cfg.num_particles} steps={total} "
          f"backend={args.backend} devices={jax.devices()[:max(args.devices or 1, 1)]}")
    phase_ms = {}
    if args.profile_phases:
        from .utils.profiling import profile_phases

        phase_ms = profile_phases(cfg, state)
        print("per-phase [ms]: " + "  ".join(
            f"{k}={v:.2f}" for k, v in phase_ms.items()))

    frames = []
    truncation_warned = False
    with DiagnosticsWriter(args.out) as writer:
        ckpt_io.write_run_metadata(args.out, cfg, {"scene": args.scene,
                                                   "backend": args.backend,
                                                   "phase_ms": phase_ms})
        done = start_step
        t_start = time.perf_counter()
        apply_path = os.path.join(args.out, "apply.json")
        while done < total:
            due = sorted(k for k in pending_applies if k <= done)
            if due:
                merged = {}
                for k in due:
                    merged.update(pending_applies.pop(k))
                cfg = cfg.replace(**merged)
                cfg.validate()
                run = make_run(cfg)  # recompile at the block boundary
                print(f"applied at step {done}: "
                      + ", ".join(f"{k}={v}" for k, v in merged.items()))
            if os.path.exists(apply_path):
                # live apply channel — the reference's Apply button writes
                # into the RUNNING sim (/root/reference/src/sphconfig.cpp:
                # 76-95); here the terminal is the UI: drop a JSON object of
                # config fields at <out>/apply.json while the sim runs and it
                # is consumed ONCE at the next block boundary (the unit of
                # host control under jit), then renamed .applied/.rejected.
                try:
                    with open(apply_path) as fh:
                        payload = json.load(fh)
                    if not isinstance(payload, dict):
                        raise ValueError("apply.json must hold a JSON object")
                    unknown = [k for k in payload
                               if k not in SphConfig.__dataclass_fields__]
                    if unknown:
                        raise ValueError(f"unknown config fields: {unknown}")
                    new_cfg = cfg.replace(**payload)
                    new_cfg.validate()
                    cfg = new_cfg
                    run = make_run(cfg)
                    os.replace(apply_path, apply_path + ".applied")
                    print(f"applied at step {done} (apply.json): "
                          + ", ".join(f"{k}={v}" for k, v in payload.items()))
                except Exception as e:
                    os.replace(apply_path, apply_path + ".rejected")
                    print(f"apply.json rejected at step {done}: {e}",
                          file=sys.stderr)
            while paused["flag"] and not interrupted["flag"]:
                time.sleep(0.2)   # paused in place; state stays on device
            nblock = min(args.block, total - done)
            if pending_applies:
                upcoming = min(k for k in pending_applies if k > done)
                nblock = min(nblock, max(upcoming - done, 1))
            t0 = time.perf_counter()
            state, diags = run(state, num_steps=nblock)
            jax.block_until_ready(state)
            dt_ms = (time.perf_counter() - t0) * 1000.0 / nblock
            writer.write_block(done, diags, dict(phase_ms, step=dt_ms))
            bad, why = detect_blowup(diags)
            if bad:
                ckpt_io.save_checkpoint(args.checkpoint_dir, done + nblock, cfg, state)
                print(f"ABORT at step {done + nblock}: {why} (checkpoint saved)",
                      file=sys.stderr)
                return 2
            lossy, what = detect_truncation(diags)
            if lossy and not truncation_warned:
                truncation_warned = True
                print(f"WARNING at step {done + nblock}: {what} — "
                      "interactions are being dropped", file=sys.stderr)
            done += nblock
            if post_block is not None and done < total:
                new_run = post_block(cfg)
                if new_run is not None:
                    run = new_run
            if interrupted["flag"]:
                p = ckpt_io.save_checkpoint(args.checkpoint_dir, done, cfg, state)
                print(f"interrupted at step {done}; checkpoint saved to {p}")
                return 130
            if args.checkpoint_every and (done % args.checkpoint_every) < nblock:
                ckpt_io.save_checkpoint(args.checkpoint_dir, done, cfg, state)
            if args.render and (done % args.render_every) < nblock:
                from .utils.render import render_frame

                frames.append(render_frame(cfg, state))
            if args.live_term:
                # in-terminal repaint (reference: visualization.cpp:24-33
                # repaints the GL pane on a timer while the sim thread runs);
                # here the terminal is the display: clear + home + half-block
                # splat every block boundary
                import shutil

                from .utils.render import ansi_frame, render_frame

                tcols, tlines = shutil.get_terminal_size((80, 26))
                frame = ansi_frame(render_frame(cfg, state, size=256),
                                   cols=min(tcols, 160),
                                   rows=max(min(tlines - 2, 60), 4))
                sys.stdout.write("\x1b[2J\x1b[H" + frame
                                 + f"\nstep {done}/{total}\n")
                sys.stdout.flush()
            if args.live:
                # the reference repaints at 60 FPS while the sim runs
                # (/root/reference/src/visualization.cpp:24-33); here the
                # latest frame is re-rendered every block and swapped in
                # atomically — point any image viewer/watcher at the file
                from .utils.render import render_frame, save_png

                tmp = args.live + ".tmp.png"  # suffix keeps the encoder happy
                save_png(render_frame(cfg, state), tmp)
                os.replace(tmp, args.live)
            if not args.quiet:
                pps = cfg.num_particles * nblock / max(time.perf_counter() - t0, 1e-9)
                print(f"step {done}/{total}  {dt_ms:.2f} ms/step  "
                      f"{pps:.3e} particle-steps/s")
        elapsed = time.perf_counter() - t_start
    ckpt_io.save_state(f"{args.out}/final_state.npz", state)
    if frames:
        from .utils.render import save_gif

        save_gif(frames, f"{args.out}/sph_anim.gif")
        print(f"wrote {args.out}/sph_anim.gif ({len(frames)} frames)")
    print(f"done: {total - start_step} steps in {elapsed:.1f}s; "
          f"diagnostics in {args.out}/")
    return 0


def cmd_bench(args) -> int:
    from .ops import lazy as lazy_driver
    from .utils.benchmark import run_benchmark

    _resolve_backend(args)
    overrides = _apply_overrides(args)
    lazy = args.lazy
    if lazy is None:
        cfg, _ = make_scene(args.scene, **overrides)
        lazy = lazy_driver.applies(cfg, args.backend)
    result = run_benchmark(scene=args.scene, backend=args.backend,
                           steps=args.steps or 100, warmup=args.warmup,
                           overrides=overrides, lazy=lazy)
    print(json.dumps(result))
    return 0


def cmd_sweep(args) -> int:
    """Viscosity x stiffness regime sweep (BASELINE config 4).

    The reference's parameters were tuned by watching the render —
    "1e+1~2 == nice disk formation" (/root/reference/src/sph.cpp:77); this
    harness makes the regime map a measured artifact: each grid cell runs
    ``--steps`` steps and reports the blow-up step (if any), relative energy
    drift, and mean neighbor count.  One JSON line per cell + a final table.
    """
    import itertools

    import jax
    import numpy as np

    from .ops import lazy
    from .ops.step import drive_loop
    from .utils.diagnostics import detect_blowup

    _resolve_backend(args)
    overrides = _apply_overrides(args)
    mus = [float(x) for x in args.viscosity.split(",")]
    ks = [float(x) for x in args.stiffness.split(",")]
    rows = []
    for mu, k in itertools.product(mus, ks):
        cfg, state = make_scene(args.scene, **{**overrides, "viscosity": mu,
                                               "stiffness": k})
        cfg.validate()
        use_lazy = lazy.applies(cfg, args.backend)
        if cfg.range_slice == 0:
            from .ops.celllist import derive_range_slice

            cfg = cfg.replace(range_slice=derive_range_slice(cfg, state))

        done = 0
        blowup_step = None
        e0 = e_last = nmean = None
        carry = None
        st = state
        while done < args.steps and blowup_step is None:
            nblock = min(args.block, args.steps - done)
            if use_lazy:
                carry, diags = lazy.drive_loop_lazy(cfg, st, nblock,
                                                    carry=carry,
                                                    keep_carry=True)
            else:
                st, diags = drive_loop(cfg, st, nblock, backend=args.backend)
            ke = np.asarray(diags.kinetic_energy)
            pe = np.asarray(diags.potential_energy)
            tot = ke + pe
            if e0 is None:
                e0 = float(tot[0])
            e_last = float(tot[-1])
            nmean = float(np.asarray(diags.neighbor_mean)[-1])
            bad, why = detect_blowup(diags)
            if bad:
                off = int(np.argmax(~np.isfinite(tot))) if (~np.isfinite(tot)).any() else nblock - 1
                blowup_step = done + off
            done += nblock
        drift = (abs(e_last - e0) / max(abs(e0), 1e-30)
                 if blowup_step is None else float("nan"))
        row = {"viscosity": mu, "stiffness": k, "steps": done,
               "blowup_step": blowup_step, "energy_drift": drift,
               "neighbor_mean": nmean, "stable": blowup_step is None}
        rows.append(row)
        print(json.dumps(row), flush=True)

    print(f"\n{args.scene} n={overrides.get('num_particles', 'default')} "
          f"steps={args.steps} backend={args.backend}")
    print(f"{'viscosity':>10} {'stiffness':>10} {'stable':>7} "
          f"{'blowup@':>8} {'E-drift':>10} {'nmean':>7}")
    for r in rows:
        print(f"{r['viscosity']:>10g} {r['stiffness']:>10g} "
              f"{str(r['stable']):>7} "
              f"{str(r['blowup_step'] or '-'):>8} "
              f"{r['energy_drift']:>10.3g} {r['neighbor_mean']:>7.2f}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=2)
        print(f"wrote {args.out}")
    return 0


def cmd_render(args) -> int:
    from .init import load_state
    from .utils.render import render_frame, render_frame_perspective, save_png

    cfg, _ = make_scene(args.scene, **_apply_overrides(args))
    state = load_state(args.state)
    if args.perspective or args.camera:
        cam = {}
        if args.camera:
            try:
                az, el, dist = (float(v) for v in args.camera.split(","))
            except ValueError:
                raise SystemExit("--camera expects AZ,EL,DIST "
                                 "(e.g. --camera 135,0.6,1.8)")
            cam = dict(azimuth=az, elevation=el, distance=dist)
        img = render_frame_perspective(cfg, state, box=not args.no_box, **cam)
    else:
        img = render_frame(cfg, state, voxels=args.voxels)
    save_png(img, args.output)
    print(f"wrote {args.output}")
    return 0


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(vals, width: int = 48) -> str:
    """Last ``width`` values as a unicode sparkline (constant series -> ▁).

    Non-finite values render as the top glyph instead of crashing: a run
    that blows up writes NaN rows to diagnostics.jsonl before the abort
    path fires, and ``watch`` must keep working exactly then.
    """
    import math

    vals = list(vals)[-width:]
    if not vals:
        return ""
    finite = [v for v in vals if math.isfinite(v)]
    if not finite:
        return _SPARK[-1] * len(vals)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    if span <= 0:
        return "".join(_SPARK[-1] if not math.isfinite(v) else _SPARK[0]
                       for v in vals)
    return "".join(_SPARK[-1] if not math.isfinite(v)
                   else _SPARK[min(int((v - lo) / span * 8), 7)]
                   for v in vals)


def cmd_watch(args) -> int:
    """Live terminal dashboard over a run's diagnostics.jsonl.

    The reference's main window shows a per-step timing panel plus live
    energy behavior while the sim thread runs (/root/reference/src/
    widget.cpp:91-111, main.cpp:39-45); ``watch`` is that panel for a
    headless host: point it at the --out directory of a running (or
    finished) sim and it repaints sparklines of energy drift, |L|, step
    time and neighbor stats every --interval seconds.
    """
    import math

    path = os.path.join(args.out, "diagnostics.jsonl")
    last_n = 0
    rows: list = []
    offset = 0
    try:
      while True:
        # incremental tail-read: only parse bytes appended since last tick
        # (a full re-parse is O(file) per tick — quadratic over a long run)
        try:
            with open(path) as fh:
                fh.seek(offset)
                chunk = fh.read()
        except FileNotFoundError:
            if args.once:
                print(f"no diagnostics at {path}", file=sys.stderr)
                return 1
            time.sleep(args.interval)
            continue
        # consume only complete lines; a mid-write tail line stays unread
        # until its newline lands
        complete, sep, _tail = chunk.rpartition("\n")
        offset += len((complete + sep).encode())
        for ln in complete.splitlines():
            ln = ln.strip()
            if ln:
                try:
                    rows.append(json.loads(ln))
                except json.JSONDecodeError:
                    pass  # torn row
        if rows:
            r = rows[-1]
            e0 = rows[0]["total_energy"]
            drift = [(x["total_energy"] - e0) / abs(e0)
                     if (e0 and math.isfinite(e0)) else 0.0
                     for x in rows]
            lines = [
                f"watch {args.out}  step {r['step']}  "
                f"{r['step_ms']:.2f} ms/step  rows {len(rows)}"
                + ("" if len(rows) > last_n else "  (idle)"),
                f"E_total {r['total_energy']:.6e}  "
                f"drift {drift[-1]:+.3e}  {_sparkline(drift)}",
                f"|L|     {r['angular_momentum']:.6e}  "
                f"{_sparkline([x['angular_momentum'] for x in rows])}",
                f"step_ms {r['step_ms']:8.2f}       "
                f"{_sparkline([x['step_ms'] for x in rows])}",
                f"nbr mean {r['neighbor_mean']:7.2f}  "
                f"max {r['neighbor_max']}  min {r['neighbor_min']}  "
                f"{_sparkline([x['neighbor_mean'] for x in rows])}",
            ]
            bad = {k: r[k] for k in ("overflow_cells", "truncated_ranges",
                                     "halo_dropped", "migration_dropped")
                   if r.get(k)}
            if bad:
                lines.append("WARN " + "  ".join(f"{k}={v}"
                                                 for k, v in bad.items()))
            prefix = "" if args.once else "\x1b[2J\x1b[H"
            print(prefix + "\n".join(lines), flush=True)
            last_n = len(rows)
        if args.once:
            return 0
        time.sleep(args.interval)
    except KeyboardInterrupt:
        print()  # clean exit, no traceback from the sleep
        return 0


def cmd_info(args) -> int:
    cfg, state = make_scene(args.scene, **_apply_overrides(args))
    print(cfg.to_json())
    return 0


def cmd_parity(args) -> int:
    """Step the compat pipeline from a golden dump and report per-step errors."""
    import glob

    import jax
    import numpy as np
    from functools import partial

    from .compat import golden as G
    from .compat.step import compat_step
    from .state import ParticleState

    files = sorted(glob.glob(f"{args.golden}/state_*.bin"))
    if len(files) < 2:
        raise SystemExit(f"need >= 2 golden dumps under {args.golden} "
                         "(generate with tools/build_reference.sh + golden_gen)")
    g0 = G.load_golden(files[0])
    cfg = SphConfig(num_particles=g0.n, cell_capacity=args.cell_capacity)
    step_fn = jax.jit(partial(compat_step, cfg))
    state = ParticleState.from_arrays(g0.position, g0.velocity, mass=g0.mass)

    worst = 0.0
    for path in files[1:args.steps + 1 if args.steps else None]:
        state, _ = step_fn(state)
        g = G.load_golden(path)
        rho = np.asarray(state.density)
        l2 = float(np.linalg.norm(rho - g.density)
                   / max(np.linalg.norm(g.density), 1e-30))
        nc_ok = (np.asarray(state.neighbor_count) == g.neighbor_count).mean()
        pos_l2 = float(np.linalg.norm(np.asarray(state.position) - g.position)
                       / np.linalg.norm(g.position))
        worst = max(worst, l2)
        print(f"{path}: density_L2={l2:.3e} pos_L2={pos_l2:.3e} "
              f"neighbor_count_match={nc_ok:.4f}")
    target = 1e-3
    print(f"worst density L2 = {worst:.3e}  (north-star target <= {target:g}): "
          f"{'PASS' if worst <= target else 'FAIL'}")
    return 0 if worst <= target else 1


def main(argv=None) -> int:
    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    ap = argparse.ArgumentParser("sph-tpu", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run a simulation")
    _add_common(p)
    p.add_argument("--steps", type=int, default=None,
                   help="override step count (default: cfg.num_steps+1 like the reference)")
    p.add_argument("--out", default="out")
    p.add_argument("--block", type=int, default=50, help="steps per scan block")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--render", action="store_true", help="accumulate GIF frames")
    p.add_argument("--render-every", type=int, default=10)
    p.add_argument("--live", default="",
                   help="re-render the CURRENT state to this PNG every "
                        "block (atomic swap) — the reference's live "
                        "repaint loop, viewer-poll style")
    p.add_argument("--live-term", action="store_true",
                   help="repaint the particle splat IN the terminal every "
                        "block (ANSI half-blocks) — the reference's live "
                        "GL view for a headless host")
    p.add_argument("--devices", type=int, default=0,
                   help="run sharded over the first N devices (0 = single)")
    p.add_argument("--rebalance-threshold", type=float, default=1.5,
                   help="slab partition: re-derive the z-split at block "
                        "boundaries when per-device load imbalance (max/mean "
                        "count) exceeds this ratio; 0 disables")
    p.add_argument("--partition", default="slab", choices=["slab", "halo"],
                   help="multi-device decomposition: 'slab' (default) = "
                        "fully distributed engine with local sort + "
                        "migration at O(N/D) memory (parallel/slabs.py); "
                        "'halo' = the row-sharded verification oracle whose "
                        "binning runs REPLICATED on every device — it "
                        "cannot weak-scale and exists for cross-checking "
                        "the slab engine")
    p.add_argument("--profile-phases", action="store_true",
                   help="measure per-phase times once (reference timing.txt columns)")
    p.add_argument("--exact-ic", action="store_true",
                   help="disk scene: start from the reference's srand(42) "
                        "initial state bit-for-bit (compat/exact_ic.py)")
    p.add_argument("--apply", action="append", default=[],
                   metavar="STEP:KEY=VALUE",
                   help="apply a config change mid-run at a step boundary "
                        "(the reference's Apply button; repeatable), e.g. "
                        "--apply 500:viscosity=0.1")
    p.add_argument("--lazy", action=argparse.BooleanOptionalAction, default=None,
                   help="lazy rebinning driver (default: auto — on for the "
                        "pallas backend in default mode)")
    p.add_argument("--scan-block", type=int, default=0,
                   help="steps per dispatch via lax.scan (lazy driver AND "
                        "slab engine) — dispatch amortization for small "
                        "scenes; 0 = host loop")
    p.add_argument("--quiet", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="throughput benchmark")
    _add_common(p)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--warmup", type=int, default=10)
    p.add_argument("--lazy", action=argparse.BooleanOptionalAction, default=None,
                   help="lazy rebinning driver (default: auto — on for the "
                        "pallas backend in default mode)")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("sweep", help="viscosity x stiffness regime sweep "
                                     "(BASELINE config 4)")
    _add_common(p)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--block", type=int, default=50)
    p.add_argument("--viscosity", default="0.01,0.1,1,10",
                   help="comma-separated mu grid")
    p.add_argument("--stiffness", default="1e-4,1e-3,1e-2",
                   help="comma-separated k grid")
    p.add_argument("--out", default="",
                   help="write the sweep records to this JSON file")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("render", help="render a saved state to PNG")
    _add_common(p)
    p.add_argument("state", help="path to .npz state/checkpoint")
    p.add_argument("-o", "--output", default="frame.png")
    p.add_argument("--perspective", action="store_true",
                   help="3-D perspective camera (reference GL frustum+lookAt "
                        "analog) instead of the orthographic projection")
    p.add_argument("--camera", default="", metavar="AZ,EL,DIST",
                   help="perspective view controls: azimuth degrees around "
                        "+y (180 = default -z view), elevation (fraction of "
                        "the box span), eye distance (box spans) — the "
                        "reference's resizeGL/lookAt knobs "
                        "(visualization.cpp:341-362); implies --perspective")
    p.add_argument("--no-box", action="store_true",
                   help="perspective view: skip the wireframe box outline "
                        "(the reference's drawBox, visualization.cpp:64-134)")
    p.add_argument("--voxels", action="store_true",
                   help="overlay occupied grid cells in red, intensity "
                        "proportional to occupancy (the reference's "
                        "drawVoxels checkbox, visualization.cpp:166-213)")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("info", help="print resolved scene config")
    _add_common(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("watch", help="live terminal dashboard over a run's "
                                     "diagnostics.jsonl (the reference's "
                                     "main-window timing/energy panel)")
    p.add_argument("--out", default="out", help="run output directory")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--once", action="store_true",
                   help="print one snapshot and exit (no repaint loop)")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("parity", help="compare compat pipeline vs golden dumps")
    p.add_argument("golden", help="directory of tools/golden_gen state dumps")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--cell-capacity", type=int, default=64)
    p.set_defaults(fn=cmd_parity)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
