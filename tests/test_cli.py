"""CLI smoke tests (CPU, tiny scenes)."""

import json
import os

import pytest

from smoothed_particle_hydrodynamics_tpu.cli import main

# End-to-end / compiled-kernel tests: minutes each on the virtual CPU
# mesh.  Excluded from the default lane (pyproject addopts -m "not slow");
# run the full lane with:  pytest -q -m ""  (see README Testing).
pytestmark = pytest.mark.slow


def test_info():
    assert main(["info", "--scene", "disk", "-n", "512"]) == 0


def test_run_and_resume(tmp_path, capsys):
    out = str(tmp_path / "out")
    ck = str(tmp_path / "ck")
    rc = main(["run", "--scene", "disk", "-n", "512", "--steps", "4",
               "--block", "2", "--out", out, "--checkpoint-every", "2",
               "--checkpoint-dir", ck, "--quiet"])
    assert rc == 0
    assert os.path.exists(f"{out}/energy.txt")
    assert os.path.exists(f"{out}/final_state.npz")
    meta = json.load(open(f"{out}/run.json"))
    assert meta["config"]["num_particles"] == 512

    out2 = str(tmp_path / "out2")
    rc = main(["run", "--resume", "--checkpoint-dir", ck, "--steps", "6",
               "--block", "2", "--out", out2, "--quiet"])
    assert rc == 0
    first = open(f"{out2}/energy.txt").read().splitlines()[1]
    assert first.startswith("4, ")  # resumed at step 4


def test_run_multidevice(tmp_path):
    out = str(tmp_path / "outs")
    rc = main(["run", "--scene", "disk", "-n", "512", "--steps", "2",
               "--block", "2", "--out", out, "--devices", "4", "--quiet"])
    assert rc == 0
    assert os.path.exists(f"{out}/energy.txt")


def test_bench_json(capsys):
    rc = main(["bench", "--scene", "disk", "-n", "512", "--steps", "3",
               "--warmup", "1"])
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    data = json.loads(line)
    assert data["metric"] == "particle-steps/s"
    assert data["device"]["platform"] == "cpu"
    assert data["value"] > 0


def test_render_cmd(tmp_path):
    out = str(tmp_path / "o")
    main(["run", "--scene", "disk", "-n", "512", "--steps", "2",
          "--block", "2", "--out", out, "--quiet"])
    png = str(tmp_path / "f.png")
    rc = main(["render", f"{out}/final_state.npz", "-o", png,
               "--scene", "disk", "-n", "512"])
    assert rc == 0 and os.path.getsize(png) > 100
    # the reference's drawVoxels checkbox (visualization.cpp:166-213):
    # occupied cells overlaid in red -> RGB png, strictly more bytes than L
    vox = str(tmp_path / "v.png")
    rc = main(["render", f"{out}/final_state.npz", "-o", vox, "--voxels",
               "--scene", "disk", "-n", "512"])
    assert rc == 0 and os.path.getsize(vox) > 100
    # RGB voxel overlay must actually be bigger than the greyscale render —
    # a regression that silently ignores --voxels would fail this
    assert os.path.getsize(vox) > os.path.getsize(png)


def test_unknown_field_rejected():
    with pytest.raises(SystemExit):
        main(["run", "--set", "bogus=1"])


def test_run_mid_run_apply(tmp_path, capsys):
    """--apply STEP:key=value swaps config at a block boundary (the
    reference's Apply button, src/sphconfig.cpp:76-95)."""
    out = str(tmp_path / "outa")
    rc = main(["run", "--scene", "disk", "-n", "512", "--steps", "6",
               "--block", "4", "--out", out,
               "--apply", "3:viscosity=0.5", "--quiet"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "applied at step 3: viscosity=0.5" in text
    # blocks split at the apply boundary and the run still completes
    rows = open(f"{out}/energy.txt").read().splitlines()
    assert rows[-1].startswith("5, ")


def test_run_live_apply_channel(tmp_path, capsys):
    """Dropping <out>/apply.json while the sim runs edits the RUNNING config
    at the next block boundary — the reference's Apply button without
    pre-scheduling (src/sphconfig.cpp:76-95).  The file is consumed once;
    a bad payload is rejected without killing the run."""
    out = str(tmp_path / "outlive")
    os.makedirs(out, exist_ok=True)
    # pre-placed file: consumed at the FIRST block boundary (step 0)
    with open(f"{out}/apply.json", "w") as fh:
        json.dump({"viscosity": 0.25}, fh)
    rc = main(["run", "--scene", "disk", "-n", "512", "--steps", "4",
               "--block", "2", "--out", out, "--quiet"])
    assert rc == 0
    text = capsys.readouterr().out
    assert "applied at step 0 (apply.json): viscosity=0.25" in text
    assert os.path.exists(f"{out}/apply.json.applied")
    assert not os.path.exists(f"{out}/apply.json")

    # rejected payloads: renamed .rejected, run completes
    out2 = str(tmp_path / "outlive2")
    os.makedirs(out2, exist_ok=True)
    with open(f"{out2}/apply.json", "w") as fh:
        json.dump({"bogus_field": 1}, fh)
    rc = main(["run", "--scene", "disk", "-n", "512", "--steps", "2",
               "--block", "2", "--out", out2, "--quiet"])
    assert rc == 0
    assert os.path.exists(f"{out2}/apply.json.rejected")


def test_render_camera_and_box(tmp_path):
    """--camera AZ,EL,DIST + the wireframe box overlay (the reference's
    drawBox + view controls, visualization.cpp:64-134,341-362)."""
    import numpy as np

    out = str(tmp_path / "ocam")
    main(["run", "--scene", "disk", "-n", "512", "--steps", "2",
          "--block", "2", "--out", out, "--quiet"])
    a = str(tmp_path / "a.png")
    b = str(tmp_path / "b.png")
    nb = str(tmp_path / "nb.png")
    assert main(["render", f"{out}/final_state.npz", "-o", a,
                 "--scene", "disk", "-n", "512",
                 "--camera", "180,0.45,1.6"]) == 0
    assert main(["render", f"{out}/final_state.npz", "-o", b,
                 "--scene", "disk", "-n", "512",
                 "--camera", "90,0.1,2.5"]) == 0
    assert main(["render", f"{out}/final_state.npz", "-o", nb,
                 "--scene", "disk", "-n", "512", "--perspective",
                 "--no-box"]) == 0
    import PIL.Image as Image

    ia = np.asarray(Image.open(a))
    ib = np.asarray(Image.open(b))
    inb = np.asarray(Image.open(nb))
    assert (ia != ib).any(), "camera controls had no effect on the view"
    # the wireframe overlay adds dim edge pixels the boxless render lacks
    assert (ia > 0).sum() > (inb > 0).sum(), "box wireframe missing"


def test_run_multidevice_slab(tmp_path):
    out = str(tmp_path / "outslab")
    rc = main(["run", "--scene", "dam_break", "-n", "2048", "--steps", "2",
               "--block", "2", "--out", out, "--devices", "8",
               "--partition", "slab",
               "--set", "grid_nx=16", "--set", "grid_ny=16",
               "--set", "grid_nz=16", "--quiet"])
    assert rc == 0
    assert os.path.exists(f"{out}/energy.txt")


def test_run_multidevice_slab_pallas(tmp_path):
    """--partition slab runs the cell-list sweeps in each shard; --backend
    pallas is single-device only and is rejected, not silently replaced."""
    with pytest.raises(SystemExit, match="single-device only"):
        main(["run", "--scene", "dam_break", "-n", "2048", "--steps", "2",
              "--block", "2", "--out", str(tmp_path / "outslabp"),
              "--devices", "8", "--partition", "slab", "--backend", "pallas",
              "--set", "grid_nx=16", "--set", "grid_ny=16",
              "--set", "grid_nz=16", "--quiet"])


def test_run_live_frame(tmp_path):
    """--live re-renders the current state every block (the reference's
    repaint-while-running loop, viewer-poll style)."""
    out = str(tmp_path / "outl")
    live = str(tmp_path / "live.png")
    rc = main(["run", "--scene", "disk", "-n", "512", "--steps", "4",
               "--block", "2", "--out", out, "--live", live, "--quiet"])
    assert rc == 0
    assert os.path.getsize(live) > 100


def test_run_live_term(tmp_path, capsys):
    """--live-term repaints an ANSI half-block splat every block — the
    in-terminal analog of the reference's 60 FPS GL repaint
    (visualization.cpp:24-33)."""
    out = str(tmp_path / "outt")
    rc = main(["run", "--scene", "disk", "-n", "512", "--steps", "4",
               "--block", "2", "--out", out, "--live-term", "--quiet"])
    assert rc == 0
    cap = capsys.readouterr().out
    assert "\x1b[2J\x1b[H" in cap          # clear + home per repaint
    assert "▀" in cap and "\x1b[38;5;" in cap


def test_watch_snapshot(tmp_path, capsys):
    """`watch --once` renders the live dashboard (the reference's main-window
    timing/energy panel, widget.cpp:91-111) from a run's diagnostics.jsonl."""
    out = str(tmp_path / "outw")
    main(["run", "--scene", "disk", "-n", "512", "--steps", "4",
          "--block", "2", "--out", out, "--quiet"])
    rc = main(["watch", "--out", out, "--once"])
    assert rc == 0
    cap = capsys.readouterr().out
    assert "E_total" in cap and "step_ms" in cap and "nbr mean" in cap
    assert any(ch in cap for ch in "▁▂▃▄▅▆▇█")
    # missing directory: clean error, nonzero exit
    assert main(["watch", "--out", str(tmp_path / "nope"), "--once"]) == 1


def test_stability_artifact_envelope():
    """Pin the committed full-size stability map.

    docs/STABILITY.md records the honey-sweep drift numbers as prose; this
    gate asserts the committed docs/stability_sweep.json artifact (131k
    particles x 300 steps, regenerated by the sweep command in
    STABILITY.md's header) so a regenerate-after-regression fails CI:
    every cell stable, drift inside the measured envelope (<= 0.15), and
    the reference's own regime (mu >= 10, k = 1e-4 —
    /root/reference/src/sph.cpp:77) at most as drifty as the low-viscosity
    corner (the viscous damping reading in STABILITY.md)."""
    path = os.path.join(os.path.dirname(__file__), "..", "docs",
                        "stability_sweep.json")
    if not os.path.exists(path):
        pytest.skip("docs/stability_sweep.json not generated yet")
    rows = json.load(open(path))
    assert len(rows) >= 6
    by_mu = {}
    for r in rows:
        assert r["stable"], r
        assert r["steps"] >= 300, r
        assert r["energy_drift"] < 0.15, r
        by_mu.setdefault(r["viscosity"], []).append(r["energy_drift"])
    mus = sorted(by_mu)
    # drift must not grow with viscosity (damping), within 10% slack
    for lo, hi in zip(mus, mus[1:]):
        assert max(by_mu[hi]) <= max(by_mu[lo]) * 1.10 + 1e-3, (lo, hi, by_mu)


def test_sweep_grid(tmp_path, capsys):
    """The viscosity x stiffness sweep harness (BASELINE config 4): one JSON
    record per grid cell; the reference's own regime (high viscosity, low
    stiffness — src/sph.cpp:77) must sit in the stable corner."""
    out = str(tmp_path / "sweep.json")
    rc = main(["sweep", "--scene", "honey", "-n", "512", "--steps", "6",
               "--block", "3", "--viscosity", "0.01,10", "--stiffness",
               "1e-4", "--out", out])
    assert rc == 0
    rows = json.load(open(out))
    assert len(rows) == 2
    by_mu = {r["viscosity"]: r for r in rows}
    assert by_mu[10.0]["stable"], "the reference's honey regime blew up"
    for r in rows:
        assert r["steps"] > 0 and r["neighbor_mean"] >= 0


def test_pause_resume_signal(tmp_path):
    """SIGUSR1 toggles pause/resume at block boundaries — the reference's
    run/pause button (/root/reference/src/sph.cpp:307-312)."""
    import signal as _signal
    import subprocess
    import sys
    import time

    if not hasattr(_signal, "SIGUSR1"):
        pytest.skip("no SIGUSR1 on this platform")
    out = str(tmp_path / "outp")
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import sys\n"
        "from smoothed_particle_hydrodynamics_tpu.cli import main\n"
        f"sys.exit(main(['run', '--scene', 'disk', '-n', '256', '--steps',"
        f" '40', '--block', '2', '--out', {out!r}, '--quiet']))\n")
    p = subprocess.Popen([sys.executable, "-c", code],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    try:
        # the handler is installed before the "scene=" banner; signaling any
        # earlier would hit SIGUSR1's default action (terminate) mid-import
        banner = p.stdout.readline()
        assert banner.startswith("scene="), banner
        p.send_signal(_signal.SIGUSR1)   # pause
        time.sleep(6.0)
        assert p.poll() is None, "run finished while supposedly paused"
        p.send_signal(_signal.SIGUSR1)   # resume
        _, err = p.communicate(timeout=240)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, err
    assert "paused" in err and "resumed" in err


def test_run_multidevice_halo_rejects_pallas(tmp_path):
    with pytest.raises(SystemExit):
        main(["run", "--scene", "dam_break", "-n", "2048", "--steps", "2",
              "--devices", "8", "--partition", "halo", "--backend", "pallas",
              "--quiet"])
