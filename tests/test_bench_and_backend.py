"""Coverage for the parity helper, backend auto-resolution, the device check
and the compile-cache helper."""

import argparse

import jax
import numpy as np
import pytest

from smoothed_particle_hydrodynamics_tpu.cli import _resolve_backend
from smoothed_particle_hydrodynamics_tpu.utils.benchmark import (
    require_gpu, run_parity_check)


def test_run_parity_check_cpu_interpret():
    """The parity helper, with the kernels in interpret mode as the CPU
    tests ask explicitly, passes against the cell-list reference."""
    res = run_parity_check(n=1024, interpret=True)
    assert res["interpret"] is True
    assert res["neighbor_counts_equal"]
    assert res["rho_rel_l2"] < 1e-5
    assert res["acc_rel_l2"] < 1e-4
    assert res["pass"]


def test_device_check_raises_without_gpu():
    """No fallback that hides the device: on the CPU the device check and
    a compiled (non-interpret) parity check both raise."""
    with pytest.raises(RuntimeError, match="needs a GPU"):
        require_gpu()
    with pytest.raises(RuntimeError, match="needs a GPU"):
        run_parity_check(n=256)


def _args(**kw):
    ns = argparse.Namespace(backend="auto", compat=False, devices=0)
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


def test_resolve_backend_auto_cpu_is_celllist():
    a = _args()
    _resolve_backend(a)
    assert a.backend == "celllist"  # tests force the CPU platform


def test_resolve_backend_compat_and_devices():
    a = _args(compat=True)
    _resolve_backend(a)
    assert a.backend == "compat"
    a = _args(devices=8)
    _resolve_backend(a)
    assert a.backend == "celllist"
    a = _args(backend="pallas")
    _resolve_backend(a)
    assert a.backend == "pallas"  # explicit choice is never overridden


@pytest.mark.parametrize("platform,backend", [
    ("gpu", "pallas"), ("cpu", "celllist")])
def test_default_backend_by_platform(platform, backend):
    from smoothed_particle_hydrodynamics_tpu.ops.step import default_backend

    assert default_backend(platform) == backend


def test_derive_window_t_matches_distribution():
    """The per-(block, rod) windows equal the row span of the rod's cells,
    recomputed here with numpy searchsorted on the sorted cell ids."""
    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu.ops.grid import (
        cell_coords, linear_cell_id)
    from smoothed_particle_hydrodynamics_tpu.ops.pallas_sweep import (
        block_windows)

    cfg, state = make_scene("dam_break", num_particles=4096,
                            grid_nx=16, grid_ny=16, grid_nz=16)
    cid = np.sort(np.asarray(linear_cell_id(cfg, cell_coords(cfg, state.position))))
    block = 64
    ws, wl = block_windows(cfg, jax.numpy.asarray(cid), block)
    ws, wl = np.asarray(ws).reshape(-1, 9), np.asarray(wl).reshape(-1, 9)
    c = cfg.num_cells
    for b in range(ws.shape[0]):
        first, last = cid[b * block], cid[min((b + 1) * block, len(cid)) - 1]
        for r, (dy, dz) in enumerate((dy, dz) for dy in (-1, 0, 1)
                                     for dz in (-1, 0, 1)):
            delta = (dz * cfg.grid_ny + dy) * cfg.grid_nx
            lo = min(max(first + delta - 1, 0), c - 1)
            hi = min(max(last + delta + 1, 0), c - 1)
            s = np.searchsorted(cid, lo, side="left")
            e = np.searchsorted(cid, hi, side="right")
            assert (ws[b, r], wl[b, r]) == (s, e - s)
    # windows are far shorter than the particle count on a packed scene
    assert wl.max() < cfg.num_particles // 4


def test_cli_auto_window(tmp_path, capsys):
    """``cli run --backend pallas`` runs the lazy driver over the Pallas
    sweeps end to end (interpret mode on the CPU)."""
    from smoothed_particle_hydrodynamics_tpu.cli import main

    out = str(tmp_path / "outw")
    rc = main(["run", "--scene", "dam_break", "-n", "1024", "--steps", "2",
               "--block", "2", "--out", out, "--backend", "pallas",
               "--set", "pallas_interpret=true",
               "--set", "grid_nx=16", "--set", "grid_ny=16",
               "--set", "grid_nz=16", "--quiet"])
    assert rc == 0
    assert "backend=pallas" in capsys.readouterr().out
    assert (tmp_path / "outw" / "final_state.npz").exists()


def test_derive_range_slice_dilute_vs_dense():
    from smoothed_particle_hydrodynamics_tpu.models import make_scene
    from smoothed_particle_hydrodynamics_tpu.ops.celllist import derive_range_slice
    from smoothed_particle_hydrodynamics_tpu.ops.step import compute_forces

    cfg, state = make_scene("disk", num_particles=4096)
    rs = derive_range_slice(cfg, state)
    assert rs % 8 == 0 and rs >= 16
    # derived slice must not truncate on the state it was derived from
    cfg2 = cfg.replace(range_slice=rs)
    _, _, aux = compute_forces(cfg2, state, backend="celllist")
    assert int(aux.truncated_ranges) == 0


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    """Where JAX_COMPILATION_CACHE_DIR is set the helper sets nothing;
    otherwise it points JAX at the fixed in-checkout default."""
    from smoothed_particle_hydrodynamics_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = cache.enable_compile_cache()
            assert got == cache.DEFAULT_DIR
            assert got.endswith(".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
