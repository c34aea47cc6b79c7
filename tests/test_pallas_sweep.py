"""The Pallas (Triton) neighbour sweeps in interpret mode against the plain
XLA references, and the lazy driver over them against ``drive_loop``.

Sums run in another order than in the references, so the bounds are f32
reduction-order bounds: density rel-L2 <= 1e-5, acceleration rel-L2 <= 1e-4,
and neighbour counts must match exactly.
"""

from functools import partial

import jax
import numpy as np
import pytest

from smoothed_particle_hydrodynamics_tpu.models import make_scene
from smoothed_particle_hydrodynamics_tpu.ops import pallas_sweep
from smoothed_particle_hydrodynamics_tpu.ops.step import compute_forces
from smoothed_particle_hydrodynamics_tpu.utils.benchmark import rel_l2

# small grids keep the packed scenes packed at CPU sizes
SCENES = {
    "dam_break": dict(num_particles=2048, grid_nx=16, grid_ny=16, grid_nz=16),
    "splash": dict(num_particles=2048, grid_nx=16, grid_ny=16, grid_nz=16),
    "disk": dict(num_particles=2048),
}


def _forces(cfg, state, block):
    return jax.jit(partial(pallas_sweep.compute_step_quantities, cfg,
                           block=block))(state)


@pytest.mark.parametrize("block", [16, 32, 64])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sweep_matches_celllist(scene, block):
    cfg, state = make_scene(scene, pallas_interpret=True, **SCENES[scene])
    acc, rho, aux = _forces(cfg, state, block)
    acc_c, rho_c, aux_c = compute_forces(cfg, state, "celllist")
    assert int(aux_c.truncated_ranges) == 0 and int(aux_c.overflow_cells) == 0
    np.testing.assert_array_equal(np.asarray(aux.neighbor_count),
                                  np.asarray(aux_c.neighbor_count))
    assert rel_l2(rho, rho_c) <= 1e-5
    assert rel_l2(acc, acc_c) <= 1e-4


@pytest.mark.parametrize("scene", ["dam_break", "disk"])
def test_sweep_matches_pairwise(scene):
    cfg, state = make_scene(scene, pallas_interpret=True,
                            **{**SCENES[scene], "num_particles": 1024})
    acc, rho, aux = _forces(cfg, state, 64)
    acc_p, rho_p, aux_p = compute_forces(cfg, state, "pairwise")
    np.testing.assert_array_equal(np.asarray(aux.neighbor_count),
                                  np.asarray(aux_p.neighbor_count))
    assert rel_l2(rho, rho_p) <= 1e-5
    assert rel_l2(acc, acc_p) <= 1e-4


def test_sweep_partial_last_block():
    """N not a multiple of the block: padding rows stay inert."""
    cfg, state = make_scene("dam_break", pallas_interpret=True,
                            **{**SCENES["dam_break"], "num_particles": 1000})
    acc, rho, aux = _forces(cfg, state, 64)
    acc_c, rho_c, aux_c = compute_forces(cfg, state, "celllist")
    np.testing.assert_array_equal(np.asarray(aux.neighbor_count),
                                  np.asarray(aux_c.neighbor_count))
    assert rel_l2(rho, rho_c) <= 1e-5
    assert rel_l2(acc, acc_c) <= 1e-4


def test_sweep_rejects_compat_and_thin_grids():
    cfg, state = make_scene("disk", num_particles=256, compat=True)
    with pytest.raises(ValueError, match="default mode"):
        pallas_sweep.prepare(cfg, state)
    cfg, state = make_scene("disk", num_particles=256, grid_nz=2,
                            neighborhood="cell27")
    with pytest.raises(ValueError, match="grid dims"):
        pallas_sweep.prepare(cfg, state)


def test_lazy_driver_matches_drive_loop():
    """A few lazy steps over the sweeps (1.25h cells: frozen bins between
    rebins) track the per-step-rebinning cell-list driver."""
    from smoothed_particle_hydrodynamics_tpu.ops.lazy import (
        drive_loop_lazy, unsort_carry)
    from smoothed_particle_hydrodynamics_tpu.ops.step import drive_loop

    cfg, state = make_scene("dam_break", pallas_interpret=True,
                            cell_size_factor=1.25,
                            **{**SCENES["dam_break"], "num_particles": 1024})
    carry, d_lazy = drive_loop_lazy(cfg, state, 4, keep_carry=True)
    assert int(carry.rebin_count) < 4          # bins were reused
    final_lazy = unsort_carry(carry)
    final_ref, d_ref = drive_loop(cfg, state, 4, backend="celllist")
    np.testing.assert_array_equal(np.asarray(d_lazy.neighbor_mean),
                                  np.asarray(d_ref.neighbor_mean))
    np.testing.assert_allclose(np.asarray(d_lazy.kinetic_energy),
                               np.asarray(d_ref.kinetic_energy), rtol=1e-4)
    assert rel_l2(final_lazy.position, final_ref.position) <= 1e-5
    assert rel_l2(final_lazy.velocity, final_ref.velocity) <= 1e-4
