"""Checks that need the GPU: the compiled Pallas sweeps against the plain
references at real widths.  They skip on the CPU (``gpu`` fixture);
``chip_smoke.py`` runs the same checks on the card."""

import pytest

from smoothed_particle_hydrodynamics_tpu.utils.benchmark import (
    GPU_PARITY_CASES, run_parity_check)


@pytest.mark.gpu
@pytest.mark.parametrize("scene,n,reference", GPU_PARITY_CASES)
def test_parity_at_real_width(gpu, scene, n, reference):
    res = run_parity_check(n=n, scene=scene, reference=reference)
    assert res["neighbor_counts_equal"], res
    assert res["rho_rel_l2"] <= 1e-5, res
    assert res["acc_rel_l2"] <= 1e-4, res
