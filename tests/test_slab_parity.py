"""Slab engine against a single device, on 4 virtual CPU devices.

The fast-lane counterpart of ``chip_smoke.py --four``: the same bounds (KE
and |L| to 1e-3 relative, neighbour mean to 1e-2, nothing dropped), on a
small packed scene.
"""

import numpy as np

from smoothed_particle_hydrodynamics_tpu.models import make_scene
from smoothed_particle_hydrodynamics_tpu.ops.step import drive_loop
from smoothed_particle_hydrodynamics_tpu.parallel import slabs
from smoothed_particle_hydrodynamics_tpu.parallel.sharding import make_mesh


def test_slab_four_devices_matches_single_device():
    steps = 2
    cfg, state = make_scene("dam_break", num_particles=2048, grid_nx=16,
                            grid_ny=16, grid_nz=16, cell_capacity=32,
                            range_slice=64)
    mesh = make_mesh(4)
    zsplit = slabs.derive_zsplit(cfg, state, 4)
    p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, 4, zsplit=zsplit)
    carry = slabs.distribute(cfg, state, mesh, p_cap, zsplit=zsplit)
    # the store is spread over the 4 devices, one slab each
    shards = carry.fields.addressable_shards
    assert len({s.device for s in shards}) == 4
    assert (np.asarray(carry.count) > 0).all()
    f = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, donate=False,
                             zsplit=zsplit)
    for _ in range(steps):
        carry, d = f(carry)
    _, ref = drive_loop(cfg, state, steps, backend="celllist")

    def rel(a, b):
        return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)

    assert int(d.migration_dropped) == 0 and int(d.halo_dropped) == 0
    assert rel(d.kinetic_energy, ref.kinetic_energy[-1]) <= 1e-3
    assert rel(d.angular_momentum, ref.angular_momentum[-1]) <= 1e-3
    assert abs(float(d.neighbor_mean) - float(ref.neighbor_mean[-1])) <= 1e-2
    assert float(d.neighbor_mean) > 1.0   # the scene is packed
