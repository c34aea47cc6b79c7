"""The distributed slab engine on an 8-device mesh.

Each device owns a contiguous run of z-planes of the grid (mass-balanced by
``derive_zsplit``), holds only its own particles (O(N/D) memory, fixed
capacity ``p_cap``), exchanges one-plane halos with its mesh neighbours via
``ppermute`` every step, and migrates boundary-crossing particles at rebins.
The reference has no multi-device story at all (SURVEY.md §2); this layer is
the replacement for the comm backend it never had.

On a machine without 8 devices this script splits the host CPU into 8
virtual devices — every collective compiles and runs exactly as it would on
a real mesh (the same trick tests/conftest.py uses):

    python examples/distributed.py
"""

import os
import sys

# Demo default: an 8-device VIRTUAL CPU mesh.  With real devices, run with
# SPH_EXAMPLE_REAL_DEVICES=1 to use them instead.
# (Env + config both, before any device touch, so an installed accelerator
# plugin cannot take over.)
_USE_REAL = os.environ.get("SPH_EXAMPLE_REAL_DEVICES") == "1"
if not _USE_REAL:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _USE_REAL:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from smoothed_particle_hydrodynamics_tpu.models import make_scene  # noqa: E402
from smoothed_particle_hydrodynamics_tpu.parallel import slabs  # noqa: E402
from smoothed_particle_hydrodynamics_tpu.parallel.sharding import make_mesh  # noqa: E402

NDEV = len(jax.devices())
_quick = os.environ.get("SPH_EXAMPLE_QUICK") == "1"   # tiny run for CI
cfg, state = make_scene("dam_break",
                        num_particles=4096 if _quick else 32768)

mesh = make_mesh(NDEV)
zsplit = slabs.derive_zsplit(cfg, state, NDEV)          # mass-balanced planes
p_cap, h_cap, m_cap = slabs.derive_slab_caps(cfg, state, NDEV, zsplit=zsplit)
print(f"devices={NDEV}  n={cfg.num_particles}  z-split={list(zsplit)}")
print(f"per-device capacities: particles={p_cap} halo={h_cap} migration={m_cap}"
      f"  (store is O(N/D): {p_cap}/{cfg.num_particles})")

carry = slabs.distribute(cfg, state, mesh, p_cap, zsplit=zsplit)
step = slabs.make_slab_step(cfg, mesh, p_cap, h_cap, m_cap, zsplit=zsplit)

for i in range(20):
    carry, diag = step(carry)

# physics diagnostics are psum'd across the mesh: one number per step
print(f"after 20 steps: KE={float(diag.kinetic_energy):.5g}  "
      f"neighbors mean={float(diag.neighbor_mean):.1f}  "
      f"migration_dropped={int(diag.migration_dropped)}  "
      f"halo_dropped={int(diag.halo_dropped)}")

# gather back to one host array; particle count is conserved
final = slabs.collect(carry, cfg.num_particles)
assert np.isfinite(np.asarray(final.position)).all()
print(f"collected [{final.position.shape[0]}, 3] positions — "
      "all particles accounted for")
