"""Particle state pytree.

The reference stores particles as a structure-of-arrays container of flat
``std::vector<float>`` fields (`/root/reference/src/particle.h:13-18`).  The
JAX equivalent is a NamedTuple-of-arrays pytree: ``[N,3]`` float32 for
vectors, ``[N]`` for scalars.  Being a pytree it jit-traces, shards, scans and
checkpoints with zero glue code.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import SphConfig


class ParticleState(NamedTuple):
    """SoA particle fields (reference parity: /root/reference/src/particle.h:13-18)."""

    position: jax.Array        # [N, 3] float32, world units
    velocity: jax.Array        # [N, 3] float32, km/s
    mass: jax.Array            # [N]    float32, M_sun
    density: jax.Array         # [N]    float32 (derived each step)
    acceleration: jax.Array    # [N, 3] float32 (derived each step)
    neighbor_count: jax.Array  # [N]    int32   (derived each step)

    @property
    def n(self) -> int:
        return self.position.shape[0]

    @staticmethod
    def zeros(n: int, dtype=jnp.float32) -> "ParticleState":
        return ParticleState(
            position=jnp.zeros((n, 3), dtype),
            velocity=jnp.zeros((n, 3), dtype),
            mass=jnp.ones((n,), dtype),
            density=jnp.zeros((n,), dtype),
            acceleration=jnp.zeros((n, 3), dtype),
            neighbor_count=jnp.zeros((n,), jnp.int32),
        )

    @staticmethod
    def from_arrays(position, velocity, mass=None, cfg: SphConfig | None = None) -> "ParticleState":
        position = jnp.asarray(position, jnp.float32)
        velocity = jnp.asarray(velocity, jnp.float32)
        n = position.shape[0]
        if mass is None:
            m = cfg.particle_mass if cfg is not None else 1.0
            mass = jnp.full((n,), m, jnp.float32)
        else:
            mass = jnp.asarray(mass, jnp.float32)
        return ParticleState(
            position=position,
            velocity=velocity,
            mass=mass,
            density=jnp.zeros((n,), jnp.float32),
            acceleration=jnp.zeros((n, 3), jnp.float32),
            neighbor_count=jnp.zeros((n,), jnp.int32),
        )

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self._asdict().items()}

    @staticmethod
    def from_numpy(d: dict[str, np.ndarray]) -> "ParticleState":
        return ParticleState(
            position=jnp.asarray(d["position"], jnp.float32),
            velocity=jnp.asarray(d["velocity"], jnp.float32),
            mass=jnp.asarray(d["mass"], jnp.float32),
            density=jnp.asarray(d["density"], jnp.float32),
            acceleration=jnp.asarray(d["acceleration"], jnp.float32),
            neighbor_count=jnp.asarray(d["neighbor_count"], jnp.int32),
        )


class StepDiagnostics(NamedTuple):
    """Per-step scalar diagnostics, mirroring the reference's out/*.txt rows
    (/root/reference/src/sph.cpp:162-178,204-232)."""

    kinetic_energy: jax.Array     # scalar f32
    potential_energy: jax.Array   # scalar f32
    angular_momentum: jax.Array   # scalar f32 |L| about the central mass
    neighbor_mean: jax.Array      # scalar f32
    neighbor_max: jax.Array       # scalar i32
    neighbor_min: jax.Array       # scalar i32
    overflow_cells: jax.Array     # scalar i32: cells whose occupancy exceeded capacity
    truncated_ranges: jax.Array   # scalar i32: candidate windows cut by static capacity
    halo_dropped: jax.Array       # scalar i32: candidates beyond the halo band (sharded halo path)
    migration_dropped: jax.Array  # scalar i32: particles lost to migration/slab capacity (slab path)


def make_step_diagnostics(tally, neighbor_count: jax.Array,
                          overflow_cells: jax.Array,
                          truncated_ranges: jax.Array | None = None,
                          halo_dropped: jax.Array | None = None,
                          migration_dropped: jax.Array | None = None) -> StepDiagnostics:
    """Assemble the per-step diagnostics record from an energy tally + counters.

    Silent-physics counters default to 0 for paths that cannot truncate; every
    compute path that CAN drop interactions must pass its real counter so dense
    scenes surface the loss in diagnostics.jsonl instead of hiding it.
    """
    nc = neighbor_count
    zero = jnp.zeros((), jnp.int32)
    return StepDiagnostics(
        kinetic_energy=tally.kinetic,
        potential_energy=tally.potential,
        angular_momentum=tally.angular_momentum,
        neighbor_mean=jnp.mean(nc.astype(jnp.float32)),
        neighbor_max=jnp.max(nc),
        neighbor_min=jnp.min(nc),
        overflow_cells=overflow_cells,
        truncated_ranges=zero if truncated_ranges is None else truncated_ranges,
        halo_dropped=zero if halo_dropped is None else halo_dropped,
        migration_dropped=zero if migration_dropped is None else migration_dropped,
    )


@jax.jit
def stack_diagnostics(diags: list[StepDiagnostics]) -> StepDiagnostics:
    """Per-step diagnostics -> one record of [steps] arrays.

    Jitted: one dispatch, where op-by-op stacking costs one per field and
    step — on the GPU more than a small scene's device step."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *diags)
