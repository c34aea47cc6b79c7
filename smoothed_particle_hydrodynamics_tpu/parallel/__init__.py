"""Multi-device execution: device mesh, sharded step, collectives.

The reference has zero multi-device code (SURVEY.md §2, parallelism
inventory); this package *introduces* the distributed layer as first-class:
spatial decomposition over a ``jax.sharding.Mesh`` with XLA collectives."""

from .sharding import (derive_halo_rows, make_mesh, make_sharded_step,
                       shard_state, step_sharded, step_sharded_halo)
from .slabs import (LazySlabCarry, SlabCarry, collect, derive_slab_caps,
                    derive_zsplit, distribute, init_lazy_slab, make_slab_step,
                    uniform_zsplit)

__all__ = ["derive_halo_rows", "make_mesh", "make_sharded_step",
           "shard_state", "step_sharded", "step_sharded_halo",
           "LazySlabCarry", "SlabCarry", "collect", "derive_slab_caps",
           "derive_zsplit", "distribute", "init_lazy_slab", "make_slab_step",
           "uniform_zsplit"]
