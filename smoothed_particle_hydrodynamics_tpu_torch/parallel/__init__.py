"""Multi-rank execution on ``torch.distributed`` (counterpart of
``smoothed_particle_hydrodynamics_tpu/parallel``): the rank group and its
collectives (``comm``), the replicated-binning halo engine (``sharding``)
and the distributed slab engine (``slabs``)."""

from .comm import RankPool, SlabGroup, local_group, spawn_ranks
from .sharding import (RankLayout, derive_halo_rows, make_mesh,
                       make_sharded_step, run_steps_sharded, shard_state,
                       step_sharded, step_sharded_halo)
from .slabs import (LazySlabCarry, SlabCarry, collect, derive_slab_caps,
                    derive_sub_len_slab, derive_zsplit, distribute,
                    init_lazy_slab, make_slab_step, maybe_rebalance,
                    run_slab_steps, slab_imbalance, uniform_zsplit)

__all__ = ["RankPool", "SlabGroup", "local_group", "spawn_ranks",
           "RankLayout", "derive_halo_rows", "make_mesh",
           "make_sharded_step", "run_steps_sharded", "shard_state",
           "step_sharded", "step_sharded_halo",
           "LazySlabCarry", "SlabCarry", "collect", "derive_slab_caps",
           "derive_sub_len_slab", "derive_zsplit", "distribute",
           "init_lazy_slab", "make_slab_step", "maybe_rebalance",
           "run_slab_steps", "slab_imbalance", "uniform_zsplit"]
