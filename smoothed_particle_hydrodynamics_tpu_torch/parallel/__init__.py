"""Multi-rank execution: the distributed slab engine on ``torch.distributed``
(counterpart of ``smoothed_particle_hydrodynamics_tpu/parallel``; its
replicated-binning halo engine ``sharding.py`` is not ported yet)."""

from .comm import SlabGroup, local_group, spawn_ranks
from .slabs import (LazySlabCarry, SlabCarry, collect, derive_slab_caps,
                    derive_sub_len_slab, derive_zsplit, distribute,
                    init_lazy_slab, make_slab_step, maybe_rebalance,
                    run_slab_steps, slab_imbalance, uniform_zsplit)

__all__ = ["SlabGroup", "local_group", "spawn_ranks",
           "LazySlabCarry", "SlabCarry", "collect", "derive_slab_caps",
           "derive_sub_len_slab", "derive_zsplit", "distribute",
           "init_lazy_slab", "make_slab_step", "maybe_rebalance",
           "run_slab_steps", "slab_imbalance", "uniform_zsplit"]
