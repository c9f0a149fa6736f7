"""Sharding (counterpart of ``repro.sharding``): the trial-axis sharding
of the sweep fabric over devices (``trials.py``), and the dry-run's
model-parallel plans and activation layouts (``plans.py``,
``constraints.py``)."""
from repro_torch.sharding.plans import (arch_plan, batch_sharding,
                                        cache_sharding, param_sharding,
                                        spec_from_logical,
                                        train_state_sharding)
from repro_torch.sharding.trials import ShardPool, shard_table

__all__ = ["arch_plan", "param_sharding", "batch_sharding", "cache_sharding",
           "train_state_sharding", "spec_from_logical",
           "ShardPool", "shard_table"]
