"""Trial-axis sharding of the sweep fabric over devices (counterpart of
``repro.sharding``'s ``trials.py``; its model-parallel plans are not
ported)."""
from repro_torch.sharding.trials import ShardPool, shard_table

__all__ = ["ShardPool", "shard_table"]
