"""Host-side scheduling pieces of the port: placement, queue lanes,
victim-selection marshalling and the reference engine's
:class:`SchedulerCore`."""
from repro_torch.core.engine.core import CoreHooks, SchedulerCore
from repro_torch.core.engine.placement import FIT_EPS, ClusterState
from repro_torch.core.engine.preemption import (best_victim_node,
                                                gang_select, ranked_order)
from repro_torch.core.engine.queues import QueueLanes

__all__ = [
    "FIT_EPS", "ClusterState", "QueueLanes", "SchedulerCore", "CoreHooks",
    "best_victim_node", "gang_select", "ranked_order",
]
