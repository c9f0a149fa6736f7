"""Queue lanes: TE-priority FIFO + BE FIFO as lazy-deletion heaps (the
port's copy of the JAX package's ``core/engine/queues.py``).

Entries are ``(key, job)`` tuples; lower key = closer to the head.
Arrival pushes take keys from a monotonically increasing tail counter
(FIFO); preemption victims re-enter at the TOP via a monotonically
decreasing ``top_key`` (the paper's requeue-on-top rule). A job's
current key lives in ``self.key``; heap entries whose key disagrees
(or whose job is no longer queued) are stale and skipped on pop —
lazy deletion keeps every operation O(log queue).
"""
from __future__ import annotations

import heapq
from typing import Callable, Dict, List, Tuple


class QueueLanes:
    def __init__(self, is_queued: Callable[[int], bool]) -> None:
        self._is_queued = is_queued
        self.te_heap: List[Tuple[float, int]] = []
        self.be_heap: List[Tuple[float, int]] = []
        self.key: Dict[int, float] = {}    # job -> its live queue key
        self.top_key = -1.0                # next "top of queue" key
        self._tail_key = 0.0               # next arrival (FIFO) key

    def _heap(self, te: bool) -> List[Tuple[float, int]]:
        return self.te_heap if te else self.be_heap

    def _valid(self, key: float, j: int) -> bool:
        return self._is_queued(j) and self.key.get(j) == key

    # -- pushes --------------------------------------------------------------

    def push(self, j: int, key: float, te: bool) -> None:
        self.key[j] = key
        heapq.heappush(self._heap(te), (key, j))

    def push_back(self, j: int, te: bool) -> float:
        """Append at the tail (arrival order)."""
        key = self._tail_key
        self._tail_key += 1.0
        self.push(j, key, te)
        return key

    def requeue_top(self, j: int, te: bool) -> float:
        """Preemption-victim rule: re-enter at the TOP of the lane."""
        key = self.top_key
        self.top_key -= 1.0
        self.push(j, key, te)
        return key

    def reinsert(self, j: int, te: bool) -> None:
        """Re-push a popped-but-blocked job with its existing key."""
        heapq.heappush(self._heap(te), (self.key[j], j))

    # -- pops ----------------------------------------------------------------

    def peek(self, te: bool) -> int:
        """Valid head without removing it (stale entries are dropped),
        or -1 when the lane is empty."""
        heap = self._heap(te)
        while heap:
            key, j = heap[0]
            if self._valid(key, j):
                return j
            heapq.heappop(heap)
        return -1

    def pop(self, te: bool) -> int:
        """Remove and return the valid head, or -1."""
        j = self.peek(te)
        if j >= 0:
            heapq.heappop(self._heap(te))
        return j

    def valid_jobs(self, te: bool) -> List[int]:
        """All currently queued jobs in the lane (unordered)."""
        return [j for key, j in self._heap(te) if self._valid(key, j)]
