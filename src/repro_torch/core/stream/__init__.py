"""Streaming macro-round engine: the port of the JAX package's
``core/stream/``.

Bounded-memory replay of 10^5-10^6-job traces: a fixed-capacity slot
pool over ``sim_torch`` (``StreamEngine``), fed by chunked
:class:`JobSource` iterators (synthetic ``workload.stream_chunks``, the
trace readers, or any job set through ``from_jobset``), with per-round
event and result draining. Memory scales with ``capacity`` (in-flight
jobs), not trace length; results equal the monolithic engine's
(``verify_prefix_parity``). Closed-loop arrivals (paper §4.2, load 2.0)
stream through the same pool via ``ClosedLoopAdmission`` /
``StreamEngine(..., admission=True)`` (``verify_closed_loop_parity``).

    from repro_torch.core import stream, workload
    src = stream.JobSource(workload.stream_chunks(cfg, 100_000))
    res = stream.StreamEngine(cfg, src, capacity=512).run()   # on the GPU
    res.summary()["BE"]["p95"], res.rounds, res.max_live
"""
from repro_torch.core.stream.admission import (ClosedLoopAdmission,
                                               closed_loop_source,
                                               verify_admission_parity)
from repro_torch.core.stream.engine import (AKEY_GID_LIMIT,
                                            DEFAULT_SLOTS_PER_NODE,
                                            StreamEngine, StreamResult,
                                            default_capacity,
                                            verify_closed_loop_parity,
                                            verify_prefix_parity)
from repro_torch.core.stream.source import (JobSource, ScanStats,
                                            from_jobset, materialize, scan)

__all__ = [
    "AKEY_GID_LIMIT", "ClosedLoopAdmission", "DEFAULT_SLOTS_PER_NODE",
    "JobSource", "ScanStats", "StreamEngine", "StreamResult",
    "closed_loop_source", "default_capacity", "from_jobset",
    "materialize", "scan", "verify_admission_parity",
    "verify_closed_loop_parity", "verify_prefix_parity",
]
