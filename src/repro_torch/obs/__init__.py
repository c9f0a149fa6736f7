"""Observability: canonical event schema, ring-buffer decode, trace
exporters and derived telemetry.

The port's copy of the JAX package's ``obs`` (numpy only, the same
functions and outputs). Layering: ``obs`` depends only on numpy and
the schema itself; both engines of the port (``core/simulator.py``,
``core/sim_torch.py``) import from here, never the other way around,
so every consumer of a trace is engine-agnostic.
"""
from repro_torch.obs.export import (CsvTraceWriter,  # noqa: F401
                                    read_csv, to_csv, to_perfetto,
                                    write_trace)
from repro_torch.obs.ring import (decode_ring,  # noqa: F401
                                  default_capacity, n_node_words,
                                  round_capacity)
from repro_torch.obs.schema import (BACKFILL, EVENT_NAMES,  # noqa: F401
                                    FINISH, GRACE_EXPIRE,
                                    PREEMPT_SIGNAL, REQUEUE, RESUME,
                                    START, SUBMIT, VACATE, Event,
                                    events_of_job, render_preemption,
                                    validate_events)
from repro_torch.obs.timeseries import (JobDecomposition,  # noqa: F401
                                        TimeSeries, compute_timeseries,
                                        format_timeseries,
                                        slowdown_decomposition)
