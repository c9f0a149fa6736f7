"""Fixed-capacity event ring buffer: layout + host-side decode.

The port's copy of the JAX package's ``obs/ring.py``, with the same
layout, so the torch engine's buffer equals the JAX engine's bit for
bit. Tracing appends rows to a preallocated int32 tensor on the jobs'
device, carried in ``sim_torch.State``:

  * ``ev_buf`` — shape ``(capacity + 1, 4 + n_words)`` int32, where a
    row is ``[t, code, job, aux, node_word_0, ...]``. Node words pack
    the placement node mask 32 nodes per word, little-endian (node
    ``k`` is bit ``k % 32`` of word ``k // 32``); non-placement rows
    carry all-zero words. ``n_words = max(1, ceil(n_nodes / 32))``.
  * ``ev_n`` — the count of rows EMITTED (monotonic, may exceed
    capacity; a host int in the torch engine).

Row ``capacity`` (the extra row) is the dump row: a masked-out or
overflowing write lands there, and the row is re-zeroed after each
append, so the buffer contents stay a pure function of the event
stream — bitwise State parity between tick and event mode covers the
trace too.

Overflow rule: rows past capacity are dropped newest-first and
``overflow = max(0, ev_n - capacity)`` is surfaced loudly
(``result_summary``, ``ExperimentResult.trace_overflow``).
:func:`default_capacity` is sized so overflow never happens for the
repo's scenarios unless preemption churn exceeds the paper's P cap
many times over.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.obs import schema
from repro_torch.obs.schema import Event

# Buffer row layout: [t, code, job, aux, node words...]
HEADER_WORDS = 4
NODE_WORD_BITS = 32


def n_node_words(n_nodes: int) -> int:
    return max(1, -(-int(n_nodes) // NODE_WORD_BITS))


def default_capacity(n_jobs: int, max_preemptions: int = 1) -> int:
    """Capacity heuristic: every job emits SUBMIT + START + FINISH
    (+ BACKFILL marker at most once per placement), and each
    preemption of a job costs at most 7 rows (SIGNAL, GRACE_EXPIRE,
    VACATE, REQUEUE, RESUME + a possible BACKFILL on the resume and
    one slack row). ``fallback_count`` signals can exceed the P cap,
    so a generous constant floor is added on top."""
    per_job = 8 + 7 * max(int(max_preemptions), 1)
    return 64 + int(n_jobs) * per_job


def round_capacity(n_slots: int, max_preemptions: int = 1) -> int:
    """Per-round ring capacity for a streaming engine's recycled slot
    pool (the JAX package's ``core/stream/``): the ring is drained (and
    ``ev_n`` reset) between macro-rounds, a slot hosts at most ONE job
    within a round, and a job's whole-lifetime emission is bounded by
    :func:`default_capacity`'s per-job budget — so the same bound
    applied to SLOTS covers any single round. This is what keeps a
    streamed run's trace memory O(capacity), not O(total jobs)."""
    return default_capacity(n_slots, max_preemptions)


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a torch tensor is read to the host once
    (duck-typed, so this module needs no torch import)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def decode_ring(ev_buf, ev_n) -> Tuple[List[Event], int]:
    """Decode a ring buffer (numpy array or torch tensor, on any
    device) into canonical :class:`Event` rows.

    Returns ``(events, overflow)`` where ``overflow`` is the count of
    rows dropped past capacity. The dump row (index ``capacity``) is
    never part of the stream."""
    buf = _host(ev_buf)
    n = int(_host(ev_n))
    cap = buf.shape[0] - 1
    overflow = max(0, n - cap)
    kept = min(n, cap)
    rows = buf[:kept]
    heads = rows[:, :HEADER_WORDS].tolist()
    words = rows[:, HEADER_WORDS:].astype(np.uint32).tolist()
    events: List[Event] = []
    for (t, code, job, aux), ws in zip(heads, words):
        nodes: Tuple[int, ...] = ()
        if code in schema.PLACEMENT_CODES:
            idx = []
            for w, word in enumerate(ws):
                while word:
                    b = (word & -word).bit_length() - 1
                    idx.append(w * NODE_WORD_BITS + b)
                    word &= word - 1
            nodes = tuple(idx)
        events.append(Event(t=t, code=code, job=job, aux=aux, nodes=nodes))
    return events, overflow


def node_mask_weights(n_nodes: int) -> np.ndarray:
    """Per-node packing weights: ``(n_words, n_nodes)`` uint32 with
    ``weights[w, k] = 1 << (k % 32)`` iff ``k // 32 == w`` — a bool
    node mask packs to words via ``weights @ mask``. Precomputed on
    the host so an append packs a mask in one reduction."""
    n_words = n_node_words(n_nodes)
    w = np.zeros((n_words, n_nodes), np.uint32)
    for k in range(int(n_nodes)):
        w[k // NODE_WORD_BITS, k] = np.uint32(1 << (k % NODE_WORD_BITS))
    return w
