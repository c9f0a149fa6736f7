"""Canonical scheduler-event schema shared by both engines.

The port's copy of the JAX package's ``obs/schema.py``. One event
vocabulary for the port: the numpy reference simulator
(``core/simulator.py``) records :class:`Event` rows through its
scheduling-core hooks, the torch engine appends the same rows to its
ring buffer (``sim_torch.State.ev_buf``, decoded by
``obs.ring.decode_ring``), and every exporter / time-series /
decomposition consumer downstream speaks only this schema. Trace
parity — reference events == decoded ring events, exactly, per
(scenario × policy × time mode) — is the event-level form of the
engines' result-parity contract.

Event codes (``code``), with their ``aux`` meaning:

  ==============  ===========================================  =========
  code            emitted when                                 aux
  ==============  ===========================================  =========
  SUBMIT          job enters its queue lane on arrival         --
  START           first placement of a job                     --
  PREEMPT_SIGNAL  victim signalled; grace period begins        te job
  GRACE_EXPIRE    a GP>0 grace period ran out (before VACATE)  --
  VACATE          victim's resources freed                     te job
  REQUEUE         victim re-enters the TOP of its lane         --
  RESUME          placement of a previously-vacated victim     --
  FINISH          job completed (tick semantics: t+1)          --
  BACKFILL        marker after a placement that skipped ahead  n skipped
  ==============  ===========================================  =========

``t`` is the scheduling tick of the transition; ``job`` the integer
job id; ``nodes`` the placement node-set — recorded ONLY on
START / RESUME (release sites are implied by the preceding placement).
The queue *lane* is derived, not stored: TE lane iff the job is TE
and the policy is preemptive.

Ordering contract (both engines append in exactly this order):
within one tick — SUBMIT (job-index order), then grace expiries
(GRACE_EXPIRE / VACATE / REQUEUE grouped per job, job-index order),
then the schedule pass (TE lane, then BE lane, placements and signals
in pass order), then FINISH rows stamped ``t+1`` (job-index order).
Timestamps are therefore non-decreasing, with FINISH(t) rows
preceding SUBMIT(t) rows of the next tick.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

# Canonical event codes. Stable small ints: they are serialized into
# the engine's ring buffer and into CSV exports.
SUBMIT = 0
START = 1
PREEMPT_SIGNAL = 2
GRACE_EXPIRE = 3
VACATE = 4
REQUEUE = 5
RESUME = 6
FINISH = 7
BACKFILL = 8

EVENT_NAMES: Tuple[str, ...] = (
    "SUBMIT", "START", "PREEMPT_SIGNAL", "GRACE_EXPIRE", "VACATE",
    "REQUEUE", "RESUME", "FINISH", "BACKFILL")
N_CODES = len(EVENT_NAMES)

# Codes that carry a node-set (placements only; everything else
# implies its nodes from the preceding placement of the same job).
PLACEMENT_CODES = (START, RESUME)
# Codes that release the job's current placement.
RELEASE_CODES = (VACATE, FINISH)


@dataclass(frozen=True)
class Event:
    """One canonical scheduler event.

    ``aux`` is code-dependent (see module docstring); -1 means "none".
    ``nodes`` is the sorted placement node tuple for START / RESUME
    and empty otherwise.
    """
    t: int
    code: int
    job: int
    aux: int = -1
    nodes: Tuple[int, ...] = ()

    @property
    def name(self) -> str:
        return (EVENT_NAMES[self.code] if 0 <= self.code < N_CODES
                else f"?{self.code}")

    def as_tuple(self):
        return (self.t, self.code, self.job, self.aux, self.nodes)

    def render(self) -> str:
        s = f"{self.name} t={self.t} job={self.job}"
        if self.code in (PREEMPT_SIGNAL, VACATE) and self.aux >= 0:
            s += f" te={self.aux}"
        elif self.code == BACKFILL:
            s += f" skipped={self.aux}"
        elif self.aux != -1:
            s += f" aux={self.aux}"
        if self.nodes:
            s += f" nodes={'+'.join(str(n) for n in self.nodes)}"
        return s


def render_preemption(ev) -> str:
    """A reference ``PreemptionEvent`` rendered in the schema's
    vocabulary (``assert_result_parity`` divergence messages)."""
    s = (f"PREEMPT_SIGNAL t={ev.signal_time} job={ev.job} "
         f"te={ev.te_job}")
    s += (f" | VACATE t={ev.vacate_time}" if ev.vacate_time >= 0
          else " | VACATE pending")
    s += (f" | RESUME t={ev.resume_time}" if ev.resume_time >= 0
          else " | RESUME pending")
    return s


@dataclass
class _JobTrack:
    submitted: bool = False
    placed: bool = False          # currently holds nodes
    queued: bool = False
    in_grace: bool = False
    finished: bool = False
    ever_vacated: bool = False


def validate_events(events: Sequence[Event], n_jobs: Optional[int] = None,
                    n_nodes: Optional[int] = None) -> None:
    """Schema validation: codes in range, timestamps non-decreasing,
    and the per-job lifecycle legal (SUBMIT first; placements only
    from the queue; RESUME only after a vacate; at most one FINISH and
    nothing after it). Raises ``ValueError`` naming the first
    offending event index."""
    tracks: dict = {}
    last_t = None
    for i, ev in enumerate(events):
        def bad(msg, ev=ev, i=i):
            raise ValueError(f"event {i} [{ev.render()}]: {msg}")
        if not (0 <= ev.code < N_CODES):
            bad(f"unknown code {ev.code}")
        if ev.t < 0:
            bad("negative timestamp")
        if last_t is not None and ev.t < last_t:
            bad(f"timestamp decreases ({last_t} -> {ev.t})")
        last_t = ev.t
        if n_jobs is not None and not (0 <= ev.job < n_jobs):
            bad(f"job id out of range [0, {n_jobs})")
        if n_nodes is not None and any(not (0 <= n < n_nodes)
                                       for n in ev.nodes):
            bad(f"node id out of range [0, {n_nodes})")
        tr = tracks.setdefault(ev.job, _JobTrack())
        if tr.finished:
            bad("event after FINISH")
        if ev.code == SUBMIT:
            if tr.submitted:
                bad("second SUBMIT")
            tr.submitted, tr.queued = True, True
            continue
        if not tr.submitted:
            bad("event before SUBMIT")
        if ev.code in PLACEMENT_CODES:
            if not tr.queued or tr.placed:
                bad("placement of a non-queued job")
            if not ev.nodes:
                bad("placement without a node-set")
            if ev.code == RESUME and not tr.ever_vacated:
                bad("RESUME before any VACATE")
            if ev.code == START and tr.ever_vacated:
                bad("START after a VACATE (should be RESUME)")
            tr.placed, tr.queued = True, False
        elif ev.code == PREEMPT_SIGNAL:
            if not tr.placed:
                bad("signal on a non-placed job")
            tr.in_grace = True
        elif ev.code == GRACE_EXPIRE:
            if not tr.in_grace:
                bad("GRACE_EXPIRE without a pending signal")
        elif ev.code == VACATE:
            if not tr.in_grace:
                bad("VACATE without a pending signal")
            tr.placed, tr.in_grace, tr.ever_vacated = False, False, True
        elif ev.code == REQUEUE:
            if tr.placed or tr.queued:
                bad("REQUEUE of a placed/queued job")
            tr.queued = True
        elif ev.code == FINISH:
            if not tr.placed:
                bad("FINISH of a non-running job")
            tr.placed, tr.finished = False, True
        elif ev.code == BACKFILL:
            if not tr.placed:
                bad("BACKFILL marker without a placement")


def events_of_job(events: Iterable[Event], job: int) -> List[Event]:
    return [e for e in events if e.job == job]
