"""Request lifecycle + admission scheduling (``bigdl_tpu/serving/
scheduler.py``, a copy of its pure-Python core).

The scheduler owns the waiting queue and the WAITING → RUNNING →
FINISHED lifecycle; the engine owns the tensors. Under chunked admission
(``chunked.py``) a request passes through PARTIAL between WAITING and
RUNNING: it owns a KV slot while its prompt streams in, but only
``activate()`` adds it to the ``running`` table the decode step reads.
Requests leave the queue without running as CANCELLED or SHED.

Policies:

* ``"prefill_priority"`` (default) — before every decode step, waiting
  requests are admitted into free slots in arrival order (continuous
  batching);
* ``"fifo"`` — slots refill only once the whole batch drained
  (run-to-completion, the static-batch baseline);
* ``"priority"`` — continuous refill in (priority DESC, deadline ASC,
  arrival) order: higher ``Request.priority`` first, the earliest
  absolute deadline within a class (EDF), arrival for the rest. Under
  this policy the engine may preempt the lowest-priority running row
  loss-free (``ServingEngine._preempt_row``).

``requeue()`` is the loss-free re-entry point shared by preemption and
fault recovery: the request keeps its original key, hence its place
among same-priority peers, its emitted ``output`` and its counters; only
its slot is given up. With a host KV tier attached (``kv_tier.py``),
victim selection within a priority class goes cold-first: the row whose
last decode is oldest (``note_decoded`` stamps each healthy step).

With an SLO autopilot attached (``autopilot.py``) the priority key's
deadline term becomes least-laxity: ``service_estimate`` (the engine's
measured seconds per token) prices the request's remaining budget, so a
row's urgency is the latest time it can start and still finish. The key
is evaluated when the request enters the queue (``submit``, ``requeue``)
and never re-sorted while it waits. ``finish_time`` stamps every
terminal disposition on the engine clock; the autopilot's goodput
accounting reads it.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bigdl_tpu_torch.serving.sampling import SamplingParams

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"
CANCELLED = "cancelled"
SHED = "shed"
#: mid-prefill rows under chunked admission: slot-bound, not decoding
PARTIAL = "partial"

_POLICIES = ("prefill_priority", "fifo", "priority")

_INF = float("inf")


@dataclass
class Request:
    """One generation request's lifecycle record. ``output`` holds the
    1-based generated ids, ``logprobs`` the chosen tokens' raw model
    log-probs; ``finish_reason`` is set at eviction (``"eos"``,
    ``"stop"``, ``"length"``, ``"shed"``/``"deadline"``/``"infeasible"``
    for load-shed requests, ``"error"`` past the retry budget).
    ``draft_tokens`` is the speculative budget hint (None = the engine's
    ``k``, 0 = plain decode for this request). ``adapter_id`` is the
    request's LoRA bank slot (0 = the null adapter, the base model) and
    ``constraint`` an optional ``TokenDFA``: the engine rebuilds its
    cursor from (this, ``output``) at every (re)admission and never
    checkpoints it.

    Resilience fields: ``priority`` (higher admits first under the
    ``"priority"`` policy), ``deadline_s`` (completion SLO in seconds
    after submit), ``degrade`` (an :class:`~bigdl_tpu_torch.serving.
    admission.Degrade` applied at admission under pressure, revertible
    while the row waits: ``_pre_degrade`` keeps the originals),
    ``preemptions``/``retries``, and ``resume_carry`` — a stashed
    ``KVPool.row_state`` payload restored whole at readmission. Fault
    recovery clears it and replays ``prompt + output`` instead: a
    suspect step's carry is never trusted."""

    req_id: int
    prompt: List[int]                  # 1-based word ids, non-empty
    max_new_tokens: int
    eos_id: int = -1                   # 1-based, -1 = none
    state: str = WAITING
    slot: Optional[int] = None
    next_token: Optional[int] = None   # 0-based token to feed next step
    output: List[int] = field(default_factory=list)   # 1-based ids
    sampling: Optional[SamplingParams] = None
    draft_tokens: Optional[int] = None  # speculative budget hint
    adapter_id: int = 0
    constraint: Optional[object] = None  # constrain.TokenDFA
    logprobs: List[float] = field(default_factory=list)
    finish_reason: Optional[str] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    degrade: Optional[object] = None   # admission.Degrade
    degraded: bool = False
    _pre_degrade: Optional[tuple] = None   # (max_new_tokens, draft_tokens)
    seq: int = -1                      # arrival order, set by submit()
    preemptions: int = 0
    retries: int = 0
    resume_carry: Optional[dict] = None
    _adapter_released: bool = False    # the adapter reference was dropped

    @property
    def deadline_time(self) -> Optional[float]:
        """Absolute completion deadline on the engine's clock."""
        if self.deadline_s is None:
            return None
        return self.submit_time + self.deadline_s

    @property
    def done_reason(self) -> Optional[str]:
        if self.state != FINISHED:
            return None
        if self.finish_reason is not None:
            return self.finish_reason
        if self.output and self.eos_id > 0 and self.output[-1] == self.eos_id:
            return "eos"
        return "length"


class Scheduler:
    """Priority/FIFO admission over a fixed slot pool. The waiting queue
    is a heap of ``[key, req]`` entries; keys are assigned once per
    request (requeue reuses them), so a preempted request re-enters at
    its original position."""

    def __init__(self, policy: str = "prefill_priority",
                 tier=None) -> None:
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r} (one of {_POLICIES})")
        self.policy = policy
        #: optional zero-argument callable giving the measured seconds per
        #: emitted token, or None; set by the autopilot's ``attach``. With
        #: one, the priority key orders deadlines by least laxity
        self.service_estimate: Optional[object] = None
        self._waiting: List[list] = []            # heap of [key, req]
        self.running: Dict[int, Request] = {}     # slot -> request
        self.partial: Dict[int, Request] = {}     # slot -> mid-prefill
        self._seq = 0
        # the host tier turns victim selection cold-first; recency is the
        # step number of each slot's last decode (admission stamps the
        # current step: a row seated this step is never its cold victim)
        self.tier = tier
        self._step_no = 0
        self._last_decoded: Dict[int, int] = {}

    def _key(self, req: Request):
        if self.policy != "priority":
            return (0, 0.0, req.seq)
        dl = req.deadline_time
        urgency = _INF if dl is None else dl
        if dl is not None and self.service_estimate is not None:
            est = self.service_estimate()
            if est:
                # least laxity: the latest feasible START, the deadline
                # less the time the remaining budget needs
                rem = max(1, req.max_new_tokens - len(req.output))
                urgency = dl - est * rem
        return (-req.priority, urgency, req.seq)

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("need a non-empty prompt")
        if req.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        if req.seq < 0:
            req.seq = self._seq
            self._seq += 1
        req.state = WAITING
        heapq.heappush(self._waiting, [self._key(req), req])

    def requeue(self, req: Request) -> None:
        """Return an evicted RUNNING (or PARTIAL) request to the queue at
        its original key; the engine frees its KV slot."""
        if req.slot is not None:
            if self.running.get(req.slot) is req:
                del self.running[req.slot]
            else:
                del self.partial[req.slot]
            req.slot = None
        req.state = WAITING
        req.next_token = None
        heapq.heappush(self._waiting, [self._key(req), req])

    def admissible(self, free_slots: int) -> int:
        """How many waiting requests may be admitted right now."""
        if not free_slots or not self._waiting:
            return 0
        if self.policy == "fifo" and (self.running or self.partial):
            return 0          # run-to-completion: wait for a full drain
        return min(free_slots, len(self._waiting))

    def admit(self, slot: int, partial: bool = False) -> Request:
        """Pop the best waiting request and bind it to ``slot``;
        ``partial=True`` binds it mid-prefill (chunked admission)."""
        _, req = heapq.heappop(self._waiting)
        req.slot = slot
        self._last_decoded[slot] = self._step_no
        if partial:
            req.state = PARTIAL
            self.partial[slot] = req
        else:
            req.state = RUNNING
            self.running[slot] = req
        return req

    def activate(self, slot: int) -> Request:
        """Promote a PARTIAL row whose prompt has fully streamed in: it
        decodes from the next step on."""
        req = self.partial.pop(slot)
        req.state = RUNNING
        self.running[slot] = req
        self._last_decoded[slot] = self._step_no
        return req

    def note_decoded(self, slots) -> None:
        """Stamp one healthy decode/verify step for ``slots``: the
        recency behind cold-first victim selection."""
        self._step_no += 1
        for slot in slots:
            self._last_decoded[slot] = self._step_no

    # -- the priority surface of the engine's preemption loop ----------------

    def top_waiting(self) -> Optional[Request]:
        """The request the next ``admit()`` would pop, or None."""
        return self._waiting[0][1] if self._waiting else None

    def waiting_higher_than(self, priority: int) -> int:
        """Waiting requests that strictly outrank ``priority``."""
        return sum(1 for _, r in self._waiting if r.priority > priority)

    def lowest_running(self) -> Optional[Request]:
        """The preemption victim candidate: the lowest-priority running
        row; within a class the coldest (oldest last decode) with a host
        tier attached, else the most recent arrival (least time in a
        slot). PARTIAL rows are never candidates."""
        if not self.running:
            return None
        if self.tier is not None:
            return min(self.running.values(),
                       key=lambda r: (r.priority,
                                      self._last_decoded.get(r.slot, -1),
                                      -r.seq))
        return min(self.running.values(), key=lambda r: (r.priority, -r.seq))

    def peek_waiting(self, n: int) -> List[Request]:
        """The ``n`` requests the next ``n`` ``admit()`` calls would pop,
        in order, without popping them."""
        return [r for _, r in heapq.nsmallest(n, self._waiting)]

    def iter_waiting(self):
        """WAITING requests in heap order. Mutating budget fields is
        safe (keys never depend on them); priority, deadline and seq are
        not."""
        for _, req in self._waiting:
            yield req

    def pop_waiting(self, pred) -> List[Request]:
        """Remove and return every WAITING request ``pred`` selects (the
        survivors keep their order)."""
        keep, dropped = [], []
        for entry in self._waiting:
            (dropped if pred(entry[1]) else keep).append(entry)
        if dropped:
            self._waiting = keep
            heapq.heapify(self._waiting)
        return [req for _, req in dropped]

    def pop_expired(self, now: float) -> List[Request]:
        """Remove and return WAITING requests whose deadline has passed."""
        return self.pop_waiting(
            lambda r: r.deadline_time is not None and now > r.deadline_time)

    # -- cancellation ---------------------------------------------------------

    def cancel(self, req_id: int) -> Optional[Request]:
        """Dequeue a WAITING request (now CANCELLED), or None if it is
        not waiting."""
        for i, (_, req) in enumerate(self._waiting):
            if req.req_id == req_id:
                del self._waiting[i]
                heapq.heapify(self._waiting)
                req.state = CANCELLED
                return req
        return None

    def cancel_running(self, req_id: int) -> Optional[Request]:
        """Unbind a RUNNING or PARTIAL request (now CANCELLED); its slot
        id stays on the request for the engine to free. None if neither."""
        for table in (self.running, self.partial):
            for slot, req in table.items():
                if req.req_id == req_id:
                    del table[slot]
                    req.state = CANCELLED
                    return req
        return None

    def finish(self, req: Request, now: float) -> int:
        """Mark finished at engine-clock time ``now`` (a RUNNING row, or a
        PARTIAL row erroring out); returns the freed slot id."""
        slot = req.slot
        if self.running.get(slot) is req:
            del self.running[slot]
        else:
            del self.partial[slot]
        req.state = FINISHED
        req.slot = None
        req.finish_time = now
        return slot

    @property
    def waiting(self) -> List[Request]:
        """Waiting requests in admission order (a sorted view)."""
        return [r for _, r in sorted(self._waiting, key=lambda e: e[0])]

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    @property
    def active(self) -> int:
        """Slot-holding requests: decoding plus mid-prefill rows."""
        return len(self.running) + len(self.partial)

    def idle(self) -> bool:
        return not self._waiting and not self.running and not self.partial
