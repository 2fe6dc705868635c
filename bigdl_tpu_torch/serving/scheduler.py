"""Request lifecycle + admission scheduling (``bigdl_tpu/serving/
scheduler.py``, a copy of its pure-Python core for the slice's policies).

The scheduler owns the waiting queue and the WAITING → RUNNING →
FINISHED lifecycle; the engine owns the tensors. Policies:

* ``"prefill_priority"`` (default) — before every decode step, waiting
  requests are admitted into free slots in arrival order (continuous
  batching);
* ``"fifo"`` — slots refill only once the whole running batch drained
  (run-to-completion, the static-batch baseline).

``requeue()`` is the loss-free re-entry point of fault recovery: the
request keeps its arrival position, its emitted ``output`` and its retry
counter; only its slot is given up. The ``"priority"`` policy and
preemption come with the resilience slice.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from bigdl_tpu_torch.serving.sampling import SamplingParams

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"

_POLICIES = ("prefill_priority", "fifo")


@dataclass
class Request:
    """One generation request's lifecycle record. ``output`` holds the
    1-based generated ids, ``logprobs`` the chosen tokens' raw model
    log-probs, ``finish_reason`` is set at eviction (``"eos"``,
    ``"stop"``, ``"length"`` or ``"error"``)."""

    req_id: int
    prompt: List[int]                  # 1-based word ids, non-empty
    max_new_tokens: int
    eos_id: int = -1                   # 1-based, -1 = none
    state: str = WAITING
    slot: Optional[int] = None
    next_token: Optional[int] = None   # 0-based token to feed next step
    output: List[int] = field(default_factory=list)   # 1-based ids
    sampling: Optional[SamplingParams] = None
    logprobs: List[float] = field(default_factory=list)
    finish_reason: Optional[str] = None
    submit_time: float = 0.0
    first_token_time: Optional[float] = None
    seq: int = -1                      # arrival order, set by submit()
    retries: int = 0


class Scheduler:
    """FIFO admission over a fixed slot pool. The waiting queue is a heap
    of ``[key, req]`` entries whose key is the arrival order, assigned
    once per request (requeue reuses it)."""

    def __init__(self, policy: str = "prefill_priority") -> None:
        if policy not in _POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r} (one of {_POLICIES})")
        self.policy = policy
        self._waiting: List[list] = []            # heap of [seq, req]
        self.running: Dict[int, Request] = {}     # slot -> request
        self._seq = 0

    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("need a non-empty prompt")
        if req.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        if req.seq < 0:
            req.seq = self._seq
            self._seq += 1
        req.state = WAITING
        heapq.heappush(self._waiting, [req.seq, req])

    def requeue(self, req: Request) -> None:
        """Return an evicted RUNNING request to the queue at its original
        arrival position; the engine frees its KV slot."""
        if req.slot is not None:
            del self.running[req.slot]
            req.slot = None
        req.state = WAITING
        req.next_token = None
        heapq.heappush(self._waiting, [req.seq, req])

    def admissible(self, free_slots: int) -> int:
        """How many waiting requests may be admitted right now."""
        if not free_slots or not self._waiting:
            return 0
        if self.policy == "fifo" and self.running:
            return 0          # run-to-completion: wait for a full drain
        return min(free_slots, len(self._waiting))

    def admit(self, slot: int) -> Request:
        """Pop the oldest waiting request and bind it to ``slot``."""
        _, req = heapq.heappop(self._waiting)
        req.slot = slot
        req.state = RUNNING
        self.running[slot] = req
        return req

    def finish(self, req: Request) -> int:
        """Mark finished; returns the freed slot id."""
        slot = req.slot
        del self.running[slot]
        req.state = FINISHED
        req.slot = None
        return slot

    @property
    def queue_depth(self) -> int:
        return len(self._waiting)

    def idle(self) -> bool:
        return not self._waiting and not self.running
