"""Continuous-batching serving engine for :func:`TransformerLM`
(``bigdl_tpu/serving/engine.py``).

:class:`ServingEngine` serves many independent requests from one pooled
KV cache (:class:`~bigdl_tpu_torch.serving.kv_pool.KVPool`) stepped by
one per-row-position decode step with the per-row sampler fused in
(:func:`~bigdl_tpu_torch.models.transformer.make_batch_decode_step`):

* requests are ``submit()``-ed at any time; the scheduler orders them
  FIFO, run-to-completion, or by (priority, deadline, arrival);
* before every decode step waiting requests are admitted into free
  slots. ``admission="batched"`` prefills them in power-of-two length
  buckets, one masked multi-row prefill call per bucket, optionally
  through a shared-prefix cache; ``"chunked"`` binds them at once and
  streams their prompts in ``chunk_budget``-token chunks between decode
  steps; ``"per_request"`` prefills each prompt alone
  (``admission.py``, ``chunked.py``, ``prefix_cache.py``);
* every ``step()`` decodes one token for ALL running rows at once and
  reads back only the chosen token ids and their log-probs, in one
  batched readback (``fences.py``). With ``dispatch_ahead=W`` up to W
  further steps are dispatched, each chained on the previous step's
  device tokens, before a step's readback is consumed: the decode step
  reads nothing back itself, so the card runs ahead of the host's
  bookkeeping. ``W=0`` consumes each step's readback in the step;
* ``speculative=SpeculativeConfig(draft, k)`` replaces the decode step
  by a draft-and-verify super-step that emits 1 to ``k + 1`` tokens per
  row (``speculative.py``);
* ``adapters=AdapterBank(...)`` serves many LoRA tenants over one set of
  base weights: each request's ``adapter_id`` selects its bank slot, a
  per-row runtime input of the same steps (0 = the null adapter, exactly
  the base model); ``submit(constraint=TokenDFA)`` masks a row's sampler
  to the tokens its automaton allows, one host-side cursor step per
  emitted token (``lora.py``, ``constrain.py``);
* rows leave at eos, a stop token or sequence, or ``max_new_tokens``,
  and their slot returns to the free list for the next admission.

Each request carries its own :class:`~bigdl_tpu_torch.serving.sampling.
SamplingParams` and its own counter-based RNG lane, so greedy and
sampled rows mix in one step, and a seeded request replays its stream
whatever its neighbours or its slot.

Resilience, all host-side:

* ``policy="priority"`` preempts loss-free: when waiting requests
  outrank the lowest-priority running row and no slot is free, the row's
  whole ``row_state`` is stashed on the request (and shared into the
  prefix cache), the slot freed, and the request requeued at its
  original key; readmission restores the stash bitwise;
* ``max_queue`` sheds at the door past a waiting backlog, expired
  waiters are dropped (``"deadline"``), ``deadline_feasibility`` drops
  waiters the measured step time says cannot finish (``"infeasible"``),
  and ``degrade_at`` applies a request's :class:`Degrade` under pressure
  (reverted if the row still waits when pressure drops);
* the step-health check discards a step whose outputs are non-finite or
  out of range, that raised, or that overran the watchdog's timeout, and
  replays its rows from ``prompt + output``; past ``max_retries`` a
  request finishes with ``"error"``, so the engine never wedges;
* ``tier=`` (True, or a :class:`~bigdl_tpu_torch.serving.kv_tier.
  TieredKVStore`) parks preempted rows in host memory as packed wire
  bytes under a byte budget instead of on the request, fetches them back
  currency-checked at readmission (prefetched before admission touches
  the card), demotes the prefix cache's evicted entries there, and turns
  victim selection cold-first; every terminal disposition drops the
  request's entry;
* every device dispatch goes through :meth:`_dispatch` (sites
  ``"decode"`` and ``"prefill"``), where a seeded
  :class:`~bigdl_tpu_torch.serving.faults.FaultInjector` may fail,
  corrupt or stall it; every time read goes through the one engine
  clock (``clock=``, a ``VirtualClock`` in tests).

``kv_dtype="int8"`` stores the pooled K/V as per-(slot, head)-scaled
int8 and reads it through the hand-written CUDA decode-attention kernel
on the card (its plain version on the CPU) in every admission mode. The
engine runs on ``cuda`` unless ``device="cpu"`` is passed; the model
must live on that device. Knobs of the JAX engine that the port does not
carry yet raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.models.transformer import (
    make_batch_decode_step, make_batch_prefill_step, make_prefill_step,
    serving_params,
)
from bigdl_tpu_torch.serving.admission import (
    AdmissionController, PerRequestAdmissionController,
)
from bigdl_tpu_torch.serving.chunked import ChunkedAdmissionController
from bigdl_tpu_torch.serving.faults import (
    FaultError, WatchdogConfig, default_clock,
)
from bigdl_tpu_torch.serving.fences import start_readback
from bigdl_tpu_torch.serving.kv_pool import KVPool
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache
from bigdl_tpu_torch.serving.sampling import (
    SamplingParams, advance_lane, fold_lane, knob_row_values, lane_key,
    make_knob_rows, match_stop_sequences,
)
from bigdl_tpu_torch.serving.scheduler import (
    FINISHED, SHED, WAITING, Request, Scheduler,
)
from bigdl_tpu_torch.utils.device import resolve_device

#: JAX-engine knobs the port does not carry yet, with their ROADMAP.md item
_NOT_PORTED = {
    "mesh": "A.2.g sharded serving (serving/sharded.py)",
    "parallelism": "A.2.g sharded serving (serving/sharded.py)",
    "autopilot": "A.2.i SLO autopilot (serving/autopilot.py)",
}


class _InFlight:
    """One dispatched-but-not-yet-consumed decode step of the dispatch-ahead
    window: its device outputs (``tok`` feeds a chained dispatch), the
    started readback of ``(tok, chosen)`` the delayed consumer waits on,
    and the host facts frozen at dispatch (the active mask and its device
    twin, the row snapshot, the pre-dispatch clock read the watchdog's
    elapsed runs from, the sampled-row count, and whether rows were
    already in flight — the decode-gap anchor)."""

    __slots__ = ("tok", "readback", "active", "active_dev", "rows", "t0",
                 "n_sampled", "had_running")

    def __init__(self, tok, readback, active, active_dev, rows, t0,
                 n_sampled, had_running):
        self.tok = tok
        self.readback = readback
        self.active = active
        self.active_dev = active_dev
        self.rows = rows
        self.t0 = t0
        self.n_sampled = n_sampled
        self.had_running = had_running


class ServingEngine:
    """Continuous-batching per-row-sampled decoder over a pooled KV cache.

    ``n_slots`` is the decode capacity; ``compute_dtype`` the serving
    precision of weights and float KV (e.g. ``torch.bfloat16``; scores
    and log-softmax stay f32); ``kv_dtype`` ``"fp32"``/``"bf16"`` (must
    match ``compute_dtype``) or ``"int8"``; ``policy``
    ``"prefill_priority"``, ``"fifo"`` or ``"priority"`` (with
    ``preemption``, on by default under it); ``admission``
    ``"batched"``, ``"chunked"`` (with ``chunk_budget``, default 32) or
    ``"per_request"``; ``prefix_cache`` True or a :class:`PrefixCache`
    (batched or chunked admission only); ``seed`` the base of the RNG
    lanes of requests without their own seed; ``watchdog`` bounds step
    time and per-request retries; ``faults`` a ``FaultInjector``;
    ``clock`` the engine's time source; ``max_queue``, ``degrade_at``
    and ``deadline_feasibility`` the overload controls;
    ``dispatch_ahead`` the decode dispatches kept in flight beyond the
    one being consumed; ``speculative`` a :class:`SpeculativeConfig` (or
    a bare draft model); ``adapters`` an :class:`~bigdl_tpu_torch.serving.
    lora.AdapterBank` over this model (batched or chunked admission
    only); ``tier`` True or a :class:`~bigdl_tpu_torch.serving.kv_tier.
    TieredKVStore` (the host spill tier); ``keep_finished``
    bounds the finished ledger; ``metrics`` a :class:`ServingMetrics` to
    record into; ``device`` defaults to ``cuda``."""

    def __init__(self, model, n_slots: int = 8, compute_dtype=None,
                 policy: str = "prefill_priority",
                 metrics: Optional[ServingMetrics] = None,
                 admission: str = "batched",
                 chunk_budget: Optional[int] = None,
                 deadline_feasibility: bool = False,
                 prefix_cache=None,
                 keep_finished: Optional[int] = None,
                 seed: int = 0,
                 kv_dtype: Optional[str] = None,
                 clock=None,
                 max_queue: Optional[int] = None,
                 degrade_at: Optional[int] = None,
                 preemption: Optional[bool] = None,
                 watchdog: Optional[WatchdogConfig] = None,
                 faults=None,
                 dispatch_ahead: int = 0,
                 speculative=None,
                 adapters=None,
                 tier=None,
                 device=None,
                 **not_ported) -> None:
        for knob, value in not_ported.items():
            if knob not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {knob!r}")
            if value not in (None, False):
                raise NotImplementedError(
                    f"{knob}= is not ported yet: ROADMAP.md {_NOT_PORTED[knob]}")
        if admission not in ("batched", "per_request", "chunked"):
            raise ValueError(
                f"unknown admission mode {admission!r} "
                "(one of 'batched', 'per_request', 'chunked')")
        if chunk_budget is not None:
            if admission != "chunked":
                raise ValueError(
                    "chunk_budget requires admission='chunked' — it is "
                    "the streaming pump's per-step token budget")
            if int(chunk_budget) < 1:
                raise ValueError(
                    f"chunk_budget must be >= 1, got {chunk_budget}")
        if prefix_cache and admission == "per_request":
            raise ValueError(
                "prefix_cache requires admission='batched' or 'chunked' "
                "(the per-request prefill cannot continue from a cached "
                "carry)")
        if keep_finished is not None and keep_finished < 0:
            raise ValueError(
                f"keep_finished must be >= 0 or None, got {keep_finished}")
        if max_queue is not None and max_queue < 0:
            raise ValueError(
                f"max_queue must be >= 0 or None, got {max_queue}")
        if degrade_at is not None and degrade_at < 0:
            raise ValueError(
                f"degrade_at must be >= 0 or None, got {degrade_at}")
        if int(dispatch_ahead) < 0:
            raise ValueError(
                f"dispatch_ahead must be >= 0, got {dispatch_ahead}")
        if preemption and policy != "priority":
            raise ValueError(
                "preemption=True requires policy='priority' — victim "
                "selection is a priority-order decision")
        if adapters is not None and admission == "per_request":
            raise ValueError(
                "adapters require admission='batched' or 'chunked' — "
                "the per-request prefill has no adapter arguments")
        # multi-tenant LoRA: the steps take the rows' adapter ids and the
        # bank as runtime inputs; the bank's device copy is cached against
        # its version, the ids' against the pool's host row
        self.adapters = adapters
        self._adapter_spec = None if adapters is None else adapters.spec
        self._bank_device = None
        self._bank_version = None
        self._ids_host: Optional[np.ndarray] = None
        self._ids_device = None
        self.device = resolve_device(device)
        model_dev = model[0].weight.device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(
                f"the model lives on {model_dev} but the engine runs on "
                f"{self.device} — build the model with the same device")
        # the engine's ONE time source, the watchdog and the injector
        self._clock = clock if clock is not None else default_clock
        self.watchdog = watchdog if watchdog is not None \
            else WatchdogConfig()
        self._faults = faults
        self.max_queue = max_queue
        self.degrade_at = degrade_at
        self.preemption = (policy == "priority") if preemption is None \
            else bool(preemption)
        self.deadline_feasibility = bool(deadline_feasibility)
        self.keep_finished = keep_finished
        self.model = model
        self.max_len = model[1].max_len
        self._vocab = model[0].n_index
        self.compute_dtype = compute_dtype
        float_kv = {torch.float32: "fp32", torch.bfloat16: "bf16"}.get(
            compute_dtype or torch.float32, str(compute_dtype))
        if kv_dtype is None:
            kv_dtype = float_kv
        elif kv_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r} (one of 'fp32', 'bf16', "
                "'int8')")
        if kv_dtype != "int8" and kv_dtype != float_kv:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} conflicts with compute_dtype="
                f"{compute_dtype!r} (the float KV cache stores the serving "
                f"dtype, {float_kv!r} here)")
        self.kv_dtype = kv_dtype
        kv_quant = kv_dtype == "int8"
        self.params = serving_params(model, compute_dtype)
        # the sampled pooled step is the one decode step; a SPECULATIVE
        # engine runs the fixed-width verify step instead, over the same
        # carry layout, with the draft's carry attached to the pool
        if speculative is None:
            self._spec = None
            self._step_fn, self._pool_init = make_batch_decode_step(
                model, compute_dtype, sampling=True, kv_quant=kv_quant,
                adapter=self._adapter_spec)
        else:
            from bigdl_tpu_torch.serving.speculative import Speculator

            self._spec = Speculator(self, speculative, kv_quant=kv_quant)
            self._step_fn = None
            self._pool_init = self._spec.pool_init
        self.pool = KVPool(self._pool_init, n_slots, kv_dtype=kv_dtype)
        if self._spec is not None:
            self._spec.attach_pool(self.pool)
        # the host spill tier: True builds a default one, an instance is
        # shared as is (a disaggregated plane passes ONE to every pool)
        if tier is True:
            from bigdl_tpu_torch.serving.kv_tier import TieredKVStore

            tier = TieredKVStore()
        self.tier = tier or None
        self.scheduler = Scheduler(policy, tier=self.tier)
        self.metrics = metrics if metrics is not None else ServingMetrics()
        if self.tier is not None:
            self.tier.attach_metrics(self.metrics, clock=self._clock)
        self.metrics.set_kv_format(kv_dtype, self.pool.kv_bytes_per_slot)
        self.admission = admission
        if admission == "per_request":
            self.prefix_cache = None
            self._prefill_fn = make_prefill_step(model, compute_dtype,
                                                 kv_quant=kv_quant)
            self.admitter = PerRequestAdmissionController(self)
        else:
            self._batch_prefill_fn = make_batch_prefill_step(
                model, compute_dtype, kv_quant=kv_quant,
                adapter=self._adapter_spec)
            # True -> a default cache, None/False -> off, else the instance
            self.prefix_cache = (PrefixCache() if prefix_cache is True
                                 else (prefix_cache or None))
            if self.prefix_cache is not None:
                # evicted entries demote to the engine's tier (a cache
                # built with its own keeps it); promotions land here
                if self.tier is not None and self.prefix_cache.tier is None:
                    self.prefix_cache.tier = self.tier
                self.prefix_cache.device = self.device
            if admission == "chunked":
                self.admitter = ChunkedAdmissionController(
                    self, chunk_budget=chunk_budget or 32,
                    prefix_cache=self.prefix_cache)
            else:
                self.admitter = AdmissionController(
                    self, prefix_cache=self.prefix_cache)
        self.seed = int(seed)
        # the allow mask always rides (all-True = unconstrained): one knob
        # layout for every engine
        self._knobs = make_knob_rows(n_slots, vocab=self._vocab)
        self._knobs_device = None       # re-uploaded only after a change
        # live constraint cursors by slot, rebuilt from (constraint,
        # output) at every (re)admission, never checkpointed
        self._constraints: Dict[int, object] = {}
        self._ban_base = np.zeros((n_slots,), bool)
        self._configured: set = set()
        # slots whose occupant arrived as a whole row_state payload: its
        # lane and penalty state came with it, so configuring the slot
        # sets the host knob rows only
        self._restored: set = set()
        self._warm = False              # arms the watchdog timeout
        # engine-clock time of the last healthy decode dispatch, None
        # while no rows are in flight: the anchor of decode_gap_s
        self._last_decode_end: Optional[float] = None
        self._next_id = 0
        self._finished: Dict[int, Request] = {}
        # the dispatch-ahead window: up to ``dispatch_ahead`` decode
        # dispatches stay in flight behind the one being consumed, each
        # chained on the previous dispatch's device token tensor, so the
        # readback of step N overlaps the device work of steps N+1..N+W.
        # _InFlight entries, oldest first; W=0 consumes each entry in the
        # step that dispatched it (the engine without a window)
        self.dispatch_ahead = int(dispatch_ahead)
        self._window: deque = deque()

    # -- request surface ---------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 32,
               eos_id: int = -1, sampling: Optional[SamplingParams] = None,
               draft_tokens: Optional[int] = None, priority: int = 0,
               deadline_s: Optional[float] = None, degrade=None,
               adapter_id: int = 0, constraint=None) -> int:
        """Queue one generation request (1-based prompt ids); returns its
        request id. ``eos_id`` is the request's own eos (1-based, -1 =
        none); ``sampling.max_tokens`` overrides ``max_new_tokens``;
        ``priority`` orders the queue under ``policy="priority"``;
        ``deadline_s`` is the completion SLO in seconds after submit;
        ``degrade`` a :class:`Degrade` applied under pressure;
        ``draft_tokens`` the speculative budget hint (None = the engine's
        ``k``, 0 = plain decode for this request, n = at most n drafts
        per super-step; ignored by a plain engine); ``adapter_id`` the
        request's slot in the engine's AdapterBank (0 = the base model;
        a live id is retained until the request leaves; on a speculative
        engine it needs ``draft_tokens=0``, since drafts come from a model
        with no adapter); ``constraint`` a ``TokenDFA`` whose cursor
        masks the row's sampler (a constrained row drafts nothing: the
        mask is per position). Raises if the request could overflow the
        cache. Past ``max_queue`` the
        request is shed: it lands in the finished ledger with
        ``finish_reason="shed"`` and empty output."""
        if draft_tokens is not None and int(draft_tokens) < 0:
            raise ValueError(
                f"draft_tokens must be >= 0 or None, got {draft_tokens}")
        adapter_id = int(adapter_id)
        if adapter_id:
            if self.adapters is None:
                raise ValueError(
                    f"adapter_id={adapter_id} but this engine has no "
                    "AdapterBank (pass adapters= at construction)")
            if not self.adapters.is_live(adapter_id):
                raise ValueError(
                    f"adapter id {adapter_id} is not allocated in the "
                    "bank (alloc() it first, or use 0 = base model)")
            if self._spec is not None and (draft_tokens is None
                                           or int(draft_tokens) > 0):
                raise ValueError(
                    "adapted requests on a speculative engine must "
                    "submit draft_tokens=0 — drafts are pinned to the "
                    "null adapter, and a base-model draft chain under "
                    "an adapted target would corrupt accept-rate "
                    "accounting")
        if constraint is not None and not hasattr(constraint, "cursor"):
            raise ValueError(
                "constraint must be a TokenDFA-like object with a "
                ".cursor(prefix) method (serving/constrain.py)")
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("need a non-empty prompt")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(
                f"deadline_s must be positive or None, got {deadline_s}")
        sp = sampling if sampling is not None else SamplingParams()
        if sp.max_tokens is not None:
            max_new_tokens = sp.max_tokens
        if max_new_tokens <= 0:
            raise ValueError(
                f"max_new_tokens must be positive, got {max_new_tokens}")
        if len(prompt) - 1 + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's max_len "
                f"{self.max_len}")
        # every validation precedes the submitted counter and the shed
        rid = self._next_id
        self._next_id += 1
        req = Request(req_id=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), eos_id=int(eos_id),
                      sampling=sp, priority=int(priority),
                      draft_tokens=None if draft_tokens is None
                      else int(draft_tokens),
                      deadline_s=None if deadline_s is None
                      else float(deadline_s),
                      degrade=degrade, adapter_id=adapter_id,
                      constraint=constraint, submit_time=self._clock())
        # the adapter slot is held until the request leaves (released on
        # every terminal path: finish, error, shed, deadline, cancel)
        if adapter_id:
            self.adapters.retain(adapter_id)
        self.metrics.on_submit()
        # the bound is on the BACKLOG beyond what the free slots absorb
        # at the next admission: an idle engine never sheds
        if self.max_queue is not None \
                and (self.scheduler.queue_depth - self.pool.free_slots
                     >= self.max_queue):
            self._shed(req, "shed")
            return rid
        self.scheduler.submit(req)
        return rid

    def result(self, req_id: int) -> Optional[np.ndarray]:
        """Generated 1-based ids of a finished (or shed, cancelled)
        request, else None — also None once evicted from the ledger."""
        req = self._finished.get(req_id)
        return None if req is None else np.asarray(req.output, np.int32)

    def pop_result(self, req_id: int) -> Optional[np.ndarray]:
        """Like :meth:`result`, but releases the ledger entry."""
        req = self._finished.pop(req_id, None)
        return None if req is None else np.asarray(req.output, np.int32)

    def logprobs(self, req_id: int) -> Optional[np.ndarray]:
        """Chosen-token raw model log-probs of a finished request."""
        req = self._finished.get(req_id)
        return None if req is None else np.asarray(req.logprobs, np.float32)

    def cancel(self, req_id: int) -> bool:
        """Cancel a WAITING, PARTIAL or RUNNING request: a waiting one
        never takes a slot; a slot-holding one frees its slot now and
        emits nothing more. It lands in the ledger as 'cancelled' with
        what it had emitted. False for a finished or unknown request."""
        req = self.scheduler.cancel(req_id)
        if req is None:
            req = self.scheduler.cancel_running(req_id)
            if req is None:
                return False
            slot, req.slot = req.slot, None
            self.pool.free(slot)
            self._configured.discard(slot)
            self._restored.discard(slot)
            self._constraints.pop(slot, None)
            self.admitter.drop(slot)
        req.resume_carry = None          # a stash must not outlive it
        self._drop_tier_row(req)
        self._release_adapter(req)
        self.metrics.on_cancel()
        self.metrics.on_finish_reason("cancelled")
        self._finished[req_id] = req
        self._evict_finished()
        return True

    def request(self, req_id: int) -> Optional[Request]:
        return self._finished.get(req_id)

    def summary(self) -> Dict[str, float]:
        """The serving counters (:meth:`ServingMetrics.summary`)."""
        return self.metrics.summary()

    def _evict_finished(self) -> None:
        # insertion order is finish order: evict oldest first
        if self.keep_finished is None:
            return
        while len(self._finished) > self.keep_finished:
            self._finished.pop(next(iter(self._finished)))

    # -- admission ------------------------------------------------------------

    def _admit(self) -> None:
        now = self._clock()
        for req in self.scheduler.pop_expired(now):
            self._shed(req, "deadline")
        # the revert half of degrade: once the queue is back below the
        # threshold, still-waiting degraded rows get their limits back
        if (self.degrade_at is not None
                and self.scheduler.queue_depth < self.degrade_at):
            for req in self.scheduler.iter_waiting():
                self._restore_degrade(req)
        if self.deadline_feasibility:
            est = self.metrics.service_time_estimate()
            if est is not None:
                def _infeasible(req: Request) -> bool:
                    dl = req.deadline_time
                    if dl is None:
                        return False
                    # price the budget the request would get: a degrade
                    # that applies at this admission caps it
                    cap = req.max_new_tokens
                    if (req.degrade is not None and not req.degraded
                            and not req.output
                            and self.degrade_at is not None
                            and self.scheduler.queue_depth
                            >= self.degrade_at
                            and req.degrade.max_new_tokens is not None):
                        cap = min(cap, int(req.degrade.max_new_tokens))
                    return now + est * (cap - len(req.output)) > dl

                for req in self.scheduler.pop_waiting(_infeasible):
                    self.metrics.on_infeasible()
                    self._shed(req, "infeasible")
        # loss-free preemption: evict lowest-priority running rows while
        # strictly higher-priority requests wait without a free slot
        if self.preemption:
            while True:
                victim = self.scheduler.lowest_running()
                if victim is None:
                    break
                demand = self.scheduler.waiting_higher_than(victim.priority)
                if demand <= self.pool.free_slots:
                    break
                if self._window:
                    # with dispatches in flight the victim's device state
                    # is up to W positions ahead of its emitted tokens: a
                    # stash now would resume it out of step. Flush, then
                    # choose again (the flush may finish the victim)
                    self._drain_window({})
                    continue
                self._preempt_row(victim)
        n = self.scheduler.admissible(self.pool.free_slots)
        if n:
            if self.tier is not None:
                # decode the wave's tier blobs before admission touches
                # the card
                self.tier.prefetch(self.scheduler.peek_waiting(n))
            self.admitter.admit(n)

    def _admitted_prefill_tokens(self, req: Request) -> List[int]:
        """0-based tokens whose K/V must be resident before ``req``
        decodes: the prompt plus everything already emitted (the replay
        source of an evicted row). Applies the degrade knob under
        pressure, sets ``req.next_token`` to the last fed token and
        returns everything before it."""
        self._maybe_degrade(req)
        fed0 = [t - 1 for t in req.prompt] + [t - 1 for t in req.output]
        req.next_token = fed0[-1]
        return fed0[:-1]

    def _spill_or_carry(self, req: Request, payload: Optional[dict]) -> None:
        """Park a row's ``row_state`` payload for readmission: into the
        host tier when one backs this engine, else on
        ``req.resume_carry``."""
        if payload is None:
            return
        if self.tier is not None:
            self.tier.put_row(req, payload)
        else:
            req.resume_carry = payload

    def _resume_payload(self, req: Request) -> Optional[dict]:
        """A readmitted request's stash (its ``resume_carry``, else a
        current copy in the tier), or None (then it replays ``prompt +
        output`` through prefill)."""
        payload = req.resume_carry
        if payload is None and self.tier is not None:
            payload = self.tier.fetch_row(req)
        if payload is not None and req.output:
            self.metrics.on_resume_without_prefill()
        return payload

    # -- overload: shedding and degradation -----------------------------------

    def _shed(self, req: Request, reason: str) -> None:
        """Ledger a request that never ran (``"shed"`` at submit,
        ``"deadline"``, ``"infeasible"``), dropping any stash it carries
        so the ledger pins no device tensors."""
        self._release_adapter(req)
        req.state = SHED
        req.finish_reason = reason
        req.resume_carry = None
        self._drop_tier_row(req)
        self._finished[req.req_id] = req
        self._evict_finished()
        self.metrics.on_finish_reason(reason)
        self.metrics.on_shed(deadline=reason in ("deadline", "infeasible"))

    def _maybe_degrade(self, req: Request) -> None:
        """Apply the request's degrade knob at its FIRST admission when
        the waiting queue is at or past ``degrade_at``."""
        if (req.degrade is None or req.degraded or req.output
                or self.degrade_at is None
                or self.scheduler.queue_depth < self.degrade_at):
            return
        self._apply_degrade(req)

    def _apply_degrade(self, req: Request) -> bool:
        """The one degrade writer: clamp to the request's :class:`Degrade`
        and record the originals so the clamp can be reverted."""
        d = req.degrade
        if d is None or req.degraded:
            return False
        req._pre_degrade = (req.max_new_tokens, req.draft_tokens)
        if d.max_new_tokens is not None:
            req.max_new_tokens = min(req.max_new_tokens,
                                     int(d.max_new_tokens))
        if d.draft_tokens is not None:
            req.draft_tokens = int(d.draft_tokens)
        req.degraded = True
        self.metrics.on_degrade()
        return True

    def _restore_degrade(self, req: Request) -> bool:
        """Revert :meth:`_apply_degrade` for a still-WAITING row, never
        below what it already emitted."""
        if (not req.degraded or req._pre_degrade is None
                or req.state != WAITING):
            return False
        mnt, dt = req._pre_degrade
        req.max_new_tokens = max(int(mnt), len(req.output))
        req.draft_tokens = dt
        req._pre_degrade = None
        req.degraded = False
        self.metrics.on_degrade_restored()
        return True

    # -- dispatch, preemption and recovery ------------------------------------

    def _upload(self, a: np.ndarray):
        """A host array as a tensor on the engine's device. On the card
        the copy goes through pinned memory without blocking the host, so
        it does not wait for the work already queued."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _drop_tier_row(self, req: Request) -> None:
        """The tier's twin of ``req.resume_carry = None``: every terminal
        or carry-distrusting disposition drops the request's entry."""
        if self.tier is not None:
            self.tier.drop_row(req.req_id)

    def _dispatch(self, site: str, fn, *args):
        """Every device dispatch of the serving path goes through here,
        so a fault injector can fail, corrupt or stall it."""
        if self._faults is None:
            return fn(*args)
        return self._faults.call(site, fn, *args)

    def _preempt_row(self, victim: Request) -> None:
        """Loss-free preemption of one RUNNING row: stash its whole
        ``row_state`` (fresh copies, restored bitwise at readmission) in
        the tier or on the request, share its carry into the prefix
        cache, free the slot and requeue the request at its original
        key."""
        slot = victim.slot
        if len(victim.prompt) + len(victim.output) > 1:
            payload = self.pool.row_state(slot)
            self._spill_or_carry(victim, payload)
            if self.prefix_cache is not None:
                fed0 = [t - 1 for t in victim.prompt] + \
                       [t - 1 for t in victim.output]
                # in the victim's adapter namespace: its K/V was computed
                # under those factors
                self.prefix_cache.insert(
                    fed0[:-1], payload["carry"],
                    namespace=self._cache_namespace(victim))
        victim.preemptions += 1
        self.scheduler.requeue(victim)
        self.pool.free(slot)
        self._configured.discard(slot)
        self._restored.discard(slot)
        self._constraints.pop(slot, None)
        self.metrics.on_preempt()

    def _recover_rows(self, rows, now: Optional[float] = None) -> None:
        """Evict rows of a failed dispatch for loss-free replay (requeued
        at their original key, their carry and any stash distrusted, so
        they re-prefill ``prompt + output``) or fail them out with
        ``finish_reason='error'`` past the watchdog's retry budget."""
        if now is None:
            now = self._clock()
        for slot, req in rows:
            self._configured.discard(slot)
            self._restored.discard(slot)
            self._constraints.pop(slot, None)
            self.admitter.drop(slot)
            req.retries += 1
            req.resume_carry = None
            self._drop_tier_row(req)     # a suspect step may postdate it
            mr = self.watchdog.max_retries
            if mr is not None and req.retries > mr:
                self._finish_row(req, "error", now)
            else:
                self.scheduler.requeue(req)
                self.pool.free(slot)
                self.metrics.on_retry()

    def _recover_admission(self, rows) -> None:
        """An admission-side prefill faulted: evict exactly its rows."""
        self._recover_rows(rows, self._clock())

    def _recover_step(self, running) -> None:
        """A decode step failed: evict every row it carried."""
        self._recover_rows(list(running.items()), self._clock())

    def _step_unhealthy(self, nxt, lps, active) -> Optional[str]:
        """"garbage" when an active row read back a non-finite log-prob
        or an out-of-range token, else None."""
        if active.any():
            a_tok, a_lp = nxt[active], lps[active]
            if (not np.isfinite(a_lp).all() or (a_tok < 0).any()
                    or (a_tok >= self._vocab).any()):
                return "garbage"
        return None

    def _timed_out(self, elapsed: float) -> bool:
        """The watchdog timeout arms after the first healthy step."""
        to = self.watchdog.step_timeout_s
        return to is not None and self._warm and elapsed > to

    # -- slots and finishing --------------------------------------------------

    def _lane_key(self, req: Request):
        """An explicit seed pins the lane; otherwise it is folded from the
        engine seed and the request id — a function of the REQUEST, never
        of the slot."""
        sp = req.sampling
        if sp.seed is not None:
            return lane_key(sp.seed)
        return fold_lane(self.seed, req.req_id)

    def _configure_slot(self, slot: int, req: Request) -> None:
        """Write one admitted request's knobs into its slot's host rows
        (its adapter id, and its allow mask from a cursor rebuilt from
        ``(constraint, output)``) and, unless the slot was restored from a
        stash, seed its lane and penalty state on the device (and, on a
        speculative engine, prefill its draft cache); a readmitted request
        resumes its lane ``len(output)`` draws on."""
        sp = req.sampling
        scal, ban_row = knob_row_values(sp, req.eos_id)
        for k, v in scal.items():
            self._knobs[k][slot] = v
        self._knobs["ban_ids"][slot] = ban_row
        self._ban_base[slot] = self._knobs["ban"][slot]
        if self._ban_base[slot] and req.output:
            self._knobs["ban"][slot] = len(req.output) < sp.min_tokens
        self.pool.adapter_ids[slot] = req.adapter_id
        # THE replay rule: the cursor is a function of (constraint,
        # emitted prefix); a recycled slot's mask is always overwritten
        self._constraints.pop(slot, None)
        if req.constraint is not None:
            cur = req.constraint.cursor(req.output)
            self._constraints[slot] = cur
            cur.mask_row(self._vocab, out=self._knobs["allow"][slot])
        else:
            self._knobs["allow"][slot] = True
        self._knobs_device = None
        if slot in self._restored:
            self._restored.discard(slot)
        else:
            key = advance_lane(self._lane_key(req), len(req.output))
            self.pool.write_sampling(slot, key, req.prompt,
                                     output_ids=req.output)
            if self._spec is not None:
                # the draft cache ingests the fed stream beside the
                # target's (a FaultError here evicts the row)
                self._spec.prefill_draft(slot, req)
        self._configured.add(slot)

    def _finish_check(self, req: Request) -> Optional[str]:
        """Stop/length verdict for the token just appended."""
        sp = req.sampling
        n_out = len(req.output)
        tok1 = req.output[-1]
        if n_out >= sp.min_tokens:
            if req.eos_id > 0 and tok1 == req.eos_id:
                return "eos"
            if (tok1 in sp.stop_token_ids
                    or match_stop_sequences(req.output, sp.stop_sequences)):
                return "stop"
        if n_out >= req.max_new_tokens:
            return "length"
        return None

    def _finish_row(self, req: Request, reason: str, now: float) -> None:
        """Free a finishing row's slot, then :meth:`_ledger_finish`."""
        freed = self.scheduler.finish(req)
        self.pool.free(freed)
        self._configured.discard(freed)
        self._restored.discard(freed)
        self._constraints.pop(freed, None)
        self._ledger_finish(req, reason, now)

    def _ledger_finish(self, req: Request, reason: str, now: float) -> None:
        """Ledger a finished request: reason counter, latency and
        log-prob, the SLO verdict and the recovery counter. Shared by
        slot-holding rows and slotless ones (a disaggregated handoff
        that errors out past its retry budget)."""
        self._release_adapter(req)
        req.finish_reason = reason
        req.resume_carry = None
        self._drop_tier_row(req)
        req.state = FINISHED
        self._finished[req.req_id] = req
        self._evict_finished()
        self.metrics.on_finish_reason(reason)
        met = None              # an error is neither goodput nor a miss
        if reason != "error":
            dl = req.deadline_time
            met = dl is None or now <= dl
            if req.retries > 0:
                self.metrics.on_recovered()
        self.metrics.on_finish(
            now - req.submit_time, len(req.output),
            mean_logprob=(float(np.mean(req.logprobs))
                          if req.logprobs else None),
            met_deadline=met)

    def _maybe_flip_ban(self, slot: int, req: Request) -> None:
        """The min-tokens ban lifts the step the floor is met."""
        if self._ban_base[slot]:
            ban = len(req.output) < req.sampling.min_tokens
            if ban != self._knobs["ban"][slot]:
                self._knobs["ban"][slot] = ban
                self._knobs_device = None

    def _advance_constraint(self, slot: int, req: Request) -> None:
        """Advance a constrained row's cursor over the token just emitted
        and, when its state moved, rewrite its allow-mask row (the mask is
        a function of the state); no-op for unconstrained rows."""
        cur = self._constraints.get(slot)
        if cur is None:
            return
        state = cur.state
        cur.advance(req.output[-1])
        if cur.state != state:
            cur.mask_row(self._vocab, out=self._knobs["allow"][slot])
            self._knobs_device = None

    # -- the adapter plane -------------------------------------------------

    def _release_adapter(self, req: Request) -> None:
        """Drop the adapter reference :meth:`submit` took, once, from
        whichever terminal path the request leaves by."""
        if req.adapter_id and not req._adapter_released:
            req._adapter_released = True
            self.adapters.free(req.adapter_id)

    def _cache_namespace(self, req: Request) -> int:
        """The prefix-cache namespace of ``req``'s adapter: 0 for the null
        adapter, else its bank slot's current allocation (the request
        holds a reference, so the slot cannot change tenant under it)."""
        return self.adapters.namespace(req.adapter_id) if req.adapter_id \
            else 0

    def _bank_device_arrays(self):
        """The bank on the engine's device, re-uploaded (pinned, without a
        host wait) only when its version moved: a tenant alloc'd or freed.
        Then the prefix cache drops the trees of freed tenants, which no
        request can reach again."""
        if (self._bank_device is None
                or self._bank_version != self.adapters.version):
            self._bank_device = self.adapters.device_arrays(self.device)
            self._bank_version = self.adapters.version
            if self.prefix_cache is not None:
                self.prefix_cache.drop_namespaces(self.adapters.namespaces())
        return self._bank_device

    def _adapter_args(self):
        """The decode/verify dispatch's trailing adapter arguments: ``()``
        without a bank, else ``(per-slot adapter ids, bank)``. The ids
        tensor is re-uploaded only when the pool's host row changed, so
        the step can keep the rows' gathered factors between changes."""
        if self.adapters is None:
            return ()
        ids = self.pool.adapter_ids
        if self._ids_device is None or not np.array_equal(ids,
                                                          self._ids_host):
            self._ids_host = ids.copy()
            self._ids_device = self._upload(ids.astype(np.int64))
        return (self._ids_device, self._bank_device_arrays())

    def _prefill_adapter_args(self, row_adapter_ids):
        """The batched prefill's trailing adapter arguments for one call:
        ``()`` without a bank, else ``(per-ROW ids, bank)`` (prefill rows
        are bucket rows, not pool slots)."""
        if self.adapters is None:
            return ()
        return (self._upload(np.asarray(row_adapter_ids, np.int64)),
                self._bank_device_arrays())

    def _note_decode_gap(self, had_running: bool) -> None:
        """The engine-clock gap since the last healthy decode dispatch,
        when rows stayed in flight across it: the decode-stall sample."""
        now = self._clock()
        if had_running and self._last_decode_end is not None:
            self.metrics.on_decode_gap(now - self._last_decode_end)
        self._last_decode_end = now

    # -- the serving loop --------------------------------------------------

    def _note_host_step(self, t_begin: float, device_before: float,
                        n_samples: int = 1) -> None:
        """Record the step's host residue: its wall time minus the waits
        on the card inside it (``ServingMetrics.DEVICE_PHASES``). A step
        that consumed several window entries (a flush) records the
        residue once and pads with zeros, so the ``host_step_s`` and
        ``decode_step_s`` series stay paired sample for sample."""
        dev = self.metrics.device_seconds - device_before
        self.metrics.add_phase(
            "host_step", max(0.0, (self._clock() - t_begin) - dev))
        for _ in range(max(0, int(n_samples) - 1)):
            self.metrics.add_phase("host_step", 0.0)

    def step(self) -> Dict[int, int]:
        """Admit waiting requests (chunked admission then feeds at most
        ``chunk_budget`` prompt tokens), then decode for every running
        row: one token per row, or up to ``k + 1`` on a speculative
        engine. Returns ``{req_id: 1-based token}`` emitted this step
        (the last token per request when a step lands several; empty when
        idle, when every slot-holding row is still mid-prefill, or while
        the dispatch-ahead window fills). Records one ``host_step_s``
        sample per consumed decode step: the step's wall time minus its
        waits on the card."""
        t_step = self._clock()
        dev0 = self.metrics.device_seconds
        ndec0 = self.metrics.decode_step_count
        try:
            return self._step_impl()
        finally:
            n_new = self.metrics.decode_step_count - ndec0
            if n_new > 0:
                self._note_host_step(t_step, dev0, n_samples=n_new)

    def _account_token(self, slot: int, req: Request, tok0: int,
                       lp: float, now: float,
                       emitted: Dict[int, int]) -> Optional[str]:
        """Host bookkeeping of ONE emitted token (0-based ``tok0``, chosen
        log-prob ``lp``): append it, record it in ``emitted``, stamp the
        first-token latency, and return the finish verdict. The window's
        delayed consumer and the speculative emission loop share it."""
        tok1 = tok0 + 1                      # back to 1-based ids
        req.output.append(tok1)
        req.logprobs.append(lp)
        emitted[req.req_id] = tok1
        if req.first_token_time is None:
            req.first_token_time = now
            self.metrics.on_first_token(now - req.submit_time)
        return self._finish_check(req)

    def _window_open(self, running) -> bool:
        """May this step chain a decode dispatch on the newest in-flight
        one without consuming anything first? Only while nothing the
        in-flight dispatches assumed changed: the same requests in the
        same slots, every slot configured, the device knobs still the
        cached ones, no row whose min-tokens ban may lift at a consume,
        and no constrained row (its mask may change at every consume)."""
        if not self._window or self.dispatch_ahead < 1:
            return False
        if self._knobs_device is None:
            return False
        prev = self._window[-1]
        if len(prev.rows) != len(running):
            return False
        for slot, req in prev.rows.items():
            if running.get(slot) is not req or slot not in self._configured:
                return False
            if slot in self._constraints:
                return False
            if self._ban_base[slot] and self._knobs["ban"][slot]:
                return False
        return True

    def _consume_window(self, emitted: Dict[int, int]) -> bool:
        """THE delayed consumer: wait for the OLDEST in-flight dispatch's
        readback and run its host bookkeeping (health, watchdog, metrics,
        per-token accounting, finish checks). Rows that left ``running``
        since the dispatch have their values discarded. Returns False
        when the entry was unhealthy: its rows are evicted for replay and
        the REST of the window is discarded unconsumed (every newer
        dispatch chained through the poisoned carry)."""
        entry = self._window.popleft()
        t_f = self._clock()
        nxt, lps = entry.readback.wait()
        now = self._clock()
        self.metrics.add_phase("fence_wait", now - t_f)
        # dispatch to readback landed: a stall at dispatch time is inside
        # it however far behind the window consumes
        elapsed = now - entry.t0
        self.metrics.add_phase("decode_step", elapsed)
        running = self.scheduler.running
        rows = {slot: req for slot, req in entry.rows.items()
                if running.get(slot) is req}
        bad = self._step_unhealthy(nxt, lps, entry.active)
        if bad is None and self._timed_out(elapsed):
            bad = "timeout"
        if bad is not None:
            self._window.clear()
            self._recover_step(rows)
            self._last_decode_end = None
            return False
        self._warm = True
        self._note_decode_gap(entry.had_running)
        # recency stamps for the tier's cold-first victim selection
        self.scheduler.note_decoded(list(rows))
        self.metrics.on_step(self.scheduler.queue_depth,
                             self.pool.occupancy(), len(entry.rows))
        self.metrics.on_sample_rows(entry.n_sampled,
                                    len(entry.rows) - entry.n_sampled)
        for slot, req in rows.items():
            tok0 = int(nxt[slot])
            reason = self._account_token(slot, req, tok0, float(lps[slot]),
                                         now, emitted)
            if reason is not None:
                self._finish_row(req, reason, now)
            else:
                req.next_token = tok0
                self._maybe_flip_ban(slot, req)
                self._advance_constraint(slot, req)
        return True

    def _drain_window(self, emitted: Dict[int, int]) -> bool:
        """Consume every in-flight dispatch, oldest first. False when one
        was unhealthy (the consumer then discarded the rest)."""
        while self._window:
            if not self._consume_window(emitted):
                return False
        return True

    def flush_window(self) -> None:
        """Consume every in-flight dispatch outside a step (``drain``'s
        teardown), recording the host/device split as a step would."""
        if not self._window:
            return
        t0 = self._clock()
        dev0 = self.metrics.device_seconds
        ndec0 = self.metrics.decode_step_count
        self._drain_window({})
        n_new = self.metrics.decode_step_count - ndec0
        if n_new > 0:
            self._note_host_step(t0, dev0, n_samples=n_new)

    def _step_impl(self) -> Dict[int, int]:
        emitted: Dict[int, int] = {}
        had_running = bool(self.scheduler.running)
        self._admit()
        self.admitter.pump()
        running = self.scheduler.running
        if not running:
            # nothing to dispatch: consume what is still in flight (its
            # rows left; the consumer discards their values)
            self._drain_window(emitted)
            self._last_decode_end = None
            return emitted
        if self._spec is not None:
            # the speculative super-step consumes its own readback at once
            # (its draft budgets are decided from it): no window
            slots = list(running)
            out = self._spec.step(running)
            if out:
                self._note_decode_gap(had_running)
                self.scheduler.note_decoded(slots)
            else:
                self._last_decode_end = None
            return out
        if self._window_open(running):
            # chain on the newest dispatch's device tokens — the values
            # its consumer will set next_token to — and its active mask:
            # no upload, no readback before this dispatch
            prev = self._window[-1]
            tokens_dev, active = prev.tok, prev.active
            active_dev, rows = prev.active_dev, dict(prev.rows)
            n_sampled = prev.n_sampled
        else:
            # the window's assumptions broke (or it is empty): consume
            # everything in flight, then dispatch from host-built rows
            if not self._drain_window(emitted):
                return emitted
            running = self.scheduler.running
            if not running:
                self._last_decode_end = None
                return emitted
            N = self.pool.n_slots
            tokens = np.zeros((N,), np.int64)
            active = np.zeros((N,), bool)
            n_sampled = 0
            for slot, req in list(running.items()):
                if slot not in self._configured:
                    self._configure_slot(slot, req)
                tokens[slot] = req.next_token
                active[slot] = True
                n_sampled += not req.sampling.is_greedy
            tokens_dev = self._upload(tokens)
            active_dev = self._upload(active)
            rows = dict(running)
        if self._knobs_device is None:
            self._knobs_device = {k: self._upload(v)
                                  for k, v in self._knobs.items()}
        t0 = self._clock()
        try:
            tok, chosen, carry = self._dispatch(
                "decode", self._step_fn, self.params, tokens_dev,
                active_dev, self.pool.carry, self._knobs_device,
                *self._adapter_args())
        except FaultError:
            # raised before the step ran: what is in flight is healthy,
            # consume it, then evict and replay the rows that remain
            self._drain_window(emitted)
            self._recover_step(self.scheduler.running)
            self._last_decode_end = None
            return emitted
        self.pool.carry = carry
        # ONE batched readback per step, token ids + chosen log-probs (the
        # (N, vocab) distribution never leaves the card), started now and
        # waited on by this entry's consumer alone
        self._window.append(_InFlight(
            tok, start_readback("decode", tok, chosen), active, active_dev,
            rows, t0, n_sampled, had_running))
        while len(self._window) > self.dispatch_ahead:
            if not self._consume_window(emitted):
                break
        return emitted

    def drain(self) -> Dict[int, np.ndarray]:
        """Step until every submitted request has left the engine; returns
        ``{req_id: generated 1-based ids}`` for every request in the
        ledger that FINISHED (shed and cancelled ones excluded)."""
        while not self.scheduler.idle():
            self.step()
        # the last consume can finish every row while newer dispatches
        # are in flight (values of finished rows): consume them too
        self.flush_window()
        return {rid: np.asarray(r.output, np.int32)
                for rid, r in self._finished.items()
                if r.state == FINISHED}

    # -- introspection -----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return self.scheduler.queue_depth

    @property
    def active(self) -> int:
        return self.scheduler.active

    def idle(self) -> bool:
        return self.scheduler.idle()
