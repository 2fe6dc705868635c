"""Continuous-batching serving engine for :func:`TransformerLM`
(``bigdl_tpu/serving/engine.py``).

:class:`ServingEngine` serves many independent requests from one pooled
KV cache (:class:`~bigdl_tpu_torch.serving.kv_pool.KVPool`) stepped by
one per-row-position decode step with the per-row sampler fused in
(:func:`~bigdl_tpu_torch.models.transformer.make_batch_decode_step`):

* requests are ``submit()``-ed at any time and queue FIFO;
* before every decode step the scheduler admits waiting requests into
  free slots; the admitted prompts prefill in power-of-two length
  buckets, one masked multi-row prefill call per bucket
  (``admission.py``);
* every ``step()`` decodes one token for ALL active rows at once and
  reads back only the chosen token ids and their log-probs, in one
  batched readback (``fences.py``);
* rows leave at eos, a stop token or sequence, or ``max_new_tokens``,
  and their slot returns to the free list for the next admission.

Each request carries its own :class:`~bigdl_tpu_torch.serving.sampling.
SamplingParams` and its own counter-based RNG lane, so greedy and
sampled rows mix in one step, and a seeded request replays its stream
whatever its neighbours or its slot. The step-health check discards a
step whose outputs are non-finite or out of range (or that overran the
watchdog's timeout) and replays its rows from ``prompt + output``.

``kv_dtype="int8"`` stores the pooled K/V as per-(slot, head)-scaled
int8 and reads it through the hand-written CUDA decode-attention kernel
on the card (its plain version on the CPU). The engine runs on ``cuda``
unless ``device="cpu"`` is passed; the model must live on that device.
Knobs of the JAX engine that this slice does not port raise
``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.models.transformer import (
    make_batch_decode_step, make_batch_prefill_step, serving_params,
)
from bigdl_tpu_torch.serving.admission import AdmissionController
from bigdl_tpu_torch.serving.faults import (
    FaultError, WatchdogConfig, default_clock,
)
from bigdl_tpu_torch.serving.fences import fence
from bigdl_tpu_torch.serving.kv_pool import KVPool
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.sampling import (
    SamplingParams, advance_lane, fold_lane, knob_row_values, lane_key,
    make_knob_rows, match_stop_sequences,
)
from bigdl_tpu_torch.serving.scheduler import FINISHED, Request, Scheduler
from bigdl_tpu_torch.utils.device import resolve_device

#: JAX-engine knobs this slice does not port, with their ROADMAP.md item
_NOT_PORTED = {
    "mesh": "A.2.g sharded serving (serving/sharded.py)",
    "parallelism": "A.2.g sharded serving (serving/sharded.py)",
    "speculative": "A.2.e speculative decoding (serving/speculative.py)",
    "adapters": "A.2.h multi-tenant LoRA (serving/lora.py)",
    "tier": "A.2.i host KV tier (serving/kv_tier.py)",
    "autopilot": "A.2.i SLO autopilot (serving/autopilot.py)",
    "faults": "A.2.d fault injection (serving/faults.py FaultInjector)",
    "prefix_cache": "A.2.b prefix cache (serving/prefix_cache.py)",
}


class ServingEngine:
    """Continuous-batching per-row-sampled decoder over a pooled KV cache.

    ``n_slots`` is the decode capacity; ``compute_dtype`` the serving
    precision of weights and float KV (e.g. ``torch.bfloat16``; scores
    and log-softmax stay f32); ``kv_dtype`` ``"fp32"``/``"bf16"`` (must
    match ``compute_dtype``) or ``"int8"``; ``policy``
    ``"prefill_priority"`` or ``"fifo"``; ``seed`` is the base of the
    RNG lanes of requests without their own seed; ``watchdog`` bounds
    step time and per-request retries; ``device`` defaults to ``cuda``."""

    def __init__(self, model, n_slots: int = 8, compute_dtype=None,
                 policy: str = "prefill_priority",
                 admission: str = "batched",
                 seed: int = 0,
                 kv_dtype: Optional[str] = None,
                 watchdog: Optional[WatchdogConfig] = None,
                 dispatch_ahead: int = 0,
                 device=None,
                 **not_ported) -> None:
        for knob, value in not_ported.items():
            if knob not in _NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {knob!r}")
            if value not in (None, False):
                raise NotImplementedError(
                    f"{knob}= is not ported yet: ROADMAP.md {_NOT_PORTED[knob]}")
        if admission != "batched":
            raise NotImplementedError(
                f"admission={admission!r} is not ported yet: ROADMAP.md "
                "A.2.a per-request and A.2.c chunked admission")
        if policy == "priority":
            raise NotImplementedError(
                "policy='priority' (and preemption) is not ported yet: "
                "ROADMAP.md A.2.d")
        if int(dispatch_ahead) != 0:
            raise NotImplementedError(
                "dispatch_ahead > 0 is not ported yet: ROADMAP.md A.2.f")
        self.device = resolve_device(device)
        model_dev = model[0].weight.device
        if model_dev.type != self.device.type or (
                self.device.index is not None
                and model_dev.index != self.device.index):
            raise ValueError(
                f"the model lives on {model_dev} but the engine runs on "
                f"{self.device} — build the model with the same device")
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
        self.watchdog = watchdog if watchdog is not None \
            else WatchdogConfig()
        self.params = serving_params(model, compute_dtype)
        self._step_fn, self._pool_init = make_batch_decode_step(
            model, compute_dtype, sampling=True, kv_quant=kv_quant)
        self._batch_prefill_fn = make_batch_prefill_step(
            model, compute_dtype, kv_quant=kv_quant)
        self.pool = KVPool(self._pool_init, n_slots, kv_dtype=kv_dtype)
        self.scheduler = Scheduler(policy)
        self.metrics = ServingMetrics()
        self.metrics.set_kv_format(kv_dtype, self.pool.kv_bytes_per_slot)
        self.admitter = AdmissionController(self)
        self.seed = int(seed)
        self._knobs = make_knob_rows(n_slots)
        self._knobs_device = None       # re-uploaded only after a change
        self._ban_base = np.zeros((n_slots,), bool)
        self._configured: set = set()
        self._warm = False              # arms the watchdog timeout
        self._next_id = 0
        self._finished: Dict[int, Request] = {}

    # -- request surface ---------------------------------------------------

    def submit(self, prompt_ids: Sequence[int], max_new_tokens: int = 32,
               eos_id: int = -1,
               sampling: Optional[SamplingParams] = None) -> int:
        """Queue one generation request (1-based prompt ids); returns its
        request id. ``eos_id`` is the request's own eos (1-based, -1 =
        none); ``sampling.max_tokens`` overrides ``max_new_tokens``.
        Raises if the request could overflow the cache."""
        prompt = [int(t) for t in prompt_ids]
        if not prompt:
            raise ValueError("need a non-empty prompt")
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
        rid = self._next_id
        self._next_id += 1
        req = Request(req_id=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), eos_id=int(eos_id),
                      sampling=sp, submit_time=default_clock())
        self.metrics.on_submit()
        self.scheduler.submit(req)
        return rid

    def result(self, req_id: int) -> Optional[np.ndarray]:
        """Generated 1-based ids of a FINISHED request, else None."""
        req = self._finished.get(req_id)
        return None if req is None else np.asarray(req.output, np.int32)

    def logprobs(self, req_id: int) -> Optional[np.ndarray]:
        """Chosen-token raw model log-probs of a FINISHED request."""
        req = self._finished.get(req_id)
        return None if req is None else np.asarray(req.logprobs, np.float32)

    def request(self, req_id: int) -> Optional[Request]:
        return self._finished.get(req_id)

    def summary(self) -> Dict[str, float]:
        """The serving counters (:meth:`ServingMetrics.summary`)."""
        return self.metrics.summary()

    # -- admission and recovery --------------------------------------------

    def _admit(self) -> None:
        n = self.scheduler.admissible(self.pool.free_slots)
        if n:
            self.admitter.admit(n)

    def _admitted_prefill_tokens(self, req: Request) -> List[int]:
        """0-based tokens whose K/V must be resident before ``req``
        decodes: the prompt plus everything already emitted (the replay
        source of a fault-evicted row). Sets ``req.next_token`` to the
        last fed token and returns everything before it."""
        fed0 = [t - 1 for t in req.prompt] + [t - 1 for t in req.output]
        req.next_token = fed0[-1]
        return fed0[:-1]

    def _recover_rows(self, rows) -> None:
        """Evict rows of a failed dispatch for loss-free replay (requeued
        at their arrival position, re-prefilled from ``prompt + output``)
        or fail them out with ``finish_reason='error'`` past the
        watchdog's retry budget."""
        now = default_clock()
        for slot, req in rows:
            self._configured.discard(slot)
            req.retries += 1
            mr = self.watchdog.max_retries
            if mr is not None and req.retries > mr:
                self._finish_row(req, "error", now)
            else:
                self.scheduler.requeue(req)
                self.pool.free(slot)
                self.metrics.on_retry()

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
        and seed its lane and penalty state on the device; a readmitted
        request resumes its lane ``len(output)`` draws on."""
        sp = req.sampling
        scal, ban_row = knob_row_values(sp, req.eos_id)
        for k, v in scal.items():
            self._knobs[k][slot] = v
        self._knobs["ban_ids"][slot] = ban_row
        self._ban_base[slot] = self._knobs["ban"][slot]
        if self._ban_base[slot] and req.output:
            self._knobs["ban"][slot] = len(req.output) < sp.min_tokens
        self._knobs_device = None
        key = advance_lane(self._lane_key(req), len(req.output))
        self.pool.write_sampling(slot, key, req.prompt,
                                 output_ids=req.output)
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
        freed = self.scheduler.finish(req)
        self.pool.free(freed)
        self._configured.discard(freed)
        req.finish_reason = reason
        self._finished[req.req_id] = req
        self.metrics.on_finish_reason(reason)
        if reason != "error" and req.retries > 0:
            self.metrics.on_recovered()
        self.metrics.on_finish(
            now - req.submit_time, len(req.output),
            mean_logprob=(float(np.mean(req.logprobs))
                          if req.logprobs else None))

    def _maybe_flip_ban(self, slot: int, req: Request) -> None:
        """The min-tokens ban lifts the step the floor is met."""
        if self._ban_base[slot]:
            ban = len(req.output) < req.sampling.min_tokens
            if ban != self._knobs["ban"][slot]:
                self._knobs["ban"][slot] = ban
                self._knobs_device = None

    # -- the serving loop --------------------------------------------------

    def step(self) -> Dict[int, int]:
        """Admit waiting requests, then decode one token for every
        running row. Returns ``{req_id: 1-based token}`` emitted this
        step (empty when idle). Records one ``host_step_s`` sample per
        decode step: the step's wall time minus its fence wait."""
        t_step = default_clock()
        dev0 = self.metrics.device_seconds
        ndec0 = self.metrics.decode_step_count
        try:
            return self._step_impl()
        finally:
            if self.metrics.decode_step_count > ndec0:
                dev = self.metrics.device_seconds - dev0
                self.metrics.add_phase(
                    "host_step", max(0.0, default_clock() - t_step - dev))

    def _step_impl(self) -> Dict[int, int]:
        emitted: Dict[int, int] = {}
        self._admit()
        running = self.scheduler.running
        if not running:
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
        rows = dict(running)
        if self._knobs_device is None:
            self._knobs_device = {k: torch.from_numpy(v).to(self.device)
                                  for k, v in self._knobs.items()}
        t0 = default_clock()
        try:
            tok, chosen, carry = self._step_fn(
                self.params, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(active).to(self.device), self.pool.carry,
                self._knobs_device)
        except FaultError:
            self._recover_rows(list(rows.items()))
            return emitted
        self.pool.carry = carry
        # ONE batched readback per step: token ids + chosen log-probs
        # (the (N, vocab) distribution never leaves the card)
        t_f = default_clock()
        nxt, lps = fence("decode", tok, chosen)
        now = default_clock()
        self.metrics.add_phase("fence_wait", now - t_f)
        elapsed = now - t0
        self.metrics.add_phase("decode_step", elapsed)
        bad = self._step_unhealthy(nxt, lps, active)
        if bad is None and self._timed_out(elapsed):
            bad = "timeout"
        if bad is not None:
            self._recover_rows(list(rows.items()))
            return emitted
        self._warm = True
        self.metrics.on_step(self.scheduler.queue_depth,
                             self.pool.occupancy(), len(rows))
        self.metrics.on_sample_rows(n_sampled, len(rows) - n_sampled)
        for slot, req in rows.items():
            tok0 = int(nxt[slot])
            req.output.append(tok0 + 1)          # back to 1-based ids
            req.logprobs.append(float(lps[slot]))
            emitted[req.req_id] = tok0 + 1
            if req.first_token_time is None:
                req.first_token_time = now
                self.metrics.on_first_token(now - req.submit_time)
            reason = self._finish_check(req)
            if reason is not None:
                self._finish_row(req, reason, now)
            else:
                req.next_token = tok0
                self._maybe_flip_ban(slot, req)
        return emitted

    def drain(self) -> Dict[int, np.ndarray]:
        """Step until every submitted request has finished; returns
        ``{req_id: generated 1-based ids}`` for every finished request."""
        while not self.scheduler.idle():
            self.step()
        return {rid: np.asarray(r.output, np.int32)
                for rid, r in self._finished.items()
                if r.state == FINISHED}
