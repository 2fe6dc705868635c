"""Chunked-prefill streaming admission (``bigdl_tpu/serving/chunked.py``).

Batched admission prefills a whole admission wave between two decode
steps, so a burst of long prompts stalls every in-flight row for the
full wave. :class:`ChunkedAdmissionController`
(``ServingEngine(admission="chunked", chunk_budget=32)``) binds an
admitted request to a KV slot at once (scheduler state PARTIAL: it owns
the slot but does not decode) and then, each engine step, feeds at most
``chunk_budget`` prompt tokens of suffix-continuation prefills — a
:func:`make_batch_prefill_step` call whose start offset is the slot's
``pos`` — before the decode step runs. A row whose last chunk lands is
activated and decodes from the next step.

Contracts, as in JAX:

* each chunk's queries attend over the same cache window a one-shot
  prefill does, so chunking changes when K/V is written, not what any
  position computes (equal up to float rounding; on int8 the grow-only
  scale merge reaches the same final scale, earlier chunks requantized
  within half a quantum);
* chunk calls are ``(1, L)`` power-of-two buckets capped by the budget's
  bucket; the decode step is unchanged (PARTIAL rows are inactive);
* each step spends at most ``chunk_budget`` prompt tokens (one chunk may
  end exactly at the budget; the next waits);
* composition: priority preemption never picks a PARTIAL row; a cached
  prefix lands in the slot in one copy and skips the chunk plan; a chunk
  that faults evicts exactly its row, which replays its chunks; a decode
  fault never touches PARTIAL rows.

Progress lives in the pool's host mirrors (``chunk_done`` /
``chunk_target``), so the pump never reads the device back. Each chunk
reads the slot's row (``read_row``) and copies the result back
(``write_prefill``): chunked admission spends more prefill time to bound
the per-step stall.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.serving.admission import AdmissionController, bucket_len
from bigdl_tpu_torch.serving.faults import FaultError
from bigdl_tpu_torch.serving.scheduler import Request


class ChunkedAdmissionController(AdmissionController):
    """Streaming admission: bind slots immediately, feed prompts in
    ``chunk_budget``-bounded chunks between decode steps."""

    def __init__(self, engine, chunk_budget: int = 32,
                 prefix_cache=None) -> None:
        super().__init__(engine, prefix_cache=prefix_cache)
        if int(chunk_budget) < 1:
            raise ValueError(
                f"chunk_budget must be >= 1, got {chunk_budget}")
        self.chunk_budget = int(chunk_budget)
        # slot -> (request, full fed-token list); admission order is pump
        # order (the earliest-admitted row completes first)
        self._plans: Dict[int, Tuple[Request, List[int]]] = {}
        self._order: List[int] = []

    def admit(self, n: int) -> None:
        """Admit ``n`` requests as PARTIAL rows with chunk plans. Rows
        needing no streaming — an empty prefill, a stash resume, a full
        prefix hit — activate at once."""
        eng = self.engine
        for _ in range(n):
            slot, req, pf = self._bind_next(partial=True)
            if pf is None:
                eng.scheduler.activate(slot)
                continue
            done = 0
            if self.prefix_cache is not None:
                done = self._prefix_head(slot, req, pf)
            if done >= len(pf):                # full hit: no chunks
                eng.scheduler.activate(slot)
                continue
            eng.pool.begin_chunks(slot, done, len(pf))
            self._plans[slot] = (req, pf)
            self._order.append(slot)

    def _prefix_head(self, slot: int, req, pf: List[int]) -> int:
        """The longest cached prefix (in the request's adapter namespace)
        lands in the slot in one copy and its tokens skip the chunk plan;
        returns the matched length."""
        eng = self.engine
        carry, matched, lease = self.prefix_cache.acquire(
            pf, namespace=eng._cache_namespace(req))
        eng.metrics.on_prefix_lookup(matched, len(pf))
        if matched == 0:
            return 0
        try:
            eng.pool.write_prefill(slot, carry, matched)
        finally:
            self.prefix_cache.release(lease)
        return matched

    def pump(self) -> None:
        """Feed at most ``chunk_budget`` prompt tokens of chunk prefills,
        earliest-admitted row first. The first chunk always fits (chunk
        width is capped by the budget); a later chunk that would overflow
        the remaining budget waits. Rows whose last chunk landed are
        activated. A chunk that faults evicts only its row."""
        if not self._plans:
            return
        eng = self.engine
        budget, spent, full = self.chunk_budget, 0, False
        for slot in list(self._order):
            if slot not in self._plans:
                continue                       # dropped mid-round
            req, pf = self._plans[slot]
            while slot in self._plans:
                done = int(eng.pool.chunk_done[slot])
                if done >= len(pf):
                    self._plans.pop(slot, None)
                    eng.scheduler.activate(slot)
                    break
                if full:
                    break
                n = min(budget, len(pf) - done)
                if spent and spent + n > budget:
                    full = True
                    break
                try:
                    self._feed_chunk(slot, req, pf, done, n)
                except FaultError:
                    eng._recover_admission([(slot, req)])
                    break
                spent += n
                if spent >= budget:
                    full = True                # completion check still runs
            if full:
                break
        self._order = [s for s in self._order if s in self._plans]
        eng.metrics.on_partial_rows(len(self._plans))

    def _feed_chunk(self, slot: int, req, pf: List[int], done: int,
                    n: int) -> None:
        """ONE suffix-continuation prefill of ``pf[done:done+n]``: the
        slot's row is the input carry (its ``pos`` is the start offset),
        the result is copied back, and a completed prompt is inserted
        into the prefix cache."""
        eng = self.engine
        L = bucket_len(n, eng.max_len)
        toks = np.zeros((1, L), np.int64)
        toks[0, :n] = pf[done:done + n]
        row = eng.pool.read_row(slot)          # pos[0] == done
        self._note_shape(1, L)
        _, out = eng._dispatch("prefill", eng._batch_prefill_fn,
                               eng.params,
                               torch.from_numpy(toks).to(eng.device),
                               np.asarray([n], np.int64), row,
                               *eng._prefill_adapter_args([req.adapter_id]))
        eng.metrics.on_prefill_batch(1, 1)
        eng.pool.write_prefill(slot, out, done + n)
        if done + n == len(pf) and self.prefix_cache is not None:
            self.prefix_cache.insert(pf, out,
                                     namespace=eng._cache_namespace(req))
        eng.metrics.on_chunk(n)

    def drop(self, slot: int) -> None:
        """Forget a slot's chunk plan and its pump-order place (cancel,
        fault eviction): a recycled slot must not inherit the order."""
        self._plans.pop(slot, None)
        if slot in self._order:
            self._order.remove(slot)

    @property
    def partial_slots(self) -> List[int]:
        """Slots mid-stream, in pump order."""
        return [s for s in self._order if s in self._plans]
