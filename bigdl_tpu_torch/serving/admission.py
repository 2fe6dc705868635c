"""Batched, length-bucketed admission (``bigdl_tpu/serving/admission.py``).

Waiting requests are grouped into power-of-two length buckets (clamped
at ``max_len``); each bucket prefills in ONE
:func:`~bigdl_tpu_torch.models.transformer.make_batch_prefill_step` call
over a ``(prefill_rows, L_bucket)`` right-padded token block with
per-row ``lengths`` (unfilled rows are zero-length ballast), and every
produced row is copied into its :class:`KVPool` slot. The fixed row
count keeps the prefill shapes to one per bucket, as in the JAX engine.

With a :class:`~bigdl_tpu_torch.serving.prefix_cache.PrefixCache`, each
prompt first takes the longest cached prefix: a FULL hit copies the
cached carry into the pool (no prefill), a PARTIAL hit continues it and
prefills only the suffix, and every finished prefill is inserted back —
as a fresh copy of its row, never a view of the multi-row output, which
would pin the whole block. On an engine with an adapter bank every
prefill call carries the rows' adapter ids (pad rows: the null adapter),
and the prefix cache is looked up and filled in the namespace of the
request's adapter allocation (``ServingEngine._cache_namespace``).

One zero input carry is built once and shared by every admission: the
prefill step never writes its input carry (it returns new K/V tensors),
so sharing it is safe. :class:`Degrade` is the per-request degradation
knob the engine applies at admission under pressure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.serving.faults import FaultError
from bigdl_tpu_torch.serving.prefix_cache import PrefixCache


@dataclass(frozen=True)
class Degrade:
    """A request's degradation knobs, applied at admission when the
    waiting queue is at or past the engine's ``degrade_at``:
    ``max_new_tokens`` caps the token budget (never raises it);
    ``draft_tokens`` replaces the speculative budget (0 turns speculation
    off for the request: on a loaded engine its draft dispatches are
    added latency for the whole batch); ``None`` leaves a field as it
    is. The clamp is revertible: when pressure drops while the row still
    waits, the engine puts the originals back."""

    max_new_tokens: Optional[int] = None
    draft_tokens: Optional[int] = None

    def __post_init__(self):
        if self.max_new_tokens is not None and self.max_new_tokens <= 0:
            raise ValueError(
                f"max_new_tokens must be positive, got "
                f"{self.max_new_tokens}")
        if self.draft_tokens is not None and self.draft_tokens < 0:
            raise ValueError(
                f"draft_tokens must be >= 0, got {self.draft_tokens}")


def bucket_len(n: int, cap: int) -> int:
    """The power-of-two length bucket for ``n`` tokens, clamped to
    ``cap`` (= max_len): 1, 2, 4, ... cap."""
    if n <= 0:
        raise ValueError(f"need a positive length, got {n}")
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


class AdmissionController:
    """Groups admissions into bucketed batch-prefill calls. Owned by
    :class:`ServingEngine`; reads the engine's pool, scheduler, metrics,
    params and prefill step."""

    def __init__(self, engine, prefix_cache: Optional[PrefixCache] = None,
                 prefill_rows: int = 0) -> None:
        self.engine = engine
        self.prefix_cache = prefix_cache
        # the fixed row count of every batch prefill; 0 means the slot
        # count (an admission round never has more rows to fill)
        self.prefill_rows = int(prefill_rows) or engine.pool.n_slots
        self._zero_carry_cache: Optional[dict] = None
        # (B, L) prefill shapes this controller has run: the bounded
        # shape set the buckets exist for
        self.traced_shapes: set = set()

    # -- streaming hooks (the chunked controller overrides them) -----------

    def pump(self) -> None:
        """Per-step streaming hook: batched admission prefills inside
        :meth:`admit`, so this does nothing."""

    def drop(self, slot: int) -> None:
        """Forget a slot's streaming state (nothing to forget here);
        the engine calls it whenever a slot is torn down."""

    # -- helpers -----------------------------------------------------------

    def _bind_next(self, partial: bool = False):
        """THE admission prologue, shared with the chunked controller:
        allocate a slot, bind the best waiting request, and take the two
        paths that ingest nothing — a preempted row's ``resume_carry``
        restored bitwise, and an empty prefill list (a 1-token prompt
        decodes from pos 0). Returns ``(slot, req, pf)``, ``pf`` None
        when the row needs no prompt ingestion."""
        eng = self.engine
        slot = eng.pool.alloc()
        req = eng.scheduler.admit(slot, partial=partial)
        # sets next_token and the degrade knob, which the restored path
        # needs too
        pf = eng._admitted_prefill_tokens(req)
        payload = eng._resume_payload(req)
        if payload is not None:
            eng.pool.restore_row(slot, payload)
            req.resume_carry = None
            eng._restored.add(slot)
            return slot, req, None
        if not pf:
            eng.pool.set_pos(slot, 0)
            return slot, req, None
        return slot, req, pf

    def _zero_carry(self) -> dict:
        if self._zero_carry_cache is None:
            self._zero_carry_cache = self.engine._pool_init(self.prefill_rows)
        return self._zero_carry_cache

    def _note_shape(self, B: int, L: int) -> None:
        """Record a prefill shape; a novel one counts under
        ``serving/prefill_bucket_compiles`` (each engine builds its own
        eager prefill step, so novel to it is novel to this set)."""
        if (B, L) not in self.traced_shapes:
            self.traced_shapes.add((B, L))
            self.engine.metrics.on_bucket_compile()

    @staticmethod
    def _carry_row(carry: dict, row: int) -> dict:
        """Row ``row`` of a multi-row carry as a B=1 carry of fresh
        tensors (what the prefix cache stores)."""
        return {k: v[row:row + 1].clone() for k, v in carry.items()}

    # -- the admission pipeline --------------------------------------------

    def admit(self, n: int) -> None:
        """Admit ``n`` scheduler-approved requests: allocate slots, route
        each prompt through the prefix cache, then prefill the misses
        bucket by bucket. A readmitted request prefills ``prompt +
        output`` (the replay contract) unless it carries a stash. A
        prefill that raises :class:`FaultError` evicts exactly its own
        rows; other buckets admit normally."""
        eng = self.engine
        groups: Dict[int, List[Tuple]] = {}    # L_bucket -> (req, slot, pf)
        for _ in range(n):
            slot, req, pf = self._bind_next()
            if pf is None:
                continue
            if self.prefix_cache is not None:
                try:
                    if self._try_prefix(slot, req, pf):
                        continue
                except FaultError:
                    eng._recover_admission([(slot, req)])
                    continue
            groups.setdefault(bucket_len(len(pf), eng.max_len),
                              []).append((req, slot, pf))
        for L in sorted(groups):
            rows = groups[L]
            for lo in range(0, len(rows), self.prefill_rows):
                chunk = rows[lo:lo + self.prefill_rows]
                try:
                    self._prefill_bucket(L, chunk)
                except FaultError:
                    eng._recover_admission(
                        [(slot, req) for req, slot, _ in chunk])

    def _try_prefix(self, slot: int, req, pf: List[int]) -> bool:
        """Full hit → copy into the pool; partial hit → prefill only the
        suffix from the cached carry (its ``pos`` is the start offset)
        and insert the result. False on a miss."""
        eng = self.engine
        carry, matched, lease = self.prefix_cache.acquire(
            pf, namespace=eng._cache_namespace(req))
        eng.metrics.on_prefix_lookup(matched, len(pf))
        if matched == 0:
            return False
        try:
            if matched == len(pf):             # full hit: no prefill
                eng.pool.write_prefill(slot, carry, len(pf))
                return True
            S = len(pf) - matched
            L = bucket_len(S, eng.max_len)
            toks = np.zeros((1, L), np.int64)
            toks[0, :S] = pf[matched:]
            self._note_shape(1, L)
            _, out = eng._dispatch(
                "prefill", eng._batch_prefill_fn, eng.params,
                torch.from_numpy(toks).to(eng.device),
                np.asarray([S], np.int64), carry,
                *eng._prefill_adapter_args([req.adapter_id]))
            eng.metrics.on_prefill_batch(1, 1)
            eng.pool.write_prefill(slot, out, len(pf))
            self.prefix_cache.insert(pf, out,
                                     namespace=eng._cache_namespace(req))
            return True
        finally:
            self.prefix_cache.release(lease)

    def _prefill_bucket(self, L: int, rows: List[Tuple]) -> None:
        """ONE masked multi-row prefill for an L-bucket, then per-row
        copies into the pool (and into the prefix cache)."""
        eng = self.engine
        B = self.prefill_rows
        toks = np.zeros((B, L), np.int64)
        lengths = np.zeros((B,), np.int64)     # pad rows stay ballast (0)
        aids = np.zeros((B,), np.int64)        # pad rows: null adapter
        for j, (req, _, pf) in enumerate(rows):
            toks[j, :len(pf)] = pf
            lengths[j] = len(pf)
            aids[j] = req.adapter_id
        self._note_shape(B, L)
        _, out = eng._dispatch(
            "prefill", eng._batch_prefill_fn, eng.params,
            torch.from_numpy(toks).to(eng.device), lengths,
            self._zero_carry(), *eng._prefill_adapter_args(aids))
        eng.metrics.on_prefill_batch(len(rows), B)
        for j, (req, slot, pf) in enumerate(rows):
            eng.pool.write_prefill(slot, out, len(pf), row=j)
            if self.prefix_cache is not None:
                self.prefix_cache.insert(
                    pf, self._carry_row(out, j),
                    namespace=eng._cache_namespace(req))


class PerRequestAdmissionController(AdmissionController):
    """``admission="per_request"``: one B=1
    :func:`~bigdl_tpu_torch.models.transformer.make_prefill_step` call per
    admitted prompt into one shared fresh carry — the JAX engine's
    per-request branch of ``_admit``. No prefix cache: the per-request
    prefill cannot continue from a cached carry; no adapter bank: it has
    no adapter arguments (the engine refuses both)."""

    def _zero_carry(self) -> dict:
        if self._zero_carry_cache is None:
            self._zero_carry_cache = self.engine._pool_init(1)
        return self._zero_carry_cache

    def admit(self, n: int) -> None:
        eng = self.engine
        for _ in range(n):
            slot, req, pf = self._bind_next()
            if pf is None:
                continue
            toks = torch.as_tensor([pf], dtype=torch.int64,
                                   device=eng.device)
            try:
                _, out = eng._dispatch("prefill", eng._prefill_fn,
                                       eng.params, toks, self._zero_carry())
            except FaultError:
                eng._recover_admission([(slot, req)])
                continue
            eng.pool.write_prefill(slot, out, len(pf))
