"""Batched, length-bucketed admission (``bigdl_tpu/serving/admission.py``).

Waiting requests are grouped into power-of-two length buckets (clamped
at ``max_len``); each bucket prefills in ONE
:func:`~bigdl_tpu_torch.models.transformer.make_batch_prefill_step` call
over a ``(prefill_rows, L_bucket)`` right-padded token block with
per-row ``lengths`` (unfilled rows are zero-length ballast), and every
produced row is copied into its :class:`KVPool` slot. The fixed row
count keeps the prefill shapes to one per bucket, as in the JAX engine;
the prefix cache waits for a later slice.

One zero input carry is built once and shared by every admission: the
prefill step never writes its input carry (it returns new K/V tensors),
so sharing it is safe.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.serving.faults import FaultError


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

    def __init__(self, engine) -> None:
        self.engine = engine
        # an admission round never has more rows to fill than slots
        self.prefill_rows = engine.pool.n_slots
        self._zero_carry_cache: Optional[dict] = None

    def _zero_carry(self) -> dict:
        if self._zero_carry_cache is None:
            self._zero_carry_cache = self.engine._pool_init(self.prefill_rows)
        return self._zero_carry_cache

    def admit(self, n: int) -> None:
        """Admit ``n`` scheduler-approved requests: allocate slots, then
        prefill the prompts bucket by bucket. A readmitted request
        (fault recovery) prefills ``prompt + output`` — the replay
        contract. A prefill that raises :class:`FaultError` evicts exactly
        its own rows; other buckets admit normally."""
        eng = self.engine
        groups: Dict[int, List[Tuple]] = {}    # L_bucket -> (req, slot, pf)
        for _ in range(n):
            slot = eng.pool.alloc()
            req = eng.scheduler.admit(slot)
            # the last fed token is the first decode input
            pf = eng._admitted_prefill_tokens(req)
            if not pf:
                eng.pool.set_pos(slot, 0)      # 1-token prompt: no prefill
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
                    eng._recover_rows([(slot, req) for req, slot, _ in chunk])

    def _prefill_bucket(self, L: int, rows: List[Tuple]) -> None:
        """ONE masked multi-row prefill for an L-bucket, then per-row
        copies into the pool."""
        eng = self.engine
        B = self.prefill_rows
        toks = np.zeros((B, L), np.int64)
        lengths = np.zeros((B,), np.int64)     # pad rows stay ballast (0)
        for j, (_, _, pf) in enumerate(rows):
            toks[j, :len(pf)] = pf
            lengths[j] = len(pf)
        _, out = eng._batch_prefill_fn(
            eng.params, torch.from_numpy(toks).to(eng.device), lengths,
            self._zero_carry())
        eng.metrics.on_prefill_batch(len(rows), B)
        for j, (_, slot, pf) in enumerate(rows):
            eng.pool.write_prefill(slot, out, len(pf), row=j)
