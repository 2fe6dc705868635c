"""Pooled, slot-indexed KV cache with a free-list allocator
(``bigdl_tpu/serving/kv_pool.py``).

Decode capacity is ``n_slots`` rows of ONE pooled per-layer K/V cache,
handed out per request through a free list. The pool's tensors ARE a
:func:`~bigdl_tpu_torch.models.transformer.make_batch_decode_step` carry,
so the engine passes ``pool.carry`` to the step, which updates it in
place.

Invariants: a slot is never handed out twice without an intervening
``free``; ``free`` of an unallocated slot raises; after every request
drains, the free list holds all ``n_slots`` again. On the int8 layout
the per-(slot, head) scales reset to zero on ``free`` — scales only grow
while a row lives, so a recycled slot must not inherit its previous
occupant's range.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np
import torch

_KV_KEY = re.compile(r"^[kv]\d+$")


class KVPool:
    def __init__(self, init_carry, n_slots: int,
                 kv_dtype: Optional[str] = None) -> None:
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = int(n_slots)
        self.carry = init_carry(self.n_slots)
        self.n_layers = sum(1 for k in self.carry if _KV_KEY.match(k)) // 2
        self.max_len = int(self.carry["k0"].shape[1])
        self.quantized = "k0_scale" in self.carry
        stored = {torch.float32: "fp32", torch.bfloat16: "bf16",
                  torch.int8: "int8"}.get(self.carry["k0"].dtype,
                                          str(self.carry["k0"].dtype))
        if kv_dtype is not None and kv_dtype != stored:
            raise ValueError(
                f"kv_dtype={kv_dtype!r} but the carry stores K/V as "
                f"{stored!r} — build the carry with the matching "
                "make_batch_decode_step(kv_quant=...) knob")
        self.kv_dtype = stored
        # bytes of KV state ONE slot owns (payload + int8 scales)
        self.kv_bytes_per_slot = int(sum(
            v.element_size() * int(np.prod(v.shape[1:]))
            for k, v in self.carry.items()
            if re.match(r"^[kv]\d+(_scale)?$", k)))
        # LIFO free list: the most recently freed row is handed out next
        self._free: List[int] = list(range(self.n_slots - 1, -1, -1))
        self._in_use: set = set()

    # -- allocator ---------------------------------------------------------

    def alloc(self) -> Optional[int]:
        """A free slot id, or None when the pool is saturated."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        """Return ``slot``: its ``pos`` resets to 0 and, on the int8
        layout, its dequant scales reset too. Stale K/V bytes stay —
        they sit behind ``pos`` and are never read."""
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.remove(slot)
        self._free.append(slot)
        self.carry["pos"][slot] = 0
        if self.quantized:
            for i in range(self.n_layers):
                self.carry[f"k{i}_scale"][slot] = 0
                self.carry[f"v{i}_scale"][slot] = 0

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def used_slots(self) -> int:
        return len(self._in_use)

    def occupancy(self) -> float:
        return self.used_slots / self.n_slots

    def _check(self, slot: int) -> None:
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")

    # -- prefill admission -------------------------------------------------

    def write_prefill(self, slot: int, prefill_carry: Dict,
                      prompt_len: int, row: int = 0) -> None:
        """Copy row ``row`` of a prefilled carry into ``slot`` (every
        layer's full ``max_len`` K/V row, plus its int8 scales) and set
        the slot's ``pos`` to ``prompt_len``: the slot then decodes as if
        it had been stepped ``prompt_len`` times."""
        self._check(slot)
        if not 0 < prompt_len <= self.max_len:
            raise ValueError(
                f"prompt_len {prompt_len} outside 1..{self.max_len}")
        if not 0 <= row < prefill_carry["pos"].shape[0]:
            raise ValueError(
                f"row {row} outside the prefill carry's "
                f"{prefill_carry['pos'].shape[0]} rows")
        for key, dst in self.carry.items():
            if _KV_KEY.match(key):
                dst[slot].copy_(prefill_carry[key][row])
                skey = f"{key}_scale"
                if skey in self.carry:
                    self.carry[skey][slot].copy_(prefill_carry[skey][row])
        self.carry["pos"][slot] = int(prompt_len)

    def read_row(self, slot: int) -> Dict:
        """One allocated slot's carry as a B=1 dict of fresh copies of
        every leaf (K/V layers + scales, pos, sampling state)."""
        self._check(slot)
        return {k: v[slot:slot + 1].clone() for k, v in self.carry.items()}

    def set_pos(self, slot: int, pos: int) -> None:
        """Set one slot's position (a 1-token prompt starts at pos 0)."""
        self._check(slot)
        self.carry["pos"][slot] = int(pos)

    # -- sampling lanes ----------------------------------------------------

    def write_sampling(self, slot: int, key, prompt_ids,
                       output_ids=()) -> None:
        """Seed one slot's sampling state at admission: its RNG lane
        becomes ``key`` (from the REQUEST's seed, so a readmitted request
        continues its stream in any slot), its generated-token counts are
        rebuilt from ``output_ids`` and its prompt mask from
        ``prompt_ids`` (1-based). The previous occupant's state is fully
        overwritten."""
        if "rng" not in self.carry:
            raise ValueError(
                "this pool's carry has no sampling state — build it "
                "from make_batch_decode_step(..., sampling=True)")
        self._check(slot)
        V = self.carry["tok_counts"].shape[1]
        mask = np.zeros((V,), bool)
        if len(prompt_ids):
            mask[np.clip(np.asarray(prompt_ids, np.int64) - 1, 0, V - 1)] = True
        counts = np.zeros((V,), np.int32)
        if len(output_ids):
            ids, reps = np.unique(
                np.clip(np.asarray(output_ids, np.int64) - 1, 0, V - 1),
                return_counts=True)
            counts[ids] = reps
        self.carry["rng"][slot].copy_(torch.from_numpy(
            np.asarray(key, np.int64)))
        self.carry["tok_counts"][slot].copy_(torch.from_numpy(counts))
        self.carry["prompt_mask"][slot].copy_(torch.from_numpy(mask))
