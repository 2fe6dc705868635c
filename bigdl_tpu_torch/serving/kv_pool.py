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
occupant's range. The chunk-progress mirrors (``chunk_done``,
``chunk_target``) are host ints kept in lockstep with the device ``pos``
and reset with the slot the same way.

:meth:`row_state` / :meth:`restore_row` serialize one slot whole — every
carry leaf (fresh copies), the chunk mirrors, the row's adapter id, the
draft carry's row — and write it back bitwise: the preemption stash of
the engine and the payload of a disaggregated handoff (``disagg.py``).

``adapter_ids`` is the host row of per-slot LoRA bank slots (0 = the null
adapter) the engine hands the steps as runtime data; it resets to 0 with
its slot.

A speculative engine attaches its DRAFT model's pooled carry
(:meth:`attach_draft`): slot ``s`` of it always belongs to the request in
slot ``s`` here — one allocator, two caches, freed together.
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
        # host mirrors of chunked admission (chunked.py): how much of a
        # slot's prompt is resident (== its device pos) and how much it
        # needs before it may decode (0 = no chunk plan), so the chunk
        # pump plans without reading the device back
        self.chunk_done = np.zeros((self.n_slots,), np.int64)
        self.chunk_target = np.zeros((self.n_slots,), np.int64)
        # each slot's LoRA bank slot (serving/lora.py), runtime data of
        # the adapted steps; 0 = the null adapter (base model)
        self.adapter_ids = np.zeros((self.n_slots,), np.int32)
        # the draft model's slot-aligned carry (attach_draft)
        self.draft_carry: Optional[Dict] = None
        self.draft_max_len = 0

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
        for carry in (self.carry, self.draft_carry):
            if carry is None:
                continue
            carry["pos"][slot] = 0
            for key, t in carry.items():
                if key.endswith("_scale"):
                    t[slot] = 0
        self.chunk_done[slot] = 0
        self.chunk_target[slot] = 0
        self.adapter_ids[slot] = 0

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
        _copy_kv_row(self.carry, slot, prefill_carry, row)
        self.carry["pos"][slot] = int(prompt_len)
        self.chunk_done[slot] = prompt_len

    def read_row(self, slot: int) -> Dict:
        """One allocated slot's carry as a B=1 dict of fresh copies of
        every leaf (K/V layers + scales, pos, sampling state): never a
        view, which would pin the pool and change with the next step."""
        self._check(slot)
        return {k: v[slot:slot + 1].clone() for k, v in self.carry.items()}

    def set_pos(self, slot: int, pos: int) -> None:
        """Set one slot's position (a 1-token prompt starts at pos 0)."""
        self._check(slot)
        self.carry["pos"][slot] = int(pos)
        self.chunk_done[slot] = int(pos)

    # -- row serialization (the preemption stash) --------------------------

    def row_state(self, slot: int) -> Dict:
        """Everything one allocated slot carries: ``carry`` (every leaf
        of :meth:`read_row`, cloned), the ``chunk_done``/``chunk_target``
        mirrors, ``adapter`` (the slot's adapter id) and ``draft`` (the draft carry's row, cloned leaf by leaf; None
        without one). :meth:`restore_row` is its bitwise inverse."""
        carry = self.read_row(slot)
        draft = None if self.draft_carry is None else {
            k: v[slot:slot + 1].clone() for k, v in self.draft_carry.items()}
        return {"carry": carry,
                "chunk_done": int(self.chunk_done[slot]),
                "chunk_target": int(self.chunk_target[slot]),
                "adapter": int(self.adapter_ids[slot]), "draft": draft}

    def restore_row(self, slot: int, payload: Dict) -> None:
        """Write a :meth:`row_state` payload into an allocated slot,
        bitwise: every carry leaf copied in place into the pool's tensors
        (``pos`` too, device to device, so nothing is read back), the
        chunk mirrors and the adapter id from the payload's own values.
        Host leaves (a payload off the wire or the host tier) go up
        through :func:`upload_leaves`: one staging buffer, one copy, no
        host wait. The payload is only read."""
        self._check(slot)
        device = self.carry["pos"].device
        for key, src in upload_leaves(payload["carry"], device).items():
            self.carry[key][slot:slot + 1].copy_(src)
        draft = payload.get("draft")
        if draft is not None and self.draft_carry is not None:
            for key, src in upload_leaves(draft, device).items():
                self.draft_carry[key][slot:slot + 1].copy_(src)
        self.chunk_done[slot] = int(payload["chunk_done"])
        self.chunk_target[slot] = int(payload["chunk_target"])
        # a payload without the key restores as the null adapter
        self.adapter_ids[slot] = int(payload.get("adapter", 0))

    # -- the draft carry (speculative decoding) ------------------------------

    def attach_draft(self, init_carry) -> None:
        """Attach the draft model's pooled carry (``init_carry`` of its
        :func:`~bigdl_tpu_torch.models.transformer.make_batch_decode_step`,
        no sampling state: the draft proposes greedily and the request's
        lane lives in the target carry). It resets with its slot."""
        if self.draft_carry is not None:
            raise ValueError("a draft carry is already attached")
        self.draft_carry = init_carry(self.n_slots)
        self.draft_max_len = int(self.draft_carry["k0"].shape[1])

    def _check_draft(self, slot: int) -> None:
        if self.draft_carry is None:
            raise ValueError("no draft carry attached (attach_draft)")
        self._check(slot)

    def write_draft_prefill(self, slot: int, prefill_carry: Dict,
                            prompt_len: int, row: int = 0) -> None:
        """:meth:`write_prefill`'s twin for the draft carry."""
        self._check_draft(slot)
        if not 0 < prompt_len <= self.draft_max_len:
            raise ValueError(
                f"prompt_len {prompt_len} outside 1..{self.draft_max_len}")
        _copy_kv_row(self.draft_carry, slot, prefill_carry, row)
        self.draft_carry["pos"][slot] = int(prompt_len)

    def set_draft_pos(self, slot: int, pos: int) -> None:
        """Set one slot's draft position (:meth:`set_pos`'s twin)."""
        self._check_draft(slot)
        self.draft_carry["pos"][slot] = int(pos)

    # -- chunk progress (chunked admission) ----------------------------------

    def begin_chunks(self, slot: int, done: int, target: int) -> None:
        """Open a chunk plan: ``done`` prompt tokens are resident (0, or
        the matched length after a prefix-cache head write) and the row
        needs ``target`` before it may decode."""
        self._check(slot)
        if not 0 <= done <= target <= self.max_len:
            raise ValueError(
                f"chunk plan done={done}..target={target} outside "
                f"0..{self.max_len}")
        self.chunk_done[slot] = int(done)
        self.chunk_target[slot] = int(target)

    def chunk_remaining(self, slot: int) -> int:
        """Prompt tokens still to stream (0 = complete or no plan)."""
        return int(max(0, self.chunk_target[slot] - self.chunk_done[slot]))

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


def upload_leaves(leaves: Dict, device) -> Dict:
    """``leaves`` (a dict of tensors) on ``device``. Leaves already there
    pass through. On the card the host leaves are packed into ONE pinned
    staging buffer and uploaded in ONE non-blocking copy, then split into
    views on the card, so restoring a host payload never waits for the
    work already queued (a pageable ``.to()`` would). A leaf on another
    card, or a device leaf bound for the CPU, raises: a payload is never
    read back implicitly."""
    device = torch.device(device)
    out, host = {}, {}
    for key, t in leaves.items():
        if t.device.type == device.type and (
                device.index is None or t.device.index == device.index):
            out[key] = t
        elif t.device.type == "cpu" and device.type == "cuda":
            host[key] = t
        else:
            raise ValueError(
                f"payload leaf {key!r} lives on {t.device}, not on the "
                f"host or {device}")
    if not host:
        return out
    flat, at = [], 0
    for key, t in host.items():
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        flat.append((key, t.dtype, tuple(t.shape), at, b))
        at += -(-b.numel() // 16) * 16      # 16-byte aligned views
    stage = torch.empty((max(at, 1),), dtype=torch.uint8, pin_memory=True)
    for _, _, _, off, b in flat:
        stage[off:off + b.numel()].copy_(b)
    dev = stage.to(device, non_blocking=True)
    for key, dtype, shape, off, b in flat:
        out[key] = dev[off:off + b.numel()].view(dtype).reshape(shape)
    return {key: out[key] for key in leaves}


def _copy_kv_row(carry: Dict, slot: int, src: Dict, row: int) -> None:
    """Copy row ``row`` of ``src``'s K/V layers (and int8 scales) into
    ``carry``'s slot ``slot``, in place."""
    for key, dst in carry.items():
        if _KV_KEY.match(key):
            dst[slot].copy_(src[key][row])
            skey = f"{key}_scale"
            if skey in carry:
                carry[skey][slot].copy_(src[skey][row])
