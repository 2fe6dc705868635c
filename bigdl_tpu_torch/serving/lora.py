"""Pooled per-row LoRA adapter bank for multi-tenant serving
(``bigdl_tpu/serving/lora.py``).

One pool serves many tenant fine-tunes over one set of base weights. The
low-rank factors of every live adapter sit side by side in a pooled BANK,
and each pool row carries only an integer ``adapter_id``: the prefill,
decode and verify steps gather the row's ``(A, B)`` pair from the bank by
id (``_adapter_proj_fns`` in :mod:`bigdl_tpu_torch.models.transformer`),
so mixed base and tenant traffic runs one step of one shape, and admitting,
evicting or swapping tenants changes only runtime data.

Layout (the contract with ``transformer.ADAPTER_SITES``): for each
transformer block ``i`` and each adapted projection ``site`` in ``(wq,
wk, wv, wo, fc1, fc2)`` the bank holds

* ``f"{site}{i}_a"`` — ``(n_slots, r, in_dim)`` fp32, and
* ``f"{site}{i}_b"`` — ``(n_slots, out_dim, r)`` fp32,

and a row's delta for that projection is ``(h @ A[id].T) @ B[id].T``
(a tenant trained with ``alpha != r`` folds ``alpha / r`` into its B
before :meth:`AdapterBank.alloc`). Slot 0 is the permanently all-zero
NULL adapter: base-model rows gather exact zeros, and adding 0.0 is the
float identity (up to ``-0.0 → +0.0``), which keeps null-adapter streams
token-identical to an engine without a bank (pinned by
tests/test_torch_serving_lora.py).

Slot lifecycle mirrors the KV pool's: :meth:`AdapterBank.alloc` writes a
tenant's factors into a free slot and returns its id with refcount 1;
:meth:`retain` / :meth:`free` move the refcount, and at zero the slot's
rows are ZEROED (a recycled slot must not leak the previous tenant's
factors through the null-adapter identity) and the slot returns to the
free list. ``version`` bumps on every mutation, so the engine caches the
bank's device copy and replaces it only when the host arrays changed.
:meth:`AdapterBank.namespace` names one ALLOCATION of a slot, not the
slot: the prefix cache keys its trees by it, so K/V cached under a freed
tenant's factors never serves the slot's next tenant.

The host arrays are numpy fp32 under the JAX bank's keys, so
:meth:`random_factors` (numpy's ``default_rng``) gives both banks the same
factors from one seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch


@dataclass(frozen=True)
class AdapterSpec:
    """The shape summary of an :class:`AdapterBank`: what the step
    factories take as their ``adapter=`` argument (the factor VALUES are
    runtime data of every call)."""

    rank: int
    n_slots: int


class AdapterBank:
    """Pooled low-rank adapter factors, alloc/free'd like KV slots (module
    docstring)."""

    def __init__(self, model, rank: int, n_slots: int = 8) -> None:
        from bigdl_tpu_torch.models.transformer import adapter_site_shapes

        if rank <= 0:
            raise ValueError(f"rank must be positive, got {rank}")
        if n_slots < 2:
            raise ValueError(
                f"n_slots must be >= 2 (slot 0 is the reserved null "
                f"adapter), got {n_slots}")
        self.rank = int(rank)
        self.n_slots = int(n_slots)
        self.site_shapes: List[Dict[str, tuple]] = adapter_site_shapes(model)
        self.arrays: Dict[str, np.ndarray] = {}
        for i, layer in enumerate(self.site_shapes):
            for site, (out_dim, in_dim) in layer.items():
                self.arrays[f"{site}{i}_a"] = np.zeros(
                    (self.n_slots, self.rank, in_dim), np.float32)
                self.arrays[f"{site}{i}_b"] = np.zeros(
                    (self.n_slots, out_dim, self.rank), np.float32)
        # slot 0 = null adapter: never allocated, never freed
        self._free: List[int] = list(range(self.n_slots - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self._namespaces: Dict[int, int] = {}   # slot -> version at alloc
        self.version = 0

    @property
    def spec(self) -> AdapterSpec:
        return AdapterSpec(self.rank, self.n_slots)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def live(self) -> Dict[int, int]:
        """``{adapter_id: refcount}`` of allocated slots (a copy)."""
        return dict(self._refs)

    def is_live(self, adapter_id: int) -> bool:
        """True for ids a row may carry: the null adapter or an allocated
        slot."""
        return adapter_id == 0 or adapter_id in self._refs

    def namespace(self, adapter_id: int) -> int:
        """The prefix-cache namespace of a live id: 0 for the null
        adapter, else a number unique to the slot's current allocation (a
        freed and re-alloc'd slot gets a new one). Raises ``KeyError`` for
        an id that is not allocated."""
        if adapter_id == 0:
            return 0
        if adapter_id not in self._namespaces:
            raise KeyError(f"adapter id {adapter_id} is not allocated")
        return self._namespaces[adapter_id]

    def namespaces(self) -> set:
        """Every live namespace, the null adapter's 0 included."""
        return {0, *self._namespaces.values()}

    # -- slot lifecycle ----------------------------------------------------

    def alloc(self, factors: Dict[str, np.ndarray]) -> int:
        """Write a tenant's factors into a free slot; returns its
        ``adapter_id`` with refcount 1. ``factors`` maps bank keys to
        ``(r, in)`` / ``(out, r)`` arrays; absent keys stay zero. Unknown
        keys and shape mismatches raise before any row is written."""
        unknown = set(factors) - set(self.arrays)
        if unknown:
            raise KeyError(
                f"unknown adapter factor keys {sorted(unknown)} (bank "
                f"keys are site+layer pairs like 'wq0_a')")
        for key, val in factors.items():
            want = self.arrays[key].shape[1:]
            if tuple(np.shape(val)) != want:
                raise ValueError(
                    f"adapter factor {key!r} has shape "
                    f"{tuple(np.shape(val))}, bank expects {want}")
        if not self._free:
            raise RuntimeError(
                f"adapter bank full: all {self.n_slots - 1} tenant "
                f"slots are allocated")
        slot = self._free.pop()
        for key, val in factors.items():
            self.arrays[key][slot] = np.asarray(val, np.float32)
        self._refs[slot] = 1
        self.version += 1
        self._namespaces[slot] = self.version
        return slot

    def retain(self, adapter_id: int) -> None:
        """Bump an allocated slot's refcount (id 0 is a no-op)."""
        if adapter_id == 0:
            return
        if adapter_id not in self._refs:
            raise KeyError(f"adapter id {adapter_id} is not allocated")
        self._refs[adapter_id] += 1

    def free(self, adapter_id: int) -> None:
        """Drop one reference; at zero the slot's factor rows are ZEROED
        and the slot returns to the free list. Freeing id 0 raises."""
        if adapter_id == 0:
            raise ValueError("adapter id 0 is the reserved null adapter")
        if adapter_id not in self._refs:
            raise KeyError(f"adapter id {adapter_id} is not allocated")
        self._refs[adapter_id] -= 1
        if self._refs[adapter_id] > 0:
            return
        del self._refs[adapter_id]
        del self._namespaces[adapter_id]
        for arr in self.arrays.values():
            arr[adapter_id] = 0.0
        self._free.append(adapter_id)
        self.version += 1

    # -- device view -------------------------------------------------------

    def device_arrays(self, device) -> Dict[str, torch.Tensor]:
        """The bank as fp32 tensors on ``device`` (fresh copies): what the
        engine feeds the steps, cached against :attr:`version`. On the
        card each copy goes through pinned memory without blocking the
        host, so a tenant alloc'd or freed mid-serving does not wait for
        the steps already queued."""
        device = torch.device(device)
        out = {}
        for k, v in self.arrays.items():
            t = torch.from_numpy(v)
            out[k] = (t.pin_memory().to(device, non_blocking=True)
                      if device.type == "cuda" else t.to(device, copy=True))
        return out

    # -- test / bench helper -----------------------------------------------

    def random_factors(self, seed: int, amp: float = 0.05):
        """Deterministic random factors for every bank key, ``N(0, amp)``
        for A and B: the JAX bank's draws from the same seed."""
        rng = np.random.default_rng(seed)
        return {k: rng.normal(0.0, amp, v.shape[1:]).astype(np.float32)
                for k, v in self.arrays.items()}
