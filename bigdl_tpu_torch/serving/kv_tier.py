"""Host-RAM KV tier: spill cold rows and prefix entries below device
memory (``bigdl_tpu/serving/kv_tier.py``).

The pooled KV cache holds ``n_slots`` rows on the card; a row that falls
out of it — preempted, handed off between pools, requeued after a failed
transfer — is either replayed through prefill or parked. The
:class:`TieredKVStore` is the one place rows are parked: a budgeted host
tier over any :class:`~bigdl_tpu_torch.parallel.block_store.BlockStore`
(an in-process :class:`MemBlockStore` by default) holding two entry
kinds under ONE LRU byte budget:

* **rows** — whole ``KVPool.row_state()`` payloads packed through the
  handoff wire codec (:func:`~bigdl_tpu_torch.serving.disagg.
  pack_payload`: a JSON header and self-describing array leaves, bf16 and
  int8 bitwise), keyed by request id. A fetch is currency-checked
  against the request's emitted stream and keeps the entry (it doubles
  as the failover copy) until a terminal disposition drops it;
* **prefixes** — :class:`~bigdl_tpu_torch.serving.prefix_cache.
  PrefixCache` carries demoted at capacity eviction instead of deleted,
  keyed by (namespace, token path); a later lookup promotes the best one
  back into the radix tree as an ordinary (possibly truncated) hit.

The budget evicts the least recently used entry of either kind (the
entry just written is immune for its own pass). Evicting a row is
loss-free: the readmission fetch misses and the row replays through
prefill. Meta-only (replay-form) blobs ride the row API for the
failover and cancel bookkeeping but count no spill.

Row state enters the store only as ``pack_payload`` bytes and leaves
only through ``unpack_payload`` / ``payload_header``; fetched leaves are
CPU tensors, which ``KVPool.restore_row`` uploads in one non-blocking
copy. :meth:`TieredKVStore.prefetch` decodes the next admission wave's
blobs in one pass before admission touches the card.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

from bigdl_tpu_torch.parallel.block_store import BlockStore, MemBlockStore
from bigdl_tpu_torch.serving.faults import default_clock
from bigdl_tpu_torch.serving.kv_pool import upload_leaves


class TieredKVStore:
    """One host spill tier shared by an engine (or a whole disaggregated
    plane): row payloads and demoted prefix carries under one LRU byte
    budget (module docstring).

    ``store`` is any :class:`BlockStore` (default an in-process
    :class:`MemBlockStore`); ``host_budget_bytes`` bounds the resident
    bytes (None = unbounded). The tier keeps its own key index (block
    stores expose no iteration), so each serving plane needs its own
    tier object. ``clock`` times fetches; the engine attaches its own."""

    def __init__(self, store: Optional[BlockStore] = None,
                 host_budget_bytes: Optional[int] = None,
                 clock=None) -> None:
        if host_budget_bytes is not None and host_budget_bytes <= 0:
            raise ValueError(
                f"host_budget_bytes must be positive or None, got "
                f"{host_budget_bytes}")
        self.store = store if store is not None else MemBlockStore()
        self.host_budget_bytes = host_budget_bytes
        self._clock = clock if clock is not None else default_clock
        # ONE LRU over every resident entry (rows AND prefixes): key ->
        # nbytes, oldest first; doubles as the key index
        self._lru: "OrderedDict[str, int]" = OrderedDict()
        self._bytes = 0
        # prefix index: namespace -> {token tuple -> store key}
        self._prefixes: Dict[int, Dict[Tuple[int, ...], str]] = {}
        self._pf_seq = 0
        # prefetched payloads by request id (fetch_row pops them)
        self._hot: Dict[int, dict] = {}
        self._metrics = None
        self.spills = 0
        self.fetches = 0
        self.evictions = 0
        self.spill_bytes = 0
        self.fetch_bytes = 0

    # -- metrics plumbing --------------------------------------------------

    def attach_metrics(self, metrics, clock=None) -> None:
        """Bind ONE metrics sink (the first caller wins: a disaggregated
        plane attaches its front end's before the pools' engines)."""
        if self._metrics is None and metrics is not None:
            self._metrics = metrics
            if clock is not None:
                self._clock = clock
            self._note_bytes()

    def _note_bytes(self) -> None:
        if self._metrics is not None:
            self._metrics.on_tier_bytes(self._bytes)

    def _spilled(self, n_bytes: int) -> None:
        self.spills += 1
        self.spill_bytes += n_bytes
        if self._metrics is not None:
            self._metrics.on_spill(n_bytes)

    def _fetched(self, n_bytes: int, seconds: float) -> None:
        self.fetches += 1
        self.fetch_bytes += n_bytes
        if self._metrics is not None:
            self._metrics.on_fetch(n_bytes, seconds)

    # -- budget / LRU core -------------------------------------------------

    @staticmethod
    def _row_key(req_id: int) -> str:
        return f"tier/row/{int(req_id)}"

    def _put_blob(self, key: str, blob: bytes, count: bool) -> None:
        old = self._lru.pop(key, None)
        if old is not None:
            self._bytes -= old
        self.store.put(key, blob)
        self._lru[key] = len(blob)
        self._bytes += len(blob)
        if count:
            self._spilled(len(blob))
        self._evict_over_budget(protect=key)
        self._note_bytes()

    def _remove(self, key: str) -> bool:
        n = self._lru.pop(key, None)
        if n is None:
            return False
        self._bytes -= n
        self.store.delete(key)
        if key.startswith("tier/prefix/"):
            for idx in self._prefixes.values():
                for toks, k in list(idx.items()):
                    if k == key:
                        del idx[toks]
        self._note_bytes()
        return True

    def _evict_over_budget(self, protect: Optional[str] = None) -> None:
        # the entry just paid for is immune for its own pass: a single
        # over-budget blob stays resident rather than thrashing
        if self.host_budget_bytes is None:
            return
        while self._bytes > self.host_budget_bytes and self._lru:
            victim = next(iter(self._lru))
            if victim == protect:
                return
            self._remove(victim)
            self.evictions += 1
            if self._metrics is not None:
                self._metrics.on_tier_evict()

    # -- row entries (preemption / handoff / failover copies) ---------------

    def put_row(self, req, payload: dict) -> None:
        """Spill one live row: its ``row_state`` payload packed through
        the wire codec under the request's id, superseding an older
        copy."""
        from bigdl_tpu_torch.serving.disagg import pack_payload, request_meta

        self._hot.pop(int(req.req_id), None)
        blob = pack_payload(request_meta(req), payload)
        self._put_blob(self._row_key(req.req_id), blob, count=True)

    def put_packed(self, blob: bytes, req_id: Optional[int] = None) -> None:
        """Stage an already-packed handoff blob (a confirmed delivery's
        failover copy, a decode worker's ingest, a replay form).
        Meta-only blobs are tracked but count no spill."""
        from bigdl_tpu_torch.serving.disagg import payload_header

        head = payload_header(blob)
        if req_id is None:
            req_id = int(head["request"]["req_id"])
        self._hot.pop(int(req_id), None)
        self._put_blob(self._row_key(req_id), blob,
                       count=head["carry_keys"] is not None)

    def has_row(self, req_id: int) -> bool:
        return self._row_key(req_id) in self._lru

    def get_blob(self, req_id: int) -> Optional[bytes]:
        """The raw packed blob of a request (or None), LRU-touched — the
        failover path re-routes it as is."""
        key = self._row_key(req_id)
        if key not in self._lru:
            return None
        blob = self.store.try_get(key)
        if blob is None:                  # the backing store lost it
            self._remove(key)
            return None
        self._lru.move_to_end(key)
        return blob

    def pop_blob(self, req_id: int) -> Optional[bytes]:
        """:meth:`get_blob` and drop — the cancel sweep's consume."""
        blob = self.get_blob(req_id)
        if blob is not None:
            self.drop_row(req_id)
        return blob

    def header(self, req_id: int) -> Optional[Dict]:
        """The header of a stored row blob (no array decode), or None."""
        from bigdl_tpu_torch.serving.disagg import payload_header

        blob = self.get_blob(req_id)
        return None if blob is None else payload_header(blob)

    def drop_row(self, req_id: int) -> None:
        """Forget a request's row entry (terminal dispositions, fault
        recovery). Idempotent."""
        self._hot.pop(int(req_id), None)
        self._remove(self._row_key(req_id))

    def _load_row(self, req) -> Optional[dict]:
        """Decode ``req``'s stored payload if the copy is CURRENT (its
        header's emitted stream equals the request's); a stale entry is
        dropped, and a meta-only form loads as None."""
        from bigdl_tpu_torch.serving.disagg import (
            payload_header, unpack_payload,
        )

        t0 = self._clock()
        key = self._row_key(req.req_id)
        if key not in self._lru:
            return None
        blob = self.store.try_get(key)
        if blob is None:
            self._remove(key)
            return None
        head = payload_header(blob)
        if head["carry_keys"] is None or \
                head["request"]["output"] != [int(t) for t in req.output]:
            self._remove(key)
            return None
        _, payload = unpack_payload(blob)
        # kept, freshly touched: it stays the failover copy until the
        # request finishes
        self._lru.move_to_end(key)
        self._fetched(len(blob), self._clock() - t0)
        return payload

    def fetch_row(self, req) -> Optional[dict]:
        """The readmission fetch: the request's spilled payload with CPU
        tensor leaves (what ``restore_row`` uploads), or None when no
        current copy exists and the row must replay through prefill."""
        payload = self._hot.pop(int(req.req_id), None)
        if payload is not None:
            return payload
        return self._load_row(req)

    def prefetch(self, reqs: Iterable) -> int:
        """Decode the blobs of an upcoming admission wave in one pass, so
        each :meth:`fetch_row` in the admission loop is a dict pop.
        Returns how many rows were staged."""
        n = 0
        for req in reqs:
            rid = int(req.req_id)
            if rid in self._hot or req.resume_carry is not None:
                continue
            payload = self._load_row(req)
            if payload is not None:
                self._hot[rid] = payload
                n += 1
        return n

    # -- prefix entries (PrefixCache demote/promote) ------------------------

    @staticmethod
    def _common(a: Tuple[int, ...], b: Tuple[int, ...]) -> int:
        n = min(len(a), len(b))
        for i in range(n):
            if a[i] != b[i]:
                return i
        return n

    def demote_prefix(self, tokens, carry, adapter_id: int = 0) -> None:
        """Store a capacity-evicted prefix carry instead of deleting it,
        packed through the wire codec under a synthetic header and keyed
        by (``adapter_id`` — the cache's namespace — and token path), so
        tenant namespaces never cross. Only unleased entries reach
        here."""
        from bigdl_tpu_torch.serving.disagg import pack_payload

        tokens = tuple(int(t) for t in tokens)
        if not tokens or carry is None:
            return
        aid = int(adapter_id)
        idx = self._prefixes.setdefault(aid, {})
        key = idx.get(tokens)
        if key is None:
            self._pf_seq += 1
            key = f"tier/prefix/{aid}/{self._pf_seq}"
        meta = {"kind": "prefix", "adapter": aid, "tokens": list(tokens)}
        blob = pack_payload(meta, {"carry": carry, "draft": None,
                                   "chunk_done": 0, "chunk_target": 0,
                                   "adapter": aid})
        idx[tokens] = key
        self._put_blob(key, blob, count=True)

    def promote_prefix(self, tokens, matched: int, adapter_id: int = 0,
                       device=None):
        """The lookup-side promotion: the stored prefix of the same
        namespace sharing the LONGEST common prefix with ``tokens``,
        strictly longer than the ``matched`` tokens the cache already
        serves, as ``(its token path, carry)`` with the carry uploaded to
        ``device`` (left on the host when None). The entry leaves the
        tier. None when nothing stored beats ``matched``."""
        from bigdl_tpu_torch.serving.disagg import unpack_payload

        idx = self._prefixes.get(int(adapter_id))
        if not idx:
            return None
        tokens = tuple(int(t) for t in tokens)
        best, best_use = None, int(matched)
        for p in idx:
            use = self._common(p, tokens)
            if use > best_use:
                best, best_use = p, use
        if best is None:
            return None
        t0 = self._clock()
        key = idx[best]
        blob = self.store.try_get(key)
        if blob is None:                  # the backing store lost it
            self._remove(key)
            return None
        _, decoded = unpack_payload(blob)
        self._remove(key)                 # promotion consumes the entry
        self._fetched(len(blob), self._clock() - t0)
        carry = decoded["carry"]
        if device is not None:
            carry = upload_leaves(carry, device)
        return best, carry

    def drop_prefix_namespaces(self, keep) -> None:
        """Drop the prefix entries of every namespace not in ``keep``
        (0 always stays): a freed tenant's prefixes can never be hit."""
        for ns in [n for n in self._prefixes if n and n not in keep]:
            for key in list(self._prefixes[ns].values()):
                self._remove(key)
            del self._prefixes[ns]

    # -- introspection -----------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    @property
    def entries(self) -> int:
        return len(self._lru)

    @property
    def prefix_entries(self) -> int:
        return sum(len(v) for v in self._prefixes.values())

    @property
    def row_entries(self) -> int:
        return self.entries - self.prefix_entries

    def stats(self) -> Dict[str, float]:
        return {"entries": float(self.entries),
                "rows": float(self.row_entries),
                "prefixes": float(self.prefix_entries),
                "bytes": float(self._bytes),
                "spills": float(self.spills),
                "fetches": float(self.fetches),
                "evictions": float(self.evictions),
                "spill_bytes": float(self.spill_bytes),
                "fetch_bytes": float(self.fetch_bytes)}
