"""Ref-counted radix-tree prefix cache over token prefixes
(``bigdl_tpu/serving/prefix_cache.py``, a copy of its pure-Python core).

The cache stores prefilled carries — B=1 decode-carry rows, K/V at
positions ``0..n-1`` and ``pos = n`` — keyed by the 0-based tokens that
produced them, in a path-compressed radix tree: one walk finds the
longest cached prefix of a new prompt. Admission (``admission.py``)
copies a full hit into the pool, or continues a partial hit with the
batch prefill's start offsets, prefilling only the suffix. Because K/V
is causal, a cached longer prompt serves any shorter shared prefix as a
TRUNCATED hit: the same tensors with a new ``pos``.

Lifecycle (pinned by tests/test_torch_serving_admission.py):

* ``acquire(tokens)`` returns ``(carry, matched_len, lease)`` for the
  longest cached prefix (``(None, 0, None)`` on a miss) and bumps the
  leased node's refcount: a leased entry is never evicted;
* ``release(lease)`` drops it (a double release raises);
* ``insert(tokens, carry)`` stores a carry, splitting edges as needed;
* capacity counts ENTRIES (each a full B=1 carry). Over ``max_entries``
  the least recently used entry with ``refs == 0`` goes and carry-less
  leaf chains are pruned; if every entry is leased, the cache overflows
  for a while rather than dropping live state.

Stored carries are shared and read-only: every consumer copies from them
(the pool's ``write_prefill``) or reads them (the prefill step never
writes its input carry), and inserters hand in fresh tensors, never
views of a pool or of a multi-row prefill output.

Trees are per namespace: the engine passes the request's
``AdapterBank.namespace`` (0 for the null adapter, else one number per
allocation of a bank slot), so K/V computed under one tenant's LoRA
factors never serves another tenant's prefix, not even the next tenant of
a freed slot, and :meth:`PrefixCache.drop_namespaces` lets a freed
tenant's trees go.

With a host tier (``tier=``, a :class:`~bigdl_tpu_torch.serving.kv_tier.
TieredKVStore`; the engine wires its own in), capacity eviction DEMOTES an
unleased carry to host memory instead of deleting it, keyed by namespace
and token path, and ``acquire`` PROMOTES the best stored prefix that
serves more of the prompt than the tree does back in as an ordinary
entry, uploaded to ``device`` (set by the engine), before it walks:
warm-prefix capacity is then bounded by the tier's byte budget, not by
``max_entries``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch


class _Node:
    """One radix-tree node: ``edge`` tokens hang below ``parent``;
    ``n_tokens`` is the prefix length from the root through this node;
    ``carry``, when present, is the prefilled carry for that prefix."""

    __slots__ = ("edge", "parent", "children", "carry", "n_tokens",
                 "refs", "last_used")

    def __init__(self, edge: Tuple[int, ...], parent: Optional["_Node"],
                 n_tokens: int) -> None:
        self.edge = edge
        self.parent = parent
        self.children: Dict[int, "_Node"] = {}
        self.carry = None
        self.n_tokens = n_tokens
        self.refs = 0
        self.last_used = 0


class PrefixCache:
    """Radix-tree cache of prefilled prompt prefixes (module docstring)."""

    def __init__(self, max_entries: int = 16, tier=None) -> None:
        if max_entries <= 0:
            raise ValueError(
                f"max_entries must be positive, got {max_entries}")
        self.max_entries = int(max_entries)
        # the optional host tier, and the device promoted carries are
        # uploaded to (None: left on the host); the engine sets both
        self.tier = tier
        self.device = None
        self.root = _Node((), None, 0)
        self._roots: Dict[int, _Node] = {0: self.root}
        self._carry_nodes: set = set()
        self._clock = 0
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    # -- tree walk ---------------------------------------------------------

    @staticmethod
    def _common(a: Sequence[int], b: Sequence[int]) -> int:
        n = min(len(a), len(b))
        for i in range(n):
            if a[i] != b[i]:
                return i
        return n

    @staticmethod
    def _subtree_carry(node: _Node) -> Optional[_Node]:
        """Any carry-bearing node in ``node``'s subtree: every one shares
        ``node``'s full prefix, so any serves a truncated hit for it."""
        stack = [node]
        while stack:
            n = stack.pop()
            if n.carry is not None:
                return n
            stack.extend(n.children.values())
        return None

    def _walk(self, tokens: Tuple[int, ...], root: _Node):
        """Longest usable cached prefix of ``tokens``: ``(node,
        matched_len)`` with ``matched_len <= node.n_tokens``; strictly
        less is a truncated hit."""
        node, i, best, best_len = root, 0, None, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                break
            m = self._common(child.edge, tokens[i:])
            if m == len(child.edge):
                node = child
                i += m
                if node.carry is not None:
                    best, best_len = node, i
                continue
            # ran out mid-edge after m shared tokens
            if m > 0:
                deep = self._subtree_carry(child)
                if deep is not None:
                    best, best_len = deep, i + m
            break
        # a carry-less interior node fully matched: any carry below it
        # serves a truncated hit at depth i
        if i > best_len:
            deep = self._subtree_carry(node)
            if deep is not None:
                best, best_len = deep, i
        return best, best_len

    # -- lease surface -----------------------------------------------------

    def acquire(self, tokens: Sequence[int], namespace: int = 0):
        """Longest-cached-prefix lookup with a lease: ``(carry,
        matched_len, lease)``, or ``(None, 0, None)`` on a miss. A
        truncated hit's carry is a new dict with a new ``pos`` tensor
        over the entry's own (read-only) K/V tensors."""
        self.lookups += 1
        tokens = tuple(int(t) for t in tokens)
        root = self._roots.get(int(namespace))
        if root is None:
            best, matched = None, 0
        else:
            best, matched = self._walk(tokens, root)
        if self.tier is not None:
            # a demoted prefix serving MORE of the prompt comes back as an
            # entry (immune for its insert's pass), then the re-walk
            # serves it as an ordinary, possibly truncated, hit
            promo = self.tier.promote_prefix(tokens, matched,
                                             adapter_id=int(namespace),
                                             device=self.device)
            if promo is not None:
                ptoks, carry = promo
                self.insert(ptoks, carry, namespace=int(namespace))
                best, matched = self._walk(tokens,
                                           self._roots[int(namespace)])
        if best is None:
            return None, 0, None
        best.refs += 1
        self._touch(best)
        self.hits += 1
        self.hit_tokens += matched
        carry = best.carry
        if best.n_tokens > matched:
            carry = dict(carry)
            carry["pos"] = torch.full_like(carry["pos"], matched)
        return carry, matched, best

    def release(self, lease) -> None:
        """Drop an :meth:`acquire` lease (no-op for a miss's None)."""
        if lease is None:
            return
        if lease.refs <= 0:
            raise ValueError("release without a matching acquire")
        lease.refs -= 1

    # -- insertion / eviction ----------------------------------------------

    def insert(self, tokens: Sequence[int], carry,
               namespace: int = 0) -> None:
        """Store ``carry`` as the prefill state for exactly ``tokens``
        (0-based ids, non-empty) in the ``namespace`` tree."""
        tokens = tuple(int(t) for t in tokens)
        if not tokens:
            raise ValueError("cannot cache an empty prefix")
        namespace = int(namespace)
        root = self._roots.get(namespace)
        if root is None:
            root = self._roots[namespace] = _Node((), None, 0)
        node, i = root, 0
        while i < len(tokens):
            child = node.children.get(tokens[i])
            if child is None:
                child = _Node(tokens[i:], node, len(tokens))
                node.children[tokens[i]] = child
                node, i = child, len(tokens)
                continue
            m = self._common(child.edge, tokens[i:])
            if m == len(child.edge):
                node, i = child, i + m
                continue
            # split the edge at the divergence point
            mid = _Node(child.edge[:m], node, node.n_tokens + m)
            node.children[tokens[i]] = mid
            child.edge = child.edge[m:]
            child.parent = mid
            mid.children[child.edge[0]] = child
            node, i = mid, i + m
        if node.carry is None:
            self._carry_nodes.add(node)
        node.carry = carry
        self._touch(node)
        self._evict_over_capacity(protect=node)

    def drop_namespaces(self, keep) -> None:
        """Drop every tree whose namespace is not in ``keep`` with all its
        entries (namespace 0 always stays). A lease on a dropped entry
        stays valid: its carry lives on with its holder."""
        for ns in [n for n in self._roots if n and n not in keep]:
            stack = [self._roots.pop(ns)]
            while stack:
                node = stack.pop()
                self._carry_nodes.discard(node)
                stack.extend(node.children.values())
        if self.tier is not None:
            self.tier.drop_prefix_namespaces(keep)

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.last_used = self._clock

    def _evict_over_capacity(self, protect: Optional[_Node] = None) -> None:
        # the fresh insert is immune for this pass; with everything else
        # leased the cache overflows instead
        while len(self._carry_nodes) > self.max_entries:
            victims = [n for n in self._carry_nodes
                       if n.refs == 0 and n is not protect]
            if not victims:
                return
            victim = min(victims, key=lambda n: n.last_used)
            self._drop(victim)
            self.evictions += 1

    def _path_of(self, node: _Node):
        """``node``'s full token path from its namespace's root and that
        namespace ((tokens, None) for a detached node): the key a
        demotion is stored under."""
        parts = []
        n = node
        while n.parent is not None:
            parts.append(n.edge)
            n = n.parent
        tokens = tuple(t for e in reversed(parts) for t in e)
        for ns, root in self._roots.items():
            if root is n:
                return tokens, ns
        return tokens, None

    def _drop(self, node: _Node) -> None:
        # only capacity eviction reaches here, and only for refs == 0
        # entries, so a demoted carry never has a live lease
        if self.tier is not None and node.carry is not None:
            tokens, ns = self._path_of(node)
            if tokens and ns is not None:
                self.tier.demote_prefix(tokens, node.carry, adapter_id=ns)
        node.carry = None
        self._carry_nodes.discard(node)
        # prune carry-less leaves up the path
        while (node.parent is not None and node.carry is None
               and not node.children and node.refs == 0):
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    # -- introspection -----------------------------------------------------

    @property
    def entries(self) -> int:
        return len(self._carry_nodes)

    def cached_prefixes(self) -> List[int]:
        """Lengths of every cached prefix, sorted."""
        return sorted(n.n_tokens for n in self._carry_nodes)

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def stats(self) -> Dict[str, float]:
        return {"entries": float(self.entries),
                "lookups": float(self.lookups), "hits": float(self.hits),
                "hit_tokens": float(self.hit_tokens),
                "evictions": float(self.evictions),
                "hit_rate": self.hit_rate()}
