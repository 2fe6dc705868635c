"""Disaggregated serving: a prefill pool and decode pools with KV-row
handoff (``bigdl_tpu/serving/disagg.py``; the DistServe/Splitwise
pattern).

One engine interleaves prompt ingestion and decode, so a burst of long
prompts steals decode steps from every row in flight. The plane runs
admission (prefill, prefix cache) on a PREFILL POOL and the decode /
sample / verify step on DECODE POOLS, and hands each finished KV row
across, so decode rows never wait on anyone's prompt and each pool
scales on its own axis. Every pool wraps a stock
:class:`~bigdl_tpu_torch.serving.engine.ServingEngine`:

* ``KVPool.row_state()`` serializes everything a row carries (K/V and
  int8 scales, ``pos``, RNG lane, penalty counts, prompt mask, the chunk
  mirrors, the adapter id, the draft row) and ``restore_row()`` is its
  byte-identical inverse — the same API the engine's preemption stash
  speaks;
* the host tier (``kv_tier.py``), ONE per plane and shared by every
  pool, holds handed-off rows as packed wire bytes: a handoff is
  admitted into a decode pool exactly like a preempted row resuming;
* the wire (:func:`pack_payload`) is a JSON header and one
  self-describing ``block_store`` array blob per leaf, read off the card
  in ONE fenced copy (``fence("transfer", ...)``);
  :class:`InProcessTransfer` carries the same bytes as
  :class:`BlockStoreTransfer`, so the in-process plane exercises the
  real format.

Contracts: **token identity** — a row's stream depends only on its own
carry and the weights, so greedy and fixed-seed sampled outputs equal
the monolithic engine's through prefix hits, evict/readmit inside a
decode pool, transfer faults and pool deaths (sampling lanes ride the
payload, seeded from the GLOBAL request id); **closed accounting** — the
``finish_<reason>`` counters of all pools sum to the submitted total.
The front end adds ``serving/handoffs``, ``transfer_bytes``,
``transfer_s`` and the pools' occupancies.

**Pool health** (``health.py``): each decode pool is a failure domain.
Heartbeats per completed worker step and transfer verdicts classify it
HEALTHY / SUSPECT / DEAD; SUSPECT pools get no new handoffs; a DEAD pool
fails over (:meth:`DisaggregatedEngine._failover_pool`): payloads on its
wire re-route untouched, rows whose tier copy is still current migrate
bitwise, and the rest replay ``prompt + emitted`` through prefill.
:meth:`DisaggregatedEngine.drain_pool` retires a live pool gracefully,
and the occupancy autoscaler activates standby pools and drains cold
ones with hysteresis. Sends back off exponentially per request, a send
past ``send_timeout_s`` is resent (receivers deduplicate by request id,
across pools), and ``cancel`` sweeps payloads still on a wire.

**Against the JAX package**: the wire header (``request_meta``: the
request's budgets, ``asdict(SamplingParams)``, adapter id and constraint
meta; the chunk mirrors; the sorted carry key lists) is JSON-identical
to the JAX plane's for the same request. The leaves are the port's own
carry — its ``rng`` lanes are ``(N, 2)`` int64 ``(seed, draws)`` pairs,
not threefry keys — so a payload crosses between the packages
header-exact, not leaf for leaf.

    from bigdl_tpu_torch.serving import DisaggregatedEngine

    eng = DisaggregatedEngine(lm, prefill_slots=8, decode_slots=8,
                              decode_pools=2, prefix_cache=True)
    rid = eng.submit([3, 7, 2], max_new_tokens=32)
    outs = eng.drain()                  # {rid: 1-based token ids}
    eng.summary()["serving/handoffs"]
"""

from __future__ import annotations

import json
import struct
from collections import deque
from dataclasses import asdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from bigdl_tpu_torch.parallel.block_store import (
    BlockStore, decode_array, encode_array,
)
from bigdl_tpu_torch.serving.engine import ServingEngine
from bigdl_tpu_torch.serving.faults import FaultError, default_clock
from bigdl_tpu_torch.serving.fences import fence
from bigdl_tpu_torch.serving.health import (
    DEAD, HEALTHY, POOL_ACTIVE, POOL_DEAD, POOL_STANDBY, AutoscalerConfig,
    HealthConfig, OccupancyAutoscaler, PoolHealth, TransferRetryConfig,
)
from bigdl_tpu_torch.serving.kv_tier import TieredKVStore
from bigdl_tpu_torch.serving.metrics import ServingMetrics
from bigdl_tpu_torch.serving.sampling import SamplingParams
from bigdl_tpu_torch.serving.scheduler import CANCELLED, FINISHED, Request

#: THE serialized row-payload schema — every top-level key a handoff
#: payload may carry. ``carry`` is the B=1 target-carry slice, ``draft``
#: the optional draft-carry slice, ``chunk_done``/``chunk_target`` the
#: host chunk mirrors, ``adapter`` the row's LoRA adapter slot id
#: (``serving/lora.py`` — rides the wire so a restored row keeps
#: gathering its tenant's factors), and ``request`` the wire header's
#: request metadata. Closed, like ``ServingMetrics.FINISH_REASONS``.
ROW_PAYLOAD_KEYS = ("request", "carry", "draft", "chunk_done",
                    "chunk_target", "adapter")

_WIRE_MAGIC = b"BDRH"                  # row-handoff wire format v1


# -- request metadata <-> wire header ---------------------------------------

def request_meta(req: Request) -> Dict:
    """The JSON-serializable request half of a handoff payload: enough
    to reconstruct the request at the decode pool with its GLOBAL id
    (the RNG-lane key is a function of (engine seed, req_id), so the
    id must survive the wire), its post-degrade budgets, and its
    stream-so-far (empty for the normal prefill-complete handoff; the
    general mid-stream form keeps the codec future-proof)."""
    return {
        "req_id": int(req.req_id),
        "prompt": [int(t) for t in req.prompt],
        "output": [int(t) for t in req.output],
        "logprobs": [float(v) for v in req.logprobs],
        "max_new_tokens": int(req.max_new_tokens),
        "eos_id": int(req.eos_id),
        "sampling": asdict(req.sampling if req.sampling is not None
                           else SamplingParams()),
        "draft_tokens": req.draft_tokens,
        "priority": int(req.priority),
        "deadline_s": req.deadline_s,
        "submit_time": float(req.submit_time),
        "first_token_time": req.first_token_time,
        # fault-budget continuity: a row bounced across pools by
        # repeated failures must keep burning ONE watchdog retry
        # budget, not get a fresh one per pool
        "retries": int(req.retries),
        "preemptions": int(req.preemptions),
        # multi-tenant plane (serving/lora.py, serving/constrain.py):
        # the adapter id must survive the wire so the decode pool
        # gathers the same tenant's factors, and the constraint
        # travels as its AUTOMATON meta — never a cursor: the
        # receiver rebuilds the cursor from the emitted prefix
        # (constraint.cursor(req.output)), THE replay rule
        "adapter_id": int(req.adapter_id),
        "constraint": (None if req.constraint is None
                       else req.constraint.to_meta()),
    }


def request_from_meta(meta: Dict) -> Request:
    """Reconstruct a :class:`Request` from its wire header (the decode
    side of :func:`request_meta`). ``seq`` stays unset — the receiving
    scheduler assigns its own arrival order, which is handoff order."""
    sp = dict(meta["sampling"])
    req = Request(
        req_id=int(meta["req_id"]),
        prompt=[int(t) for t in meta["prompt"]],
        max_new_tokens=int(meta["max_new_tokens"]),
        eos_id=int(meta["eos_id"]),
        sampling=SamplingParams(**sp),
        draft_tokens=meta.get("draft_tokens"),
        priority=int(meta.get("priority", 0)),
        deadline_s=meta.get("deadline_s"),
        submit_time=float(meta.get("submit_time", 0.0)),
        adapter_id=int(meta.get("adapter_id", 0)))
    cmeta = meta.get("constraint")
    if cmeta is not None:
        from bigdl_tpu_torch.serving.constrain import TokenDFA

        req.constraint = TokenDFA.from_meta(cmeta)
    req.output = [int(t) for t in meta.get("output", ())]
    req.logprobs = [float(v) for v in meta.get("logprobs", ())]
    req.first_token_time = meta.get("first_token_time")
    req.retries = int(meta.get("retries", 0))
    req.preemptions = int(meta.get("preemptions", 0))
    return req


# -- the wire codec ---------------------------------------------------------

def pack_payload(meta: Dict, payload: Optional[Dict]) -> bytes:
    """Serialize one handoff — request header + ``KVPool.row_state``
    payload — to bytes: a JSON header (request metadata, chunk mirrors,
    and the ORDERED carry/draft key lists) followed by one
    length-prefixed :func:`~bigdl_tpu_torch.parallel.block_store.
    encode_array` blob per leaf. Every leaf rides the self-describing array codec, so
    the receiver needs no out-of-band dtype/shape agreement (bf16 and
    int8 carries round-trip bitwise).

    ``payload=None`` packs a META-ONLY handoff (``carry_keys`` null, no
    array blobs): the REPLAY form pool failover sends when a dead
    pool's row has no current state copy — the receiver reconstructs
    the request and replays ``prompt + emitted`` through prefill
    (byte-identical, the engine's recovery contract)."""
    if payload is None:
        head = {"request": meta, "chunk_done": 0, "chunk_target": 0,
                "carry_keys": None, "draft_keys": None}
        hj = json.dumps(head).encode()
        return b"".join([_WIRE_MAGIC, struct.pack("<q", len(hj)), hj])
    carry = payload["carry"]
    draft = payload.get("draft")
    head = {
        "request": meta,
        "chunk_done": int(payload["chunk_done"]),
        "chunk_target": int(payload["chunk_target"]),
        "adapter": int(payload["adapter"]),
        "carry_keys": sorted(carry),
        "draft_keys": None if draft is None else sorted(draft),
    }
    hj = json.dumps(head).encode()
    parts = [_WIRE_MAGIC, struct.pack("<q", len(hj)), hj]
    # serialization IS a device→host crossing, so it goes through the
    # declared fence (serving/fences.py): ONE device→host copy of every
    # payload leaf and one host wait, not a sync per leaf
    ordered = [carry[k] for k in head["carry_keys"]]
    if draft is not None:
        ordered += [draft[k] for k in head["draft_keys"]]
    host = fence("transfer", *ordered)
    if len(ordered) == 1:
        host = (host,)
    for arr in host:
        blob = encode_array(arr)
        parts.append(struct.pack("<q", len(blob)))
        parts.append(blob)
    return b"".join(parts)


def payload_header(blob: bytes) -> Dict:
    """Just the JSON header of a packed handoff — request metadata and
    key lists, no array decode. The cheap read failover and the cancel
    sweep use for bookkeeping (is this stash copy still current? whose
    row is on this wire?) without touching the payload bytes."""
    if blob[:4] != _WIRE_MAGIC:
        raise ValueError("not a row-handoff payload")
    (nh,) = struct.unpack_from("<q", blob, 4)
    return json.loads(blob[12:12 + nh].decode())


def unpack_payload(blob: bytes) -> Tuple[Dict, Optional[Dict]]:
    """Inverse of :func:`pack_payload`: ``(request metadata, row_state
    payload)`` with CPU tensor leaves — what ``KVPool.restore_row``
    uploads in one copy. A meta-only (replay) handoff returns
    ``payload=None``."""
    if blob[:4] != _WIRE_MAGIC:
        raise ValueError("not a row-handoff payload")
    off = 4
    (nh,) = struct.unpack_from("<q", blob, off)
    off += 8
    head = json.loads(blob[off:off + nh].decode())
    off += nh
    if head["carry_keys"] is None:
        return head["request"], None

    view = memoryview(blob)            # leaves decode without a slice copy

    def _arrays(keys):
        nonlocal off
        out = {}
        for k in keys:
            (nb,) = struct.unpack_from("<q", blob, off)
            off += 8
            out[k] = decode_array(view[off:off + nb])
            off += nb
        return {k: v.reshape(1) if v.dim() == 0 else v
                for k, v in out.items()}

    payload = {
        "carry": _arrays(head["carry_keys"]),
        "draft": (None if head["draft_keys"] is None
                  else _arrays(head["draft_keys"])),
        "chunk_done": int(head["chunk_done"]),
        "chunk_target": int(head["chunk_target"]),
        "adapter": int(head.get("adapter", 0)),
    }
    return head["request"], payload


# -- transfer backends ------------------------------------------------------

class KVTransfer:
    """One ordered byte channel from the prefill pool to ONE decode
    worker. ``send`` publishes a packed handoff; ``recv`` returns the
    next pending payload or None when the channel is empty (never
    blocks — the decode loop polls between steps). Backends:
    :class:`InProcessTransfer` (a deque, for tests and the in-process
    engine) and :class:`BlockStoreTransfer` (any
    :class:`~bigdl_tpu_torch.parallel.block_store.BlockStore` — the
    cross-process production shape). Both carry the SAME packed bytes,
    so the in-process tests exercise the real wire format."""

    def send(self, blob: bytes) -> None:
        raise NotImplementedError

    def recv(self) -> Optional[bytes]:
        raise NotImplementedError

    def pending(self) -> int:
        """Sent-but-not-received payloads (drain/idle bookkeeping)."""
        raise NotImplementedError


class InProcessTransfer(KVTransfer):
    """Same-process queue backend: a deque of packed payloads."""

    def __init__(self) -> None:
        self._q: deque = deque()

    def send(self, blob: bytes) -> None:
        self._q.append(bytes(blob))

    def recv(self) -> Optional[bytes]:
        return self._q.popleft() if self._q else None

    def pending(self) -> int:
        return len(self._q)


class BlockStoreTransfer(KVTransfer):
    """Cross-process backend over a :class:`BlockStore`: sender and
    receiver each track their own monotone sequence number, so the
    channel is ordered with no coordination beyond the store itself
    (``FsBlockStore`` for same-host processes). Received keys are
    deleted, so the store never grows past the in-flight window.
    ``pending()`` probes the receiver's NEXT key only — cheap, and
    sufficient for the drain loop's "anything left?" question."""

    def __init__(self, store: BlockStore, channel: str = "disagg") -> None:
        self.store = store
        self.channel = str(channel)
        self._sent = 0
        self._received = 0

    def _key(self, n: int) -> str:
        return f"{self.channel}/row_{n:08d}"

    def send(self, blob: bytes) -> None:
        self.store.put(self._key(self._sent), blob)
        self._sent += 1

    def recv(self) -> Optional[bytes]:
        blob = self.store.try_get(self._key(self._received))
        if blob is None:
            return None
        self.store.delete(self._key(self._received))
        self._received += 1
        return blob

    def pending(self) -> int:
        # when sender and receiver share this object (the in-process
        # engine), the counters give the EXACT in-flight depth — the
        # least-loaded router needs the real number, or a same-step
        # burst all lands on whichever worker tied at "1". A pure
        # receiver (its own process; _sent == 0) falls back to a cheap
        # existence probe of its next key — never a payload fetch
        n = self._sent - self._received
        if n > 0:
            return n
        return 1 if self.store.contains(self._key(self._received)) else 0


# -- the prefill pool -------------------------------------------------------

class PrefillWorker:
    """Owns ADMISSION: the waiting queue, batched or chunked prompt
    ingestion, the prefix cache, sampling-lane seeding, and — on
    speculative configs — the draft-cache prefill. Produces COMPLETED
    KV rows: every pump, rows whose prompts are fully resident are
    serialized via ``pool.row_state()`` and released (slot freed for
    the next admission wave), never decoded here.

    Wraps a stock :class:`ServingEngine`, so every admission behavior —
    bucketed prefill, chunked streaming, prefix-cache reuse,
    backpressure/deadline shedding at the door, admission-side fault
    recovery — is the SAME code the monolithic engine runs.

    ``transfer`` is optional: with one attached (the standalone
    cross-process shape), :meth:`pump` packs and sends each finished
    row itself, requeueing loss-free on a failed send; without one (the
    in-process :class:`DisaggregatedEngine` shape) it returns
    ``(request, payload)`` pairs and the front end routes them."""

    def __init__(self, model, n_slots: int = 8,
                 transfer: Optional[KVTransfer] = None,
                 retry: Optional[TransferRetryConfig] = None,
                 **engine_kw) -> None:
        self.engine = ServingEngine(model, n_slots=n_slots, **engine_kw)
        self.transfer = transfer
        self.retry = retry if retry is not None else TransferRetryConfig()
        self._peak_occupancy = 0.0
        # exponential-backoff parking lot: (due_time, request) entries
        # a failed handoff deferred — pump() releases them back into
        # the queue once the engine clock passes their due time, so a
        # down fabric is probed at a decaying rate instead of
        # hammered every pump
        self._deferred: List[Tuple[float, Request]] = []

    def submit(self, *args, **kwargs) -> int:
        """Queue one request (the :meth:`ServingEngine.submit`
        surface, including backpressure shedding at the door)."""
        return self.engine.submit(*args, **kwargs)

    def _release(self, slot: int, req: Request) -> Dict:
        # the row leaves this pool entirely: its lifecycle continues at
        # a decode worker, so its FULL row_state payload is captured
        # FIRST (a row leaves the tables only as a handoff payload, a
        # requeue, or a finish disposition), then it is popped (not
        # finished) and its slot returns to the free list for the next
        # admission wave
        payload = self.engine.pool.row_state(slot)
        del self.engine.scheduler.running[slot]
        req.slot = None
        self.engine.pool.free(slot)
        self.engine._configured.discard(slot)
        self.engine._restored.discard(slot)
        # the cursor never travels — the decode pool rebuilds it from
        # the emitted prefix at slot configuration (the replay rule)
        self.engine._constraints.pop(slot, None)
        return payload

    def requeue(self, req: Request, payload: Dict) -> None:
        """Loss-free return of a handoff that could not be delivered
        (fault during pack or transfer): the payload goes back on the
        request and it re-enters the queue at its ORIGINAL arrival
        key — at the next due pump it restores byte-identically (no
        prefill replay) and hands off again. Re-entry BACKS OFF
        exponentially per request (``TransferRetryConfig.delay`` on
        the engine clock — attempt n waits base·2^(n-1) up to the
        cap), and the whole loop is BOUNDED by the engine watchdog's
        ``max_retries`` (the step-recovery budget): a persistently
        failing fabric fails the REQUEST with
        ``finish_reason='error'`` instead of wedging ``drain()`` in a
        restore→pack→send loop forever — the same liveness contract
        the step watchdog enforces."""
        eng = self.engine
        req.retries += 1
        mr = eng.watchdog.max_retries
        if mr is not None and req.retries > mr:
            eng._ledger_finish(req, "error", eng._clock())
            return
        eng._spill_or_carry(req, payload)
        eng.metrics.on_retry()
        delay = self.retry.delay(req.retries)
        if delay > 0:
            self._deferred.append((eng._clock() + delay, req))
        else:
            eng.scheduler.submit(req)

    def send_handoff(self, transfer: KVTransfer, req: Request,
                     payload: Optional[Dict], metrics: ServingMetrics,
                     health: Optional[PoolHealth] = None
                     ) -> Optional[bytes]:
        """Pack and send one handoff through the guarded path: the
        send consults the engine's fault injector (site
        ``"transfer"`` — the ``transfer_stall`` mode lands
        here), a raise OR an elapsed time past the configured
        ``send_timeout_s`` requeues the request loss-free with
        backoff (delivery unconfirmed — the RECEIVER deduplicates by
        request id in case a slow send did land), and the verdict
        feeds the target pool's health record. Returns the packed
        blob on confirmed delivery, None when the request was
        requeued (or failed out past the retry budget)."""
        eng = self.engine
        t0 = eng._clock()
        try:
            # pack INSIDE the recovery scope: the row already left
            # every scheduler table, so a serialization failure (the
            # transfer fence's copy can surface real device errors)
            # must requeue it, not lose it
            blob = pack_payload(request_meta(req), payload)
            # the send consults the injector directly: it moves host
            # bytes (every device byte was fenced inside pack_payload),
            # so the elapsed time below is the pack + send wall
            if eng._faults is not None:
                eng._faults.call("transfer", transfer.send, blob)
            else:
                transfer.send(blob)
        except Exception:
            if health is not None:
                health.on_transfer_failure()
            self.requeue(req, payload)
            return None
        elapsed = eng._clock() - t0
        to = self.retry.send_timeout_s
        if to is not None and elapsed > to:
            # the send returned, but past the timeout the caller had
            # already abandoned it: treat delivery as UNCONFIRMED —
            # resend after backoff (ingest-side dedup absorbs the
            # case where the slow send did land) and mark the fabric
            if health is not None:
                health.on_transfer_failure()
            metrics.on_transfer_timeout()
            self.requeue(req, payload)
            return None
        if health is not None:
            health.on_transfer_ok()
        metrics.on_handoff(len(blob), elapsed)
        return blob

    def pump(self) -> List[Tuple[Request, Dict]]:
        """One admission super-step: release due backoff entries,
        deadline/feasibility drops, slot binding, bucketed (or
        chunked) prefill, then serialize-and-release every
        prompt-complete row. Returns the finished ``(request,
        row_state payload)`` pairs (empty when a transfer is
        attached — those were sent)."""
        eng = self.engine
        now = eng._clock()
        if self._deferred:
            due = [e for e in self._deferred if e[0] <= now]
            if due:
                self._deferred = [e for e in self._deferred
                                  if e[0] > now]
                for _, req in due:
                    eng.scheduler.submit(req)
        eng._admit()
        if eng.admitter is not None:
            eng.admitter.pump()
        # sample occupancy at its per-pump PEAK — after admission,
        # BEFORE the completed rows release their slots (post-release
        # the batched pool is empty by construction, and a pool-sizing
        # signal that always reads 0 can never fire)
        self._peak_occupancy = eng.pool.occupancy()
        out: List[Tuple[Request, Dict]] = []
        for slot, req in list(eng.scheduler.running.items()):
            if slot not in eng._configured:
                try:
                    # seeds the row's RNG lane/penalty counts (and the
                    # draft cache) so the payload carries them — the
                    # decode pool restores, never reseeds
                    eng._configure_slot(slot, req)
                except FaultError:
                    eng._recover_admission([(slot, req)])
                    continue
            payload = self._release(slot, req)
            if self.transfer is None:
                out.append((req, payload))
                continue
            self.send_handoff(self.transfer, req, payload, eng.metrics)
        return out

    def idle(self) -> bool:
        return self.engine.scheduler.idle() and not self._deferred

    def cancel_deferred(self, req_id: int) -> Optional[Request]:
        """Remove and return a request parked in the backoff lot
        (failed/timed-out handoff awaiting its retry window), or None.
        Cancellation must reach it here: a deferred request is in NO
        scheduler and has no stash entry (the stash records confirmed
        deliveries only), so without this sweep it would be
        uncancellable until its resend."""
        for k, (_, req) in enumerate(self._deferred):
            if req.req_id == req_id:
                del self._deferred[k]
                return req
        return None

    @property
    def occupancy(self) -> float:
        """The last pump's PEAK slot occupancy (admitted rows before
        their release) — the prefill pool-sizing signal. The live
        post-pump occupancy is 0 by construction under batched
        admission (completed rows hand off immediately)."""
        return self._peak_occupancy


# -- the decode pool --------------------------------------------------------

class DecodeWorker:
    """Owns the DECODE/sample/verify super-step over its own
    :class:`~bigdl_tpu_torch.serving.kv_pool.KVPool`: handed-off rows
    arrive as packed payloads, are parked in the shared host tier (or
    ride ``resume_carry`` on a tier-less engine), and are admitted
    through the engine's byte-exact restore path — a handoff is admitted
    exactly like a preempted row resuming. Decode never runs prompt
    prefill EXCEPT fault-recovery replay (a suspect row's carry is never
    trusted — the engine re-prefills ``prompt + output``).

    Wraps a stock :class:`ServingEngine` too, so priority preemption
    inside the pool, the watchdog, fault injection, finish-reason
    accounting, and the per-pool metrics plane all come for free.
    ``seed`` must match the front end's: a fault-recovery replay
    rebuilds RNG lanes from (seed, GLOBAL req_id)."""

    def __init__(self, model, n_slots: int = 8,
                 transfer: Optional[KVTransfer] = None,
                 cancelled: Optional[Set[int]] = None,
                 claims: Optional[Dict[int, "DecodeWorker"]] = None,
                 **engine_kw) -> None:
        self.engine = ServingEngine(model, n_slots=n_slots, **engine_kw)
        self.transfer = transfer if transfer is not None \
            else InProcessTransfer()
        # liveness: a killed pool (process crash) runs nothing — the
        # front end stops stepping it and its missed heartbeats (or an
        # immediate kill_pool) classify it DEAD (serving/health.py)
        self.alive = True
        # shared cancel-sweep set (DisaggregatedEngine.cancel): request
        # ids cancelled while their payload was still on the wire —
        # ingest drops them so a cancelled row is never restored
        self._cancelled = cancelled if cancelled is not None else set()
        # shared delivery-claims registry (req_id -> the worker that
        # last admitted it): duplicate suppression must span POOLS —
        # a timed-out resend routes least-loaded, so the copy can land
        # on a different pool than the slow original. Standalone
        # workers get a private dict (self-claims only).
        self._claims = claims if claims is not None else {}

    def _owns(self, req_id: int) -> bool:
        """Is this request already anywhere in the worker (queued,
        slot-holding, or finished)? The duplicate-suppression check
        behind at-least-once sends: a timed-out handoff is resent, and
        if the slow original DID land, the copy must be dropped."""
        eng = self.engine
        if req_id in eng._finished:
            return True
        sched = eng.scheduler
        return (any(r.req_id == req_id for r in sched.running.values())
                or any(r.req_id == req_id
                       for r in sched.partial.values())
                or any(e[1].req_id == req_id for e in sched._waiting))

    def ingest(self, blob: bytes) -> Optional[int]:
        """Accept one packed handoff: reconstruct the request (global
        id intact) with its payload as ``resume_carry`` and queue it —
        the next step's admission restores the row bitwise (or, for a
        meta-only REPLAY handoff, re-prefills ``prompt + emitted``
        byte-identically). Returns the request id, or None when the
        payload was dropped: swept as cancelled mid-flight, or a
        duplicate of a row some pool already owns (a timed-out send
        that landed after its resend — checked across POOLS through
        the shared claims registry, then locally). A claim whose
        worker no longer owns the row (failover/drain moved it out)
        does not block: legitimate re-ingest after migration."""
        meta, payload = unpack_payload(blob)
        rid = int(meta["req_id"])
        if rid in self._cancelled:
            return None
        holder = self._claims.get(rid)
        if holder is not None and holder is not self \
                and holder._owns(rid):
            return None                      # cross-pool duplicate
        if self._owns(rid):
            return None                      # same-pool duplicate
        req = request_from_meta(meta)
        if self.engine.tier is not None and payload is not None:
            # the packed wire bytes ARE the row's tier entry: park
            # them in the shared host tier instead of a per-request
            # blob — admission fetches them back currency-checked
            self.engine.tier.put_packed(blob, req_id=rid)
        else:
            req.resume_carry = payload
        self.engine.scheduler.submit(req)
        self._claims[rid] = self
        return rid

    def poll(self) -> int:
        """Drain the transfer channel into the queue; returns how many
        rows were accepted."""
        n = 0
        while True:
            blob = self.transfer.recv()
            if blob is None:
                return n
            if self.ingest(blob) is not None:
                n += 1

    def step(self) -> Dict[int, int]:
        """Poll the channel, then one engine super-step (admission of
        restored rows + the batched decode/verify dispatch). A dead
        worker steps nothing — a crashed process runs no code."""
        if not self.alive:
            return {}
        self.poll()
        return self.engine.step()

    @property
    def load(self) -> int:
        """Rows this worker is responsible for (queued + slot-holding
        + still on the wire) — the least-loaded routing key."""
        return (self.engine.scheduler.queue_depth
                + self.engine.scheduler.active
                + self.transfer.pending())

    def idle(self) -> bool:
        return self.engine.scheduler.idle() \
            and self.transfer.pending() == 0

    @property
    def occupancy(self) -> float:
        return self.engine.pool.occupancy()


# -- the front end ----------------------------------------------------------

class DisaggregatedEngine:
    """The disaggregated serving plane behind the familiar engine
    surface (``submit``/``step``/``drain``/``result``/``cancel``):
    ONE :class:`PrefillWorker` (admission + prefix cache) feeding
    ``decode_pools`` :class:`DecodeWorker` s over per-worker transfer
    channels, least-loaded routing, and loss-free requeue when a
    transfer fails mid-handoff.

    Construction knobs mirror :class:`ServingEngine` where they apply:
    ``admission``/``chunk_budget``/``prefix_cache``/``max_queue``/
    ``deadline_feasibility`` shape the PREFILL pool (admission lives
    there); ``policy``/``preemption`` shape the DECODE pools
    (decode-side scheduling lives there — the prefill pool shares the
    policy for admission ORDER only); ``watchdog`` applies to both
    (step recovery in the decode pools; its ``max_retries`` also
    bounds the prefill side's transfer-retry budget); ``compute_dtype``/
    ``kv_dtype``/``speculative``/``seed``/``clock``/``faults`` apply to
    both (the pools must agree on the carry layout, and lanes are
    seeded from the global seed + request id), as do ``adapters`` (ONE
    bank shared by every pool), ``tier`` (ONE host tier, built when None
    or True) and ``device`` (every pool on one card). ``transfer_factory``
    builds one channel per decode worker (default
    :class:`InProcessTransfer`; pass e.g. ``lambda i:
    BlockStoreTransfer(store, f"decode{i}")`` for a shared store).

    POOL LIFECYCLE knobs (``serving/health.py``; module docstring):
    ``standby_pools`` builds extra decode workers that start idle
    (weights resident); ``health`` (a :class:`~bigdl_tpu_torch.serving.
    health.HealthConfig`) sets the heartbeat/transfer-failure thresholds
    behind the HEALTHY/SUSPECT/DEAD classification; ``transfer_retry``
    (a :class:`~bigdl_tpu_torch.serving.health.TransferRetryConfig`)
    sets the send timeout and per-request exponential backoff;
    ``autoscaler`` (an :class:`~bigdl_tpu_torch.serving.health.
    AutoscalerConfig`, or
    ``True`` for defaults) turns on the occupancy control loop that
    activates standby pools under sustained pressure and
    drains-and-retires cold ones. ``kill_pool``/``drain_pool``/
    ``pool_states`` are the operator surface.

    Output parity with the monolithic engine is the module-level
    contract — through pool deaths included; the front end's own
    metrics add the handoff plane: ``serving/handoffs``,
    ``serving/transfer_bytes``, ``serving/transfer_s``,
    ``serving/prefill_occupancy``, ``serving/decode_occupancy``, and
    the lifecycle counters ``serving/pool_deaths``/``failovers``/
    ``failover_s``/``migrated_rows``/``replayed_rows``/
    ``transfer_timeouts``/``autoscale_up``/``autoscale_down`` (see
    ``ServingMetrics``)."""

    def __init__(self, model, prefill_slots: int = 8,
                 decode_slots: int = 8, decode_pools: int = 1,
                 admission: str = "batched",
                 chunk_budget: Optional[int] = None,
                 prefix_cache=None,
                 compute_dtype=None, kv_dtype: Optional[str] = None,
                 speculative=None, seed: int = 0,
                 policy: str = "prefill_priority",
                 preemption: Optional[bool] = None,
                 deadline_feasibility: bool = False,
                 max_queue: Optional[int] = None,
                 keep_finished: Optional[int] = None,
                 watchdog=None, faults=None, clock=None,
                 metrics: Optional[ServingMetrics] = None,
                 transfer_factory=None,
                 standby_pools: int = 0,
                 health: Optional[HealthConfig] = None,
                 transfer_retry: Optional[TransferRetryConfig] = None,
                 autoscaler=None, adapters=None, tier=None,
                 autopilot=None, dispatch_ahead: int = 0,
                 device=None) -> None:
        if decode_pools < 1:
            raise ValueError(
                f"decode_pools must be >= 1, got {decode_pools}")
        if standby_pools < 0:
            raise ValueError(
                f"standby_pools must be >= 0, got {standby_pools}")
        self._clock = clock if clock is not None else default_clock
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.health_config = health if health is not None \
            else HealthConfig()
        self.transfer_retry = transfer_retry if transfer_retry is not None \
            else TransferRetryConfig()
        # ONE host KV tier (serving/kv_tier.py) shared by the prefill
        # engine and every decode worker — THE unified stash: the
        # prefill side's transfer-retry payloads, each decode pool's
        # preemption spills, and the front end's last-handoff failover
        # copies all live under the same keys and the same byte
        # budget. The plane always runs tiered; attach_metrics is
        # first-wins, so the front-end metrics object is the single
        # spill/fetch sink.
        if tier is None or tier is True:
            tier = TieredKVStore()
        self.tier = tier
        self.tier.attach_metrics(self.metrics, clock=self._clock)
        # ONE AdapterBank object shared by the prefill engine and every
        # decode worker: the gather programs agree on the bank shapes,
        # and the refcount taken at the prefill door (submit) is
        # released by whichever engine finally finishes the request —
        # one retain, one release, however many pools the row crosses
        shared = dict(compute_dtype=compute_dtype, kv_dtype=kv_dtype,
                      speculative=speculative, seed=seed, clock=clock,
                      faults=faults, keep_finished=keep_finished,
                      adapters=adapters, tier=tier, device=device)
        # the prefill pool shares the decode policy so priority
        # traffic orders ADMISSION too (no preemption there: its rows
        # drain to handoff every pump, so eviction has nothing to buy)
        self.prefill = PrefillWorker(
            model, n_slots=prefill_slots, admission=admission,
            chunk_budget=chunk_budget, prefix_cache=prefix_cache,
            deadline_feasibility=deadline_feasibility,
            max_queue=max_queue, policy=policy, preemption=False,
            watchdog=watchdog, retry=self.transfer_retry, **shared)
        make = transfer_factory if transfer_factory is not None \
            else (lambda i: InProcessTransfer())
        # cancel-sweep set + delivery-claims registry, SHARED with
        # every decode worker's ingest: ids cancelled while their
        # payload sat in a transfer channel, and which pool admitted
        # each row (cross-pool duplicate suppression for timed-out
        # resends that route to a different pool)
        self._cancelled: Set[int] = set()
        self._claims: Dict[int, DecodeWorker] = {}
        self.decoders = [
            DecodeWorker(model, n_slots=decode_slots, transfer=make(i),
                         policy=policy, preemption=preemption,
                         watchdog=watchdog, cancelled=self._cancelled,
                         claims=self._claims,
                         # the window lives in the decode loop; the
                         # prefill pool drains to handoff every pump,
                         # so dispatch-ahead has nothing to buy there
                         dispatch_ahead=dispatch_ahead, **shared)
            for i in range(decode_pools + standby_pools)]
        # pool lifecycle: the first decode_pools workers serve, the
        # rest wait on the bench (serving/health.py states)
        self._pool_state = [POOL_ACTIVE] * decode_pools \
            + [POOL_STANDBY] * standby_pools
        self._health = [PoolHealth(self._clock, self.health_config)
                        for _ in self.decoders]
        # (the last-handoff copies are tier row entries: THE loss-free
        # half of pool failover — a dead pool's row whose tier entry is
        # still current re-routes bitwise — and the cancel sweep's
        # ledger source; every engine's finish/cancel/shed disposition
        # drops its entry eagerly)
        # the front end's own stepping cadence: heartbeat SILENCE is
        # only meaningful while the plane is being driven (see step())
        self._last_step_t: Optional[float] = None
        if autoscaler:
            cfg = autoscaler if isinstance(autoscaler, AutoscalerConfig) \
                else AutoscalerConfig()
            self._scaler: Optional[OccupancyAutoscaler] = \
                OccupancyAutoscaler(cfg)
        else:
            self._scaler = None
        # the SLO autopilot runs on the PREFILL engine (it owns admission:
        # the chunk budget, degrade, the priority key; its clock is the
        # plane's), and the pool autoscaler registers on the same bus so
        # scale decisions share its log (_autoscale still executes them)
        self.autopilot = autopilot or None
        if self.autopilot is not None:
            self.autopilot.attach(self.prefill.engine)
            self.prefill.engine.autopilot = self.autopilot
            if self._scaler is not None:
                self.autopilot.register_controller("pool_scale",
                                                   self._scaler)

    # -- request surface ---------------------------------------------------

    def submit(self, *args, **kwargs) -> int:
        """Queue one request at the prefill door (the full
        :meth:`ServingEngine.submit` surface — validation, sampling
        params, priorities/deadlines, backpressure shedding)."""
        return self.prefill.submit(*args, **kwargs)

    def _engines(self):
        yield self.prefill.engine
        for w in self.decoders:
            yield w.engine

    def _lookup(self, req_id: int) -> Optional[Request]:
        for eng in self._engines():
            req = eng._finished.get(req_id)
            if req is not None:
                return req
        return None

    def result(self, req_id: int) -> Optional[np.ndarray]:
        req = self._lookup(req_id)
        return None if req is None else np.asarray(req.output, np.int32)

    def pop_result(self, req_id: int) -> Optional[np.ndarray]:
        for eng in self._engines():
            out = eng.pop_result(req_id)
            if out is not None:
                return out
        return None

    def logprobs(self, req_id: int) -> Optional[np.ndarray]:
        req = self._lookup(req_id)
        return None if req is None else np.asarray(req.logprobs,
                                                   np.float32)

    def request(self, req_id: int) -> Optional[Request]:
        return self._lookup(req_id)

    def cancel(self, req_id: int) -> bool:
        """Cancel wherever the request currently lives: the prefill
        pool (waiting / mid-prefill), its decode pool (queued-for-
        restore / decoding), or — the wire window — a transfer channel
        a dead, draining, or not-yet-stepped pool has not consumed. A
        payload in flight is SWEPT, not recalled: the id joins the
        shared cancelled set every ``DecodeWorker.ingest`` consults
        (the decode pool drops the payload instead of restoring it),
        and the cancellation is ledgered HERE from the header of the
        row's tier entry (the last-handoff failover copy) so
        the ``finish_*`` union still sums to every submitted
        request's fate. Returns False only for unknown or
        already-finished requests."""
        for eng in self._engines():
            if eng.cancel(req_id):
                # the engine's own teardown dropped the shared tier
                # entry (engine.cancel -> _drop_tier_row)
                return True
        if self._lookup(req_id) is not None:
            return False                     # already finished
        # the backoff parking lot: a failed/timed-out handoff awaiting
        # its retry window is in NO scheduler and has no stash entry —
        # cancellation must reach it here or be silently lost until
        # the resend
        req = self.prefill.cancel_deferred(req_id)
        if req is not None:
            req.resume_carry = None
            self._ledger_cancel(req)
            return True
        blob = self.tier.pop_blob(req_id)
        if blob is None:
            return False                     # unknown request
        self._cancelled.add(req_id)
        self._ledger_cancel(
            request_from_meta(payload_header(blob)["request"]))
        return True

    def _ledger_cancel(self, req: Request) -> None:
        """Front-end cancellation ledger tail (wire sweep + backoff
        sweep): the request lands CANCELLED in the prefill engine's
        ledger so result()/accounting stay closed."""
        req.state = CANCELLED
        # a backoff-parked row's payload sits in the tier (requeue put it
        # there): it must not outlive the request
        self.tier.drop_row(req.req_id)
        peng = self.prefill.engine
        # the adapter refcount taken at the prefill door follows the
        # request wherever it dies — including here, cancelled on the
        # wire before any pool owned it
        peng._release_adapter(req)
        peng._finished[req.req_id] = req
        peng._evict_finished()
        peng.metrics.on_cancel()
        peng.metrics.on_finish_reason("cancelled")

    # -- pool lifecycle (health, failover, drain, autoscaling) -------------

    def pool_states(self) -> List[str]:
        """Per-decode-pool lifecycle state (``active``/``standby``/
        ``dead``), index-aligned with ``self.decoders``."""
        return list(self._pool_state)

    def pool_health(self, i: int) -> str:
        """Decode pool ``i``'s current health classification."""
        return self._health[i].state()

    def _route_index(self) -> int:
        """The routing decision: least-loaded HEALTHY active decode
        pool; falls back to SUSPECT actives when no healthy pool
        exists (degraded service beats dropped rows). Raises when no
        active pool remains at all."""
        cands = [i for i, s in enumerate(self._pool_state)
                 if s == POOL_ACTIVE and self.decoders[i].alive]
        healthy = [i for i in cands
                   if self._health[i].state() == HEALTHY]
        pool = healthy if healthy else cands
        if not pool:
            raise RuntimeError(
                "no active decode pool to route to — every pool is "
                "dead or retired (add standby_pools, or activate one)")
        return min(pool, key=lambda i: self.decoders[i].load)

    def _check_health(self) -> None:
        """Classify every active pool; a DEAD verdict (heartbeat
        silence past ``dead_after_s``, ``dead_after_failures``
        consecutive send failures, or a forced kill) triggers
        failover before any routing this step.

        One deliberate exception: a pool whose WORKER is still alive
        (the fabric looks dead, the pool may be fine) is NOT failed
        over while it is the last serving capacity — with no survivor
        and no standby there is nowhere to move its rows, and
        declaring the whole plane down would turn a broken cable into
        a total outage. It keeps serving; the per-request transfer
        retry budget bounds the damage (requests error out, the
        engine never wedges). A worker that actually stopped
        (``kill_pool``, process exit) fails over regardless — and
        with no fallback that IS a total outage, raised loudly."""
        for i, st in enumerate(self._pool_state):
            if st != POOL_ACTIVE or self._health[i].state() != DEAD:
                continue
            fallback = any(
                s == POOL_ACTIVE and j != i and self.decoders[j].alive
                or s == POOL_STANDBY and self.decoders[j].alive
                for j, s in enumerate(self._pool_state))
            if not fallback and self.decoders[i].alive:
                continue
            self._failover_pool(i)

    def kill_pool(self, i: int, immediate: bool = True) -> None:
        """Operator/chaos hook: decode pool ``i`` crashes NOW — its
        worker stops stepping (a dead process runs no code). With
        ``immediate=True`` the death is known out-of-band (connection
        refused / process exit) and the next ``step()`` fails over at
        once; with ``immediate=False`` the front end discovers it
        through missed heartbeats on the shared clock
        (``HealthConfig.dead_after_s`` — a VirtualClock test advances
        time, never sleeps)."""
        if not 0 <= i < len(self.decoders):
            raise ValueError(f"no decode pool {i}")
        if self._pool_state[i] == POOL_DEAD:
            raise ValueError(f"decode pool {i} is already dead")
        self.decoders[i].alive = False
        if self._pool_state[i] == POOL_STANDBY:
            # a standby owns nothing: no failover to run, it just can
            # never be activated now
            self._pool_state[i] = POOL_DEAD
            self._health[i].force_dead()
            return
        if immediate:
            self._health[i].force_dead()

    def _activate_pool(self, i: int) -> None:
        """Promote a STANDBY pool to ACTIVE: just routing state and a
        fresh bill of health (its engine and weights are resident)."""
        if self._pool_state[i] != POOL_STANDBY:
            raise ValueError(
                f"decode pool {i} is {self._pool_state[i]}, not standby")
        if not self.decoders[i].alive:
            raise ValueError(f"decode pool {i} was killed on standby")
        self._pool_state[i] = POOL_ACTIVE
        self._health[i].reset()

    def _failover_pool(self, i: int) -> None:
        """Reconstruct everything DEAD decode pool ``i`` owns on the
        survivors — loss-free wherever a current state copy exists,
        byte-identical replay elsewhere. Three strata:

        1. handoffs still ON THE WIRE: channel state outlives the pool
           process (a deque here, a block store across processes), so
           the packed bytes re-route to a survivor untouched;
        2. rows in the pool's HOST-SIDE ledger (its scheduler tables —
           in the real deployment this ledger lives with the router,
           which streams every emitted token to clients anyway) whose
           last-handoff stash is still CURRENT (no tokens emitted
           since): the stash blob re-routes — restore is bitwise, no
           recompute;
        3. rows that decoded past their stash: device state died with
           the pool and is NEVER read — a meta-only REPLAY handoff
           re-prefills ``prompt + emitted`` on the survivor,
           byte-identical by the engine's recovery contract (RNG lanes are
           request-keyed, penalty counts rebuild from the emitted
           tokens).

        Survivors admit all three through their ordinary ingest path.
        If no active pool survives, a
        standby pool is activated first (no standby → raises: total
        outage is the caller's problem)."""
        w = self.decoders[i]
        t0 = self._clock()
        w.alive = False
        self._pool_state[i] = POOL_DEAD
        self._health[i].force_dead()
        self.metrics.on_pool_death()
        if not any(s == POOL_ACTIVE for s in self._pool_state):
            stand = [j for j, s in enumerate(self._pool_state)
                     if s == POOL_STANDBY and self.decoders[j].alive]
            if not stand:
                raise RuntimeError(
                    f"decode pool {i} died with no surviving active "
                    "pool and no standby to activate")
            self._activate_pool(stand[0])
        n_migrated = n_replayed = 0
        while True:                          # stratum 1: the wire
            blob = w.transfer.recv()
            if blob is None:
                break
            self._forward(blob)
            n_migrated += 1
        sched = w.engine.scheduler
        stranded = sched.pop_waiting(lambda r: True)
        for slot in list(sched.running):
            stranded.append(sched.running.pop(slot))
        for slot in list(sched.partial):
            stranded.append(sched.partial.pop(slot))
        for req in stranded:                 # strata 2 + 3
            req.slot = None
            req.resume_carry = None
            blob = self.tier.get_blob(req.req_id)
            if blob is not None and \
                    payload_header(blob)["request"]["output"] \
                    == [int(t) for t in req.output]:
                n_migrated += 1
            else:
                blob = pack_payload(request_meta(req), None)
                self.tier.put_packed(blob, req_id=req.req_id)
                n_replayed += 1
            self._forward(blob)
        self.metrics.on_failover(n_migrated, n_replayed,
                                 self._clock() - t0)

    def drain_pool(self, i: int) -> int:
        """GRACEFULLY retire ACTIVE decode pool ``i``: stop routing to
        it, migrate every row it owns to the surviving pools through
        the ordinary ``row_state`` wire handoff (LOSS-FREE — the pool
        is alive, so mid-stream rows serialize their live carry and
        resume byte-identically on the receiver), and leave it
        STANDBY: weights resident, ready for a later reactivation.
        Returns the migrated row count."""
        if not 0 <= i < len(self.decoders):
            raise ValueError(f"no decode pool {i}")
        if self._pool_state[i] != POOL_ACTIVE:
            raise ValueError(
                f"decode pool {i} is {self._pool_state[i]}, not active")
        if sum(1 for s in self._pool_state if s == POOL_ACTIVE) < 2:
            raise ValueError(
                "cannot drain the last active decode pool — activate "
                "another first")
        w = self.decoders[i]
        self._pool_state[i] = POOL_STANDBY   # routing excludes it now
        n = 0
        while True:                          # unconsumed wire payloads
            blob = w.transfer.recv()
            if blob is None:
                break
            self._forward(blob)
            n += 1
        sched = w.engine.scheduler
        for req in sched.pop_waiting(lambda r: True):
            # queued-for-restore rows: their payload already sits in
            # the shared tier as packed bytes (ingest/requeue put it
            # there) and re-routes as-is when still current; otherwise
            # — a legacy in-memory carry, or no copy at all (replay-
            # queued, or budget-evicted) — re-pack from the request
            blob = self.tier.get_blob(req.req_id)
            if blob is None or \
                    payload_header(blob)["request"]["output"] \
                    != [int(t) for t in req.output]:
                payload, req.resume_carry = req.resume_carry, None
                blob = pack_payload(request_meta(req), payload)
                self.tier.put_packed(blob, req_id=req.req_id)
            self._forward(blob)
            n += 1
        seated = [(s, sched.running.pop(s)) for s in list(sched.running)]
        seated += [(s, sched.partial.pop(s)) for s in list(sched.partial)]
        for slot, req in seated:
            # slot-holding rows serialize their LIVE carry — the
            # clean path failover cannot take (it never trusts a
            # dead device)
            payload = w.engine.pool.row_state(slot)
            req.slot = None
            w.engine.pool.free(slot)
            w.engine._configured.discard(slot)
            w.engine._restored.discard(slot)
            w.engine._constraints.pop(slot, None)
            blob = pack_payload(request_meta(req), payload)
            self.tier.put_packed(blob, req_id=req.req_id)
            self._forward(blob)
            n += 1
        self.metrics.on_migrated(n)
        return n

    def _forward(self, blob: bytes) -> None:
        """Route one already-packed handoff to the best surviving
        pool. Failover/drain internals: the send is direct — the
        target was just chosen as a live survivor, and recovery paths
        do not re-enter the fault injector."""
        self.decoders[self._route_index()].transfer.send(blob)

    def _autoscale(self) -> None:
        active = [i for i, s in enumerate(self._pool_state)
                  if s == POOL_ACTIVE]
        standby = [i for i, s in enumerate(self._pool_state)
                   if s == POOL_STANDBY and self.decoders[i].alive]
        occ = sum(self.decoders[i].occupancy for i in active) \
            / max(len(active), 1)
        decision = self._scaler.observe(
            occ, self.prefill.engine.scheduler.queue_depth,
            can_up=bool(standby),
            can_down=len(active) > self._scaler.config.min_pools)
        if decision == "up":
            self._activate_pool(standby[0])
            self.metrics.on_autoscale("up")
        elif decision == "down":
            victim = min(active, key=lambda i: self.decoders[i].load)
            self.drain_pool(victim)
            self.metrics.on_autoscale("down")
        if decision and self.autopilot is not None:
            # pool actuations land in the bus's one log
            self.autopilot.bus.note_pool_scale(decision)

    # -- the serving loop --------------------------------------------------

    def _handoff(self, req: Request, payload: Dict) -> None:
        i = self._route_index()
        worker = self.decoders[i]
        blob = self.prefill.send_handoff(worker.transfer, req, payload,
                                         self.metrics,
                                         health=self._health[i])
        if blob is not None:
            # the packed bytes double as the failover copy: one tier
            # entry per in-flight row under the shared host budget
            self.tier.put_packed(blob, req_id=req.req_id)

    def step(self) -> Dict[int, int]:
        """One front-end super-step: health sweep (failing over any
        pool classified DEAD), pump the prefill pool, route every
        finished row to the least-loaded healthy decode worker, one
        decode super-step per active pool (each completed step stamps
        the pool's heartbeat), then the autoscaler sample. Returns the
        merged ``{req_id: last emitted 1-based token}`` across
        pools."""
        now = self._clock()
        if self._last_step_t is None or \
                now - self._last_step_t \
                > self.health_config.suspect_after_s:
            # a gap in the CALLER's stepping cadence is not pool
            # silence: during a traffic lull nobody was expected to
            # beat, and classifying the whole fleet dead on the next
            # step would turn every idle minute into a pool massacre.
            # Restart every live pool's beat clock; a genuinely hung
            # worker (alive but not beating) re-accumulates silence
            # over the next dead_after_s of ACTIVE stepping.
            for i, st in enumerate(self._pool_state):
                if st == POOL_ACTIVE and self.decoders[i].alive:
                    self._health[i].beat()
        self._last_step_t = now
        self._check_health()
        for req, payload in self.prefill.pump():
            self._handoff(req, payload)
        out: Dict[int, int] = {}
        for i, worker in enumerate(self.decoders):
            if self._pool_state[i] != POOL_ACTIVE or not worker.alive:
                continue
            out.update(worker.step())
            self._health[i].beat()
        # (no stash hygiene sweep anymore: a finished request's
        # handoff copy is dropped AT the finish disposition by the
        # owning engine — ServingEngine._drop_tier_row — so the tier
        # never carries dead rows between steps)
        if self._scaler is not None:
            self._autoscale()
        self.metrics.on_pool_occupancy(
            self.prefill.occupancy,
            [w.occupancy for i, w in enumerate(self.decoders)
             if self._pool_state[i] == POOL_ACTIVE])
        return out

    def idle(self) -> bool:
        return self.prefill.idle() and all(w.idle()
                                           for w in self.decoders)

    def drain(self) -> Dict[int, np.ndarray]:
        """Step until every submitted request has finished; returns
        ``{req_id: generated ids}`` for all retained FINISHED requests
        across pools (the monolithic ``drain`` contract)."""
        while not self.idle():
            self.step()
        out: Dict[int, np.ndarray] = {}
        for eng in self._engines():
            # idle() watches schedulers, not windows: a worker whose
            # rows all finished can still hold in-flight dispatches —
            # flush them (split-sample pairing intact) so no device
            # handle outlives the drain
            eng.flush_window()
        for eng in self._engines():
            for rid, req in eng._finished.items():
                if req.state == FINISHED:
                    out[rid] = np.asarray(req.output, np.int32)
        return out

    @property
    def queue_depth(self) -> int:
        return sum(eng.scheduler.queue_depth for eng in self._engines())

    @property
    def active(self) -> int:
        return sum(eng.scheduler.active for eng in self._engines())

    # -- introspection -----------------------------------------------------

    def pool_summaries(self) -> Dict[str, Dict[str, float]]:
        """Per-pool metric summaries (``prefill``, ``decode_<i>``) —
        the disaggregated twin of ``engine.metrics.summary()``."""
        out = {"prefill": self.prefill.engine.metrics.summary()}
        for i, w in enumerate(self.decoders):
            out[f"decode_{i}"] = w.engine.metrics.summary()
        return out

    def summary(self) -> Dict[str, float]:
        """One flat dict: the front end's handoff-plane counters plus
        the pool-summed dispositions (finish_<reason> counters keep
        summing to the submitted total across the split), aggregate
        token counts, and the worst decode pool's decode-gap p99."""
        out = dict(self.metrics.summary())
        sums: Dict[str, float] = {}
        gap_p99 = 0.0
        for name, s in self.pool_summaries().items():
            for k, v in s.items():
                if k.startswith("serving/finish_") or k in (
                        "serving/shed", "serving/preempted",
                        "serving/retries", "serving/recovered_rows",
                        "serving/deadline_missed", "serving/degraded",
                        "serving/infeasible", "serving/finished_in_slo"):
                    sums[k] = sums.get(k, 0.0) + v
            if name != "prefill":
                gap_p99 = max(gap_p99,
                              s.get("serving/decode_gap_p99_s", 0.0))
        out.update(sums)
        pm = self.prefill.engine.metrics.metrics
        n_sub, _ = pm.get("serving/submitted")
        if n_sub:
            out["serving/submitted"] = n_sub
            out["serving/goodput"] = \
                sums.get("serving/finished_in_slo", 0.0) / n_sub
        n_fin = n_tok = 0.0
        for eng in self._engines():
            f, _ = eng.metrics.metrics.get("serving/finished")
            t, _ = eng.metrics.metrics.get("serving/tokens_out")
            n_fin += f
            n_tok += t
        out["serving/finished"] = n_fin
        out["serving/tokens_out"] = n_tok
        if gap_p99:
            out["serving/decode_gap_p99_s"] = gap_p99
        return out
