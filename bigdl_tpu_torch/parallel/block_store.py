"""Host-side block stores and their array codec
(``bigdl_tpu/parallel/block_store.py:72-208``).

A block store is an immutable-once-put byte store keyed by strings — the
BlockManager analog the serving plane's KV-row handoff
(``serving/disagg.py``) and host KV tier (``serving/kv_tier.py``) ride:

* :class:`MemBlockStore` — an in-process dict behind one lock;
* :class:`FsBlockStore` — a shared directory, atomic by write-temp and
  ``os.rename``, so separate processes on one host exchange blocks.

:func:`encode_array` / :func:`decode_array` are the reference's codec,
byte for byte: ``b"BDBS"``, the dtype code's length and text, the rank,
one little-endian int64 per dimension, then the raw C-order bytes. The
codec takes a numpy array or a CPU torch tensor. numpy has no bfloat16,
so a bf16 tensor is written under the dtype NAME ``"bfloat16"`` with its
raw 2-byte words, exactly as the JAX package writes an ``ml_dtypes``
bfloat16 array; :func:`decode_array` returns a CPU torch tensor and
rebuilds bf16 as a ``view(torch.bfloat16)`` of the int16 words. A blob
therefore decodes to the same bits in either package, both ways.

* :class:`CoordServiceBlockStore` — the JAX package's coordination-service
  store, here the ``torch.distributed`` group's own key-value store (the
  c10d store the rendezvous made), so the ranks of a process group share
  blocks with no other service. :func:`default_block_store` returns it
  when a process group is up, else an :class:`FsBlockStore` under
  ``BIGDL_BLOCKSTORE_DIR`` (default ``./.bigdl_blockstore``).

On top of the stores sits the reference's gradient exchange partitioned
by process (``bigdl_tpu/parallel/block_store.py:344-787``), which
``DistriOptimizer(parameter_mode="blockstore")`` drives:
:class:`BlockStoreParameter` (``put_gradients`` with optional async puts,
``aggregate_my_partition`` with the straggler drop, ``publish_weights`` /
``get_weights``, ``publish_aux`` / ``gather_aux``, ``sweep_stale``) and the
drop's thresholds, :class:`GradientDropPolicy`. They are host numpy code
over a store, keyed as the JAX package keys them; ``compress="bf16"``
casts the remote gradient slices through ``torch.bfloat16`` (numpy has
no bfloat16), which rounds to nearest even as ``ml_dtypes`` does.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger("bigdl_tpu_torch")

_MAGIC = b"BDBS"


def _host_bytes(arr):
    """(dtype code, shape, raw C-order bytes) of a numpy array or a CPU
    tensor; bf16 by name, its words as int16."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != "cpu":
            raise ValueError(
                "encode_array takes host data: read device tensors back "
                "through a fence first (serving/fences.py)")
        t = arr.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", tuple(t.shape), \
                t.view(torch.int16).numpy().tobytes()
        arr = t.numpy()
    arr = np.asarray(arr)
    shape = arr.shape      # before ascontiguousarray: it promotes 0-d to 1-d
    arr = np.ascontiguousarray(arr)
    code = arr.dtype.str
    if code.lstrip("<>|=").startswith("V"):
        code = arr.dtype.name   # an extension dtype, e.g. "bfloat16"
    return code, shape, arr.tobytes()


def encode_array(arr) -> bytes:
    """Self-describing little header + raw bytes (module docstring)."""
    code, shape, raw = _host_bytes(arr)
    dt = code.encode()
    head = _MAGIC + struct.pack("<B", len(dt)) + dt
    head += struct.pack("<B", len(shape)) + b"".join(
        struct.pack("<q", s) for s in shape)
    return head + raw


def decode_array(blob) -> torch.Tensor:
    """Inverse of :func:`encode_array` (``blob`` bytes or a memoryview of
    them): a CPU tensor owning its bytes."""
    if bytes(blob[:4]) != _MAGIC:
        raise ValueError("not a block-store array blob")
    off = 4
    (ndt,) = struct.unpack_from("<B", blob, off)
    off += 1
    code = bytes(blob[off:off + ndt]).decode()
    off += ndt
    (nsh,) = struct.unpack_from("<B", blob, off)
    off += 1
    shape = struct.unpack_from(f"<{nsh}q", blob, off) if nsh else ()
    off += 8 * nsh
    if code == "bfloat16":
        words = np.frombuffer(blob, dtype="<i2", offset=off).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(shape)
    try:
        dt = np.dtype(code)
    except TypeError:
        raise ValueError(
            f"unsupported array dtype {code!r} in a block-store blob") \
            from None
    arr = np.frombuffer(blob, dtype=dt, offset=off).reshape(shape).copy()
    return torch.from_numpy(arr)


class BlockStore:
    """Abstract immutable-once-put block store (the BlockManager analog)."""

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def try_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def contains(self, key: str) -> bool:
        """Existence probe without fetching the value where the backend
        can (the fallback fetches and discards): polling loops such as a
        handoff channel's ``pending()`` call it per tick."""
        return self.try_get(key) is not None

    def get_blocking(self, key: str, timeout_s: float,
                     poll_s: float = 0.002) -> bytes:
        deadline = time.monotonic() + timeout_s
        while True:
            v = self.try_get(key)
            if v is not None:
                return v
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"block {key!r} not published within {timeout_s}s — a "
                    "peer process likely died")
            time.sleep(poll_s)


class MemBlockStore(BlockStore):
    """In-process dict backend, thread-safe (one lock); not visible
    across processes — use :class:`FsBlockStore` for that."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._blocks: Dict[str, bytes] = {}

    def put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._blocks[key] = bytes(value)

    def try_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            return self._blocks.get(key)

    def delete(self, key: str) -> None:
        with self._lock:
            self._blocks.pop(key, None)

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._blocks


class FsBlockStore(BlockStore):
    """Shared-directory backend; atomic via write-temp + os.rename."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(value)
        os.rename(tmp, path)

    def try_get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def contains(self, key: str) -> bool:
        return os.path.exists(self._path(key))


class CoordServiceBlockStore(BlockStore):
    """A store over the ``torch.distributed`` group's key-value store (the
    JAX package's coordination-service store; its keys are prefixed with
    ``prefix``). ``store=`` takes any c10d store instead of the default
    group's."""

    def __init__(self, prefix: str = "bigdl_bs", store=None) -> None:
        import torch.distributed as dist

        if store is None:
            if not (dist.is_available() and dist.is_initialized()):
                raise RuntimeError(
                    "CoordServiceBlockStore needs a torch.distributed "
                    "process group (Engine.init_distributed) to run first")
            store = dist.distributed_c10d._get_default_store()
        self._store = dist.PrefixStore(f"{prefix}/", store)

    def put(self, key: str, value: bytes) -> None:
        self._store.set(key, bytes(value))

    def try_get(self, key: str) -> Optional[bytes]:
        if not self._store.check([key]):
            return None
        return bytes(self._store.get(key))

    def delete(self, key: str) -> None:
        self._store.delete_key(key)

    def contains(self, key: str) -> bool:
        return self._store.check([key])


def default_block_store() -> BlockStore:
    """The process group's store when a group is up, else a local
    :class:`FsBlockStore` under ``BIGDL_BLOCKSTORE_DIR``."""
    try:
        return CoordServiceBlockStore()
    except RuntimeError:
        root = os.environ.get(
            "BIGDL_BLOCKSTORE_DIR",
            os.path.join(os.path.abspath("."), ".bigdl_blockstore"))
        return FsBlockStore(root)


class GradientDropPolicy:
    """The reference's straggler thresholds (``setDropModuleProperty``):
    no drops during the first ``warmup_iteration`` iterations; then the
    deadline is the ``1 - drop_percentage`` quantile of the last
    ``compute_threshold_batch_size`` per-contribution arrival durations
    (floored at ``min_deadline_s``), so a minority straggler is dropped
    while the quantile stays in the fast cluster, and a recovered one
    re-enters once its late arrivals pull the quantile back.
    ``max_drop_percentage`` caps what one aggregation may discard."""

    def __init__(self, drop_percentage: float,
                 max_drop_percentage: Optional[float] = None,
                 compute_threshold_batch_size: int = 100,
                 warmup_iteration: int = 20,
                 min_deadline_s: float = 0.05) -> None:
        if not 0.0 <= drop_percentage < 1.0:
            raise ValueError("drop_percentage must be in [0, 1)")
        self.min_deadline_s = float(min_deadline_s)
        self.drop_percentage = float(drop_percentage)
        self.max_drop_percentage = (
            drop_percentage if max_drop_percentage is None
            else float(max_drop_percentage))
        if self.max_drop_percentage < self.drop_percentage:
            raise ValueError(
                "max_drop_percentage must be >= drop_percentage")
        self.warmup_iteration = int(warmup_iteration)
        self._samples: deque = deque(maxlen=int(compute_threshold_batch_size))

    def record(self, duration_s: float) -> None:
        self._samples.append(float(duration_s))

    def deadline(self, iteration: int) -> Optional[float]:
        """Seconds an aggregation may wait before dropping; None while no
        drop is allowed (warm-up, or no sample yet)."""
        if iteration < self.warmup_iteration or not self._samples:
            return None
        q = 1.0 - self.drop_percentage
        quant = float(np.quantile(np.asarray(self._samples), min(q, 1.0)))
        return max(quant, self.min_deadline_s)

    def min_arrivals(self, n_contributors: int) -> int:
        """Contributions an owner needs before the deadline may fire (its
        own counts): ceil((1 - max_drop) * n)."""
        need = int(np.ceil((1.0 - self.max_drop_percentage) * n_contributors))
        return max(1, need)


class BlockStoreParameter:
    """The AllReduceParameter dataflow over a block store, partitioned by
    process: numpy and a store, with the process identity explicit, so
    threads sharing one :class:`FsBlockStore` can drive it as processes
    would. Per iteration ``t``::

        put_gradients(t, flat_grad)          # publish the remote slices
        g, n, dropped = aggregate_my_partition(t)
        ... the owner's update of its weight slice ...
        publish_weights(t + 1, new_wshard)
        flat_w = get_weights(t + 1)          # the full vector

    Gradient blobs carry an 8-byte wall-clock send time; an owner records
    for each contribution the larger of its wait since aggregation began
    and the publish-to-arrival time less that peer's baseline (the least
    of its recent such times, which cancels a constant clock offset).
    ``async_puts`` sends the remote slices from a thread, at most one
    transfer outstanding, so a slow transfer does not hold this process's
    own weight publish (the drop's win needs it)."""

    def __init__(self, store: BlockStore, n_procs: int, pid: int,
                 total_size: int, compress: Optional[str] = None,
                 drop_policy: Optional[GradientDropPolicy] = None,
                 namespace: str = "arp",
                 timeout_s: Optional[float] = None,
                 async_puts: bool = False) -> None:
        self.store = store
        self.n = int(n_procs)
        self.pid = int(pid)
        if not 0 <= self.pid < self.n:
            raise ValueError(f"pid {pid} outside 0..{n_procs - 1}")
        self.total_size = int(total_size)
        self.padded_size = ((self.total_size + self.n - 1) // self.n) * self.n
        self.shard_size = self.padded_size // self.n
        if compress not in (None, "bf16", "fp16"):
            raise ValueError(f"unknown compress {compress!r}")
        self.compress = compress
        self.drop = drop_policy
        self.ns = namespace
        self.timeout_s = timeout_s if timeout_s is not None else float(
            os.environ.get("BIGDL_BLOCKSTORE_TIMEOUT_S", "300"))
        self.dropped_total = 0
        self.dropped_by_src: Dict[int, int] = {}
        self.drop_log: List[Tuple[int, Tuple[int, ...]]] = []
        self._my_slice_cache: Optional[np.ndarray] = None
        # (iteration, src) -> the dropping aggregation's start time, probed
        # by later aggregations so a late arrival enters the calibration
        self._late_probes: Dict[Tuple[int, int], float] = {}
        self._peer_transfer_raw: Dict[int, deque] = {}
        self.async_puts = bool(async_puts)
        self._put_thread: Optional[threading.Thread] = None
        self._put_error: Optional[BaseException] = None

    # -- keys (the reference's deterministic BlockId) ----------------------

    def _gkey(self, t: int, part: int, src: int) -> str:
        return f"{self.ns}/g/{t}/{part}/{src}"

    def _wkey(self, t: int, part: int) -> str:
        return f"{self.ns}/w/{t}/{part}"

    def _skey(self, t: int, name: str, src: int) -> str:
        return f"{self.ns}/s/{t}/{name}/{src}"

    # -- slices ------------------------------------------------------------

    def _pad(self, flat: np.ndarray) -> np.ndarray:
        flat = np.asarray(flat, dtype=np.float32).ravel()
        if flat.size != self.total_size:
            raise ValueError(
                f"flat vector has {flat.size} elements, expected "
                f"{self.total_size}")
        if self.padded_size != flat.size:
            flat = np.concatenate(
                [flat, np.zeros(self.padded_size - flat.size, np.float32)])
        return flat

    def _slice(self, flat_padded: np.ndarray, part: int) -> np.ndarray:
        return flat_padded[part * self.shard_size:(part + 1) * self.shard_size]

    def _encode(self, arr: np.ndarray) -> bytes:
        if self.compress == "bf16":
            return encode_array(torch.from_numpy(
                np.ascontiguousarray(arr)).to(torch.bfloat16))
        if self.compress == "fp16":
            arr = arr.astype(np.float16)
        return encode_array(arr)

    @staticmethod
    def _decode(blob) -> np.ndarray:
        return decode_array(blob).float().numpy()

    def _encode_g(self, arr: np.ndarray) -> bytes:
        return struct.pack(">d", time.time()) + self._encode(arr)

    @staticmethod
    def _decode_g(blob: bytes) -> Tuple[float, np.ndarray]:
        (send_ts,) = struct.unpack(">d", blob[:8])
        return send_ts, BlockStoreParameter._decode(memoryview(blob)[8:])

    def _transfer_sample(self, src: int, send_ts: float) -> float:
        """The publish-to-arrival time of a block from ``src`` less that
        peer's baseline (the least of its previous such times; the first
        has none and counts raw)."""
        raw = time.time() - send_ts
        window = self._peer_transfer_raw.setdefault(src, deque(maxlen=32))
        baseline = min(window) if window else 0.0
        window.append(raw)
        return max(0.0, raw - baseline)

    # -- the four reference verbs ------------------------------------------

    def put_gradients(self, t: int, flat_grad: np.ndarray) -> None:
        """Reference ``putGradients``: publish this process's slice of
        every remote partition (its own stays in memory), and record its
        position for :meth:`sweep_stale`."""
        flat = self._pad(flat_grad)
        self._my_slice_cache = self._slice(flat, self.pid).copy()
        self.store.delete(f"{self.ns}/pos/{self.pid}")
        self.store.put(f"{self.ns}/pos/{self.pid}",
                       encode_array(np.int64(t)))
        blobs = [(self._gkey(t, part, self.pid),
                  self._encode_g(self._slice(flat, part)))
                 for part in range(self.n) if part != self.pid]

        def send():
            try:
                for key, blob in blobs:
                    self.store.put(key, blob)
            except BaseException as e:  # surfaced on the next join
                self._put_error = e

        if self.async_puts:
            self._join_puts()
            self._put_thread = threading.Thread(target=send, daemon=True)
            self._put_thread.start()
        else:
            send()
            if self._put_error is not None:
                e, self._put_error = self._put_error, None
                raise e

    def _join_puts(self) -> None:
        """Wait for the outstanding async transfer and raise what it hit."""
        if self._put_thread is not None:
            self._put_thread.join()
            self._put_thread = None
        if self._put_error is not None:
            e, self._put_error = self._put_error, None
            if isinstance(e, Exception):
                raise e
            raise RuntimeError(
                f"async gradient put thread died with {e!r}") from e

    def sweep_stale(self, aux_names: Sequence[str] = ()) -> None:
        """Delete the blocks this process may have left in the store on an
        earlier attempt (bounded by its recorded position), so a restarted
        iteration counter cannot alias them."""
        self._join_puts()
        blob = self.store.try_get(f"{self.ns}/pos/{self.pid}")
        if blob is None:
            return
        last_t = int(decode_array(blob))
        for t in range(max(0, last_t - 2), last_t + 2):
            for part in range(self.n):
                if part != self.pid:
                    self.store.delete(self._gkey(t, part, self.pid))
            self.store.delete(self._wkey(t, self.pid))
            for name in aux_names:
                self.store.delete(self._skey(t, name, self.pid))
        self.store.delete(f"{self.ns}/pos/{self.pid}")

    def aggregate_my_partition(
            self, t: int) -> Tuple[np.ndarray, int, List[int]]:
        """Reference ``aggregateGradientPartition`` with the drop: poll
        the remote contributions to this process's partition; past the
        warm-up, stop at the calibrated deadline once enough arrived.
        Returns (mean over the arrived contributions, arrived count,
        dropped sources)."""
        if self._my_slice_cache is None:
            raise RuntimeError("put_gradients must run first each iteration")
        self._probe_late_arrivals(t)
        # contributions published after iteration t-2's clean-up are dead
        for src in range(self.n):
            if src != self.pid:
                self.store.delete(self._gkey(t - 2, self.pid, src))
        acc = self._my_slice_cache.astype(np.float64)
        self._my_slice_cache = None
        pending = [s for s in range(self.n) if s != self.pid]
        arrived = 1
        t0 = time.monotonic()
        deadline = self.drop.deadline(t) if self.drop is not None else None
        min_needed = (self.drop.min_arrivals(self.n)
                      if self.drop is not None else self.n)
        hard_deadline = t0 + self.timeout_s
        while pending:
            for src in list(pending):
                blob = self.store.try_get(self._gkey(t, self.pid, src))
                if blob is not None:
                    send_ts, contrib = self._decode_g(blob)
                    acc += contrib
                    arrived += 1
                    pending.remove(src)
                    if self.drop is not None:
                        self.drop.record(max(
                            0.0, time.monotonic() - t0,
                            self._transfer_sample(src, send_ts)))
            if not pending:
                break
            now = time.monotonic()
            if (deadline is not None and now - t0 >= deadline
                    and arrived >= min_needed):
                break           # drop the late ones (reference semantics)
            if now > hard_deadline:
                raise TimeoutError(
                    f"partition {self.pid}: only {arrived}/{self.n} gradient "
                    f"contributions after {self.timeout_s}s at iteration {t} "
                    "— a peer process likely died")
            time.sleep(0.002)
        if pending:
            self.dropped_total += len(pending)
            self.drop_log.append((t, tuple(pending)))
            for src in pending:
                self.dropped_by_src[src] = self.dropped_by_src.get(src, 0) + 1
                self._late_probes[(t, src)] = t0
            logger.warning(
                "iteration %d partition %d: dropped %d straggler gradient "
                "contribution(s) from %s (%d/%d arrived)",
                t, self.pid, len(pending), pending, arrived, self.n)
        # a dropped source's block is left for the late-arrival probe
        for src in range(self.n):
            if src != self.pid and (t, src) not in self._late_probes:
                self.store.delete(self._gkey(t, self.pid, src))
        return (acc / arrived).astype(np.float32), arrived, pending

    def _probe_late_arrivals(self, t: int) -> None:
        """Record the (upper-bound) arrival time of contributions earlier
        aggregations dropped that have landed since, so the deadline can
        rise when a straggler recovers; forget probes older than t-2."""
        if self.drop is None or not self._late_probes:
            return
        for (tp, src), t0 in list(self._late_probes.items()):
            blob = self.store.try_get(self._gkey(tp, self.pid, src))
            if blob is not None:
                (send_ts,) = struct.unpack(">d", blob[:8])
                self.drop.record(max(0.0, time.monotonic() - t0,
                                     self._transfer_sample(src, send_ts)))
                del self._late_probes[(tp, src)]
                self.store.delete(self._gkey(tp, self.pid, src))
            elif tp <= t - 2:
                del self._late_probes[(tp, src)]

    def publish_weights(self, t: int, wshard: np.ndarray) -> None:
        """Reference ``sendWeightPartition``; also deletes this owner's
        weight block of two iterations ago."""
        wshard = np.asarray(wshard, np.float32).ravel()
        if wshard.size != self.shard_size:
            raise ValueError(
                f"weight shard has {wshard.size} elements, expected "
                f"{self.shard_size}")
        self.store.put(self._wkey(t, self.pid), encode_array(wshard))
        self.store.delete(self._wkey(t - 2, self.pid))

    def get_weights(self, t: int) -> np.ndarray:
        """Reference ``getWeights``: every owner's weight partition
        (blocking: weights are never dropped), the full unpadded f32
        vector."""
        out = np.empty(self.padded_size, np.float32)
        for part in range(self.n):
            blob = self.store.get_blocking(self._wkey(t, part), self.timeout_s)
            out[part * self.shard_size:(part + 1) * self.shard_size] = \
                decode_array(blob).numpy()
        return out[:self.total_size]

    # -- the small side channel (loss, BN state, gradient norms) -----------

    def publish_aux(self, t: int, name: str, value) -> None:
        self.store.put(self._skey(t, name, self.pid),
                       encode_array(np.asarray(value)))
        self.store.delete(self._skey(t - 2, name, self.pid))

    def gather_aux(self, t: int, name: str,
                   blocking: bool = True) -> Dict[int, np.ndarray]:
        """Every process's ``name`` value at iteration ``t``; blocking
        waits for all of them."""
        out: Dict[int, np.ndarray] = {}
        for src in range(self.n):
            key = self._skey(t, name, src)
            if blocking:
                out[src] = decode_array(
                    self.store.get_blocking(key, self.timeout_s)).numpy()
            else:
                blob = self.store.try_get(key)
                if blob is not None:
                    out[src] = decode_array(blob).numpy()
        return out
