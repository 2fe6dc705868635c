"""The declared device→host synchronization points of the serving plane
(``bigdl_tpu/serving/fences.py``).

PyTorch queues CUDA work asynchronously until something reads a device
value back (``.cpu()``, ``.item()``, ``.tolist()``, a Python branch on a
tensor); then the host waits for everything queued. The engine's hot path
syncs only through the idioms here, over a closed site vocabulary
(:data:`FENCE_SITES`; an unknown site raises):

* :func:`start_readback` / :meth:`Readback.wait` — the READBACK fence,
  split in two: at dispatch, ONE non-blocking copy of several small
  tensors (the per-step token ids and chosen log-probs, flattened to bytes
  and concatenated) into a pinned host buffer of the readback's own,
  followed by a CUDA event; later, a wait on that event only. A delayed
  consumer (the engine's dispatch-ahead window) therefore waits for its
  own step and not for the newer steps queued behind it, as a late
  ``.cpu()`` would;
* :func:`fence` — both halves at once: one device→host copy, waited on
  now;
* :func:`fence_wait` — the COMPLETION fence: a CUDA event recorded on the
  current stream and synchronized, no copy. A timer brackets device work
  with it so the elapsed time measures the work, not the launch.

On CPU tensors the copy is plain and there is nothing to wait for.
Values come back as numpy arrays, except those of a dtype numpy lacks
(bfloat16), which come back as CPU tensors holding the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

#: The closed fence-site vocabulary; an unknown site raises.
FENCE_SITES = frozenset({
    "decode",   # the per-step token/logprob readback — consumed by the
                # engine's delayed consumer (the dispatch-ahead window)
    "verify",   # the speculative super-step's verify readback
    "draft",    # completion of the chained draft dispatches (timing)
    "transfer",  # KV-row handoff serialization (disagg.pack_payload): one
                 # batched readback of every payload leaf
})


def _check_site(site: str) -> None:
    if site not in FENCE_SITES:
        raise ValueError(
            f"unknown fence site {site!r} — add it to "
            f"fences.FENCE_SITES first; known: {sorted(FENCE_SITES)}")


class Readback:
    """One started readback (:func:`start_readback`): a pinned host buffer
    the copy lands in, the event recorded after it, and the values'
    dtypes and shapes to split the bytes again."""

    __slots__ = ("_host", "_event", "_meta")

    def __init__(self, values) -> None:
        flat = [v.detach().contiguous().reshape(-1).view(torch.uint8)
                for v in values]
        self._meta = [(v.dtype, tuple(v.shape), f.numel())
                      for v, f in zip(values, flat)]
        buf = torch.cat(flat)
        if buf.device.type == "cuda":
            # a buffer per readback: a ring shared by the in-flight steps
            # would be overwritten before its consumer read it
            self._host = torch.empty(buf.shape, dtype=torch.uint8,
                                     pin_memory=True)
            self._host.copy_(buf, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(buf.device))
        else:
            self._host = buf
            self._event = None

    def wait(self):
        """Wait for this readback's copy alone and return the values as
        host numpy arrays, bf16 ones as CPU tensors (a single value bare,
        several as a tuple)."""
        if self._event is not None:
            self._event.synchronize()
        host = self._host.numpy()
        out, at = [], 0
        for dtype, shape, n in self._meta:
            words = host[at:at + n]
            if dtype == torch.bfloat16:
                out.append(torch.from_numpy(np.array(
                    words.view(np.int16))).view(dtype).reshape(shape))
            else:
                dt = torch.empty((), dtype=dtype).numpy().dtype
                out.append(np.array(words.view(dt).reshape(shape)))
            at += n
        return out[0] if len(out) == 1 else tuple(out)


def start_readback(site: str, *values) -> Readback:
    """Enqueue ONE device→host copy of ``values`` behind the work that
    produces them, without waiting for it."""
    _check_site(site)
    return Readback(values)


def fence(site: str, *values):
    """Read ``values`` back to the host in ONE device→host copy, waited on
    now (numpy arrays; bf16 values as CPU tensors). A single value comes
    back bare, several as a tuple."""
    return start_readback(site, *values).wait()


def fence_wait(site: str, tree):
    """Wait until the work queued on the current stream so far (what
    produces ``tree``'s tensors) has finished; ``tree`` is returned
    unchanged, still on its device."""
    _check_site(site)
    tensors = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (list, tuple)) else (tree,))
    dev = next((t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"),
               None)
    if dev is not None:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        event.synchronize()
    return tree
