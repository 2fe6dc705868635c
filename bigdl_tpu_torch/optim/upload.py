"""Host batches to the card without stalling the host
(``bigdl_tpu/optim/optimizer.py:866-898``: the JAX loop places the next
batch while the dispatched step runs).

A copy from pageable host memory is synchronous, so ``.to(device,
non_blocking=True)`` on a numpy-backed tensor waits for the work already
queued. :class:`PinnedUploader` copies each host array into a pinned
staging buffer and uploads it on a side CUDA stream; the compute stream
waits on the copy's event, so the step reads the batch only after it has
landed, and a staging buffer is written again only after its last copy
has completed. On the CPU an array becomes a tensor by
``torch.from_numpy``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

#: staging slots: one being filled while the step reads the previous one
SLOTS = 2


def _tree_map(fn, x):
    if isinstance(x, (list, tuple)):
        return [_tree_map(fn, v) for v in x]
    return fn(x)


def _host_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class PinnedUploader:
    """``uploader(x, y, ...)`` → each argument (an array, a tensor or a
    list of them) as tensors on ``device``, in the same structure. A
    tensor already on ``device`` passes through. On a CUDA device there
    is no fallback: a failing pinned allocation or copy raises."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._stream: Optional[torch.cuda.Stream] = None
        self._stage: List[List[torch.Tensor]] = [[] for _ in range(SLOTS)]
        self._copied: List[Optional[torch.cuda.Event]] = [None] * SLOTS
        self._slot = 0

    def __call__(self, *args):
        if self.device.type != "cuda":
            return tuple(_tree_map(_host_tensor, a) for a in args)
        slot = self._slot
        self._slot = (slot + 1) % SLOTS
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last copy has landed
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        stage = self._stage[slot]
        used = 0

        def upload(a):
            nonlocal used
            if isinstance(a, torch.Tensor) and a.device == self.device:
                return a
            host = _host_tensor(a)
            n = host.numel() * host.element_size()
            if used == len(stage):
                stage.append(torch.empty(n, dtype=torch.uint8,
                                         pin_memory=True))
            elif stage[used].numel() < n:
                stage[used] = torch.empty(n, dtype=torch.uint8,
                                          pin_memory=True)
            pinned = stage[used][:n].view(host.dtype).view(host.shape)
            used += 1
            pinned.copy_(host)
            with torch.cuda.stream(self._stream):
                dev = pinned.to(self.device, non_blocking=True)
            # the allocator keeps dev's memory until the compute stream's
            # work queued before its release has run
            dev.record_stream(compute)
            return dev

        out = tuple(_tree_map(upload, a) for a in args)
        copied = torch.cuda.Event()
        copied.record(self._stream)
        compute.wait_event(copied)
        self._copied[slot] = copied
        return out
