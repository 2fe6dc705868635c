"""The declared device→host readback of the serving plane
(``bigdl_tpu/serving/fences.py``).

PyTorch queues CUDA work asynchronously until something reads a device
value back (``.cpu()``, ``.item()``, ``.tolist()``, a Python branch on a
tensor); then the host waits for everything queued. :func:`fence` is the
one idiom a deliberate readback wears in the engine: ONE batched copy of
several small tensors (the per-step token ids and chosen log-probs),
over a closed site vocabulary.
"""

from __future__ import annotations

import torch

#: The closed fence-site vocabulary; an unknown site raises.
FENCE_SITES = frozenset({
    "decode",   # the per-step token/logprob readback
})


def fence(site: str, *values):
    """Read ``values`` back to host numpy arrays in ONE device→host copy
    (the tensors are flattened to bytes, concatenated, copied once and
    split again). A single value comes back bare, several as a tuple."""
    if site not in FENCE_SITES:
        raise ValueError(
            f"unknown fence site {site!r} — add it to "
            f"fences.FENCE_SITES first; known: {sorted(FENCE_SITES)}")
    flat = [v.detach().contiguous().reshape(-1).view(torch.uint8)
            for v in values]
    host = torch.cat(flat).cpu().numpy()
    out, at = [], 0
    for v, f in zip(values, flat):
        n = f.numel()
        dt = torch.empty((), dtype=v.dtype).numpy().dtype
        out.append(host[at:at + n].view(dt).reshape(tuple(v.shape)))
        at += n
    return out[0] if len(out) == 1 else tuple(out)
