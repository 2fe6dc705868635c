"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis
(``bigdl_tpu/parallel/pipeline.py``).

Every rank of the axis holds one stage's parameters. The schedule is
JAX's tick loop: ``M + n_stages - 1`` ticks, in each of which every
stage runs ``fn`` once and hands its result one way to the next stage
(:func:`bigdl_tpu_torch.parallel.axis.pipe_shift`, one
``batch_isend_irecv``); the last stage's outputs are then summed to every
rank (an all-reduce). The backward is autograd through the same loop:
the shift's transpose sends gradients one stage back, tick by tick in
reverse, so every rank's backward visits the shifts in the same order.
"""

from __future__ import annotations

from typing import Callable

import torch

from bigdl_tpu_torch.parallel import axis as _axis


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def gpipe(fn: Callable, stage_params, microbatches, axis_name: str = "pipe"):
    """Run ``microbatches`` ``(M, mb, ...)`` (replicated; only stage 0
    reads them) through the ``n_stages``-deep pipeline (``:27``).

    ``stage_params`` is this rank's slice of the stacked per-stage tree:
    each leaf ``(1, ...)`` (``stacked[i:i + 1]`` on stage i, what JAX's
    ``in_specs=P(axis)`` hands a device); the unit axis is stripped here.
    ``fn(stage_params, x) -> y`` keeps x's shape. Returns the ``(M, mb,
    ...)`` outputs on every rank."""
    ax = _axis.axis(axis_name)
    n_stages, idx = ax.size, ax.index
    params = _tree_map(lambda l: l[0], stage_params)
    M = microbatches.shape[0]
    is_first = torch.tensor(idx == 0, device=microbatches.device)
    is_last = torch.tensor(idx == n_stages - 1, device=microbatches.device)
    n_ticks = M + n_stages - 1
    outs = [None] * M
    recv = torch.zeros_like(microbatches[0])
    for t in range(n_ticks):
        # stage 0 ingests microbatch t (clamped; unused once t >= M)
        x = torch.where(is_first, microbatches[min(t, M - 1)], recv)
        y = fn(params, x)
        done = t - (n_stages - 1)           # the last stage finishes it
        if 0 <= done < M:
            outs[done] = y
        if t < n_ticks - 1:                 # the last shift would be dead
            recv = _axis.pipe_shift(y, ax)
    stacked = torch.stack(outs)
    return _axis.psum(torch.where(is_last, stacked, 0.0), ax)


def stack_stage_params(per_stage_params):
    """A list of per-stage trees (dicts of arrays or tensors, one
    structure) → one tree whose leaves gain a leading ``(n_stages,)``
    axis (``:99``)."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    return torch.stack([torch.as_tensor(p) for p in per_stage_params])


def microbatch(x, n_micro: int):
    """(B, ...) → (n_micro, B / n_micro, ...) (``:112``)."""
    B = x.shape[0]
    assert B % n_micro == 0, f"batch {B} not divisible by {n_micro} microbatches"
    return x.reshape(n_micro, B // n_micro, *x.shape[1:])
