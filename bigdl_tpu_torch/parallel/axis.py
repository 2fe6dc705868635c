"""Mesh axes and the collectives of the parallel planes.

The JAX package's tensor, pipeline, sequence and expert parallel
functions run inside a ``shard_map`` and name a mesh axis (``"model"``,
``"pipe"``, ``"seq"``, ``"expert"``); ``lax.axis_index``, ``psum``,
``ppermute`` and ``all_to_all`` act over that axis. The port runs one
process per device, so an axis is a dimension of the ``DeviceMesh`` that
:meth:`bigdl_tpu_torch.utils.engine.Engine.mesh` or
:meth:`~bigdl_tpu_torch.utils.engine.Engine.hybrid_mesh` built last
(``Engine.current_mesh()``): :func:`axis` resolves a name to that
dimension's process group, this rank's index in it and its size. With no
such mesh, or no such dimension, it raises, as a JAX collective raises on
an axis name no ``shard_map`` binds.

The collectives below are ``torch.autograd.Function``s whose backward is
the transpose JAX derives:

* :func:`psum` — an all-reduce (sum); backward the identity;
* :func:`copy_to` — the identity; backward an all-reduce (the gradient
  of an input every rank holds a replica of);
* :func:`ring_shift` — ``ppermute`` to rank + 1 around the ring (one
  ``batch_isend_irecv``); backward the shift to rank - 1;
* :func:`pipe_shift` — the one-way shift to the next stage (the first
  stage receives zeros); backward the shift to the previous stage;
* :func:`all_to_all` — ``all_to_all_single`` over a leading axis of the
  group's size (chunk j goes to rank j); backward the same exchange;
* :func:`all_gather_last` — all-gather along the last dimension;
  backward this rank's chunk of the gradient.

At size 1 every one of them is the identity and issues nothing (JAX's
one-device collectives are the identity, and NCCL gives no send to
self). :func:`sum_gradients` is the train step's all-reduce of the
replicated weights' gradients.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch


def _dist():
    import torch.distributed as dist

    return dist


class Axis(NamedTuple):
    """One mesh dimension as this process sees it."""
    name: str
    group: object          # the dimension's ProcessGroup
    index: int             # this rank's coordinate along it
    size: int
    ranks: List[int]       # global ranks along it, by coordinate

    def peer(self, offset: int) -> int:
        """Global rank of the coordinate ``index + offset`` (mod size)."""
        return self.ranks[(self.index + offset) % self.size]


def axis(name: str) -> Axis:
    """Resolve a mesh axis name against ``Engine.current_mesh()``."""
    from bigdl_tpu_torch.utils.engine import Engine

    mesh = Engine.current_mesh()
    if mesh is None:
        raise RuntimeError(
            f"mesh axis {name!r} is unbound: build a mesh with "
            f"Engine.mesh(axis_names=(..., {name!r}, ...)) or "
            "Engine.hybrid_mesh() first (after Engine.init_distributed())")
    names = tuple(mesh.mesh_dim_names or ())
    if name not in names:
        raise RuntimeError(f"mesh axis {name!r} is unbound: the current "
                           f"mesh has dimensions {names}")
    dist = _dist()
    group = mesh.get_group(name)
    return Axis(name, group, int(mesh.get_local_rank(name)),
                int(mesh.shape[names.index(name)]),
                list(dist.get_process_group_ranks(group)))


def exchange(ax: Axis, sends, recvs):
    """One ``batch_isend_irecv``: ``sends`` are ``(tensor, global rank)``
    pairs, ``recvs`` ``(like tensor, global rank)`` pairs; returns the
    received tensors in ``recvs``' order."""
    dist = _dist()
    ops, out = [], []
    for t, peer in sends:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), peer, ax.group))
    for like, peer in recvs:
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        out.append(buf)
        ops.append(dist.P2POp(dist.irecv, buf, peer, ax.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def rotate(ax: Axis, tensors, offset: int = 1):
    """Send each tensor to coordinate ``index + offset`` and receive the
    one coming from ``index - offset`` (not differentiable; the rings'
    building block)."""
    if ax.size == 1:
        return list(tensors)
    return exchange(ax, [(t, ax.peer(offset)) for t in tensors],
                    [(t, ax.peer(-offset)) for t in tensors])


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return rotate(ax, [x], 1)[0]

    @staticmethod
    def backward(ctx, g):
        return rotate(ctx.ax, [g], -1)[0], None


def ring_shift(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + 1) % n)])``, differentiable."""
    return x if ax.size == 1 else _RingShift.apply(x, ax)


def _pipe_exchange(ax: Axis, t: torch.Tensor, forward: bool):
    first, last = ax.index == 0, ax.index == ax.size - 1
    to_next, from_prev = (not last, not first) if forward else (
        not first, not last)
    off = 1 if forward else -1
    got = exchange(ax, [(t, ax.peer(off))] if to_next else [],
                   [(t, ax.peer(-off))] if from_prev else [])
    return got[0] if got else torch.zeros_like(t)


class _PipeShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _pipe_exchange(ax, x, True)

    @staticmethod
    def backward(ctx, g):
        return _pipe_exchange(ctx.ax, g, False), None


def pipe_shift(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, i + 1) for i < n - 1]``: stage i's
    tensor goes to stage i + 1, stage 0 receives zeros; differentiable."""
    return torch.zeros_like(x) if ax.size == 1 else _PipeShift.apply(x, ax)


def _all_to_all(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    _dist().all_to_all_single(out, x, group=ax.group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _all_to_all(ax, x)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.ax, g), None


def all_to_all(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``x`` (n, ...) with n the axis size: chunk j goes to coordinate j
    and the result's chunk j came from coordinate j (``lax.all_to_all``
    with ``split_axis=concat_axis=0``, untiled); differentiable."""
    if x.shape[0] != ax.size:
        raise ValueError(f"all_to_all needs a leading axis of {ax.size}, "
                         f"got {tuple(x.shape)}")
    return x if ax.size == 1 else _AllToAll.apply(x, ax)


def _all_reduce(ax: Axis, x: torch.Tensor) -> torch.Tensor:
    y = x.contiguous().clone()
    _dist().all_reduce(y, group=ax.group)
    return y


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(ax, x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.ax, g), None


def psum(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``lax.psum`` over the axis; the backward passes the gradient
    through (each rank's loss reads the one replicated sum)."""
    return x if ax.size == 1 else _Psum.apply(x, ax)


def copy_to(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """A replicated input entering per-rank work: the identity forward,
    an all-reduce of the gradient backward."""
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


class _AllGatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(ax.size)]
        _dist().all_gather(parts, x, group=ax.group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        ax = ctx.ax
        return g.chunk(ax.size, dim=-1)[ax.index].contiguous(), None


def all_gather_last(x: torch.Tensor, ax: Axis) -> torch.Tensor:
    """``lax.all_gather(x, axis, axis=-1, tiled=True)``."""
    return x if ax.size == 1 else _AllGatherLast.apply(x, ax)


def sum_gradients(axis_name: str, names: Optional[set] = None):
    """A ``make_train_step(grad_transform=)`` that sums every gradient (or
    those in ``names``) over ``axis_name``: what ``shard_map`` does for a
    weight every rank of the axis holds a replica of (``in_specs=P()``).
    The gradients of one dtype travel flattened in one all-reduce, at
    every axis size."""

    def transform(grads):
        from torch._utils import (
            _flatten_dense_tensors, _unflatten_dense_tensors,
        )

        ax = axis(axis_name)
        keys = [k for k in grads if names is None or k in names]
        by_dtype = {}
        for k in keys:
            by_dtype.setdefault(grads[k].dtype, []).append(k)
        out = dict(grads)
        for group in by_dtype.values():   # one all-reduce per dtype
            flat = _flatten_dense_tensors([grads[k] for k in group])
            _dist().all_reduce(flat, group=ax.group)
            for k, t in zip(group, _unflatten_dense_tensors(
                    flat, [grads[k] for k in group])):
                out[k] = t
        return out

    return transform
