"""Sequence parallelism: ring attention and Ulysses all-to-all
(``bigdl_tpu/parallel/ring_attention.py``).

Each rank of a mesh axis holds one shard of the sequence, (B, T_local,
H, D), the global sequence being the shards in coordinate order. The
axis name resolves against ``Engine.current_mesh()`` (the mesh that
``Engine.mesh(axis_names=...)`` or ``Engine.hybrid_mesh`` built last;
:mod:`bigdl_tpu_torch.parallel.axis`), where JAX binds it with a
``shard_map``; with no such mesh the functions raise.

* :func:`ring_attention` — K/V blocks travel around the ring, one
  ``batch_isend_irecv`` to rank + 1 per rotation, while each rank
  accumulates its queries' attention. ``use_flash=True`` computes each
  block with :func:`bigdl_tpu_torch.ops.flash_attention.
  flash_attention_with_lse` (the flash forward kernel on the card, its
  plain version on the CPU) and merges blocks by their log-sum-exp
  (:func:`merge_block`); the backward is a flash-block ring too
  (:func:`~bigdl_tpu_torch.ops.flash_attention.
  flash_attention_block_grads` against the saved global LSE), the dk/dv
  accumulators travelling around the ring back home. Which block each
  rotation computes, with which mask, is :func:`ring_step_spec`.
  ``use_flash=False`` is the einsum ring (one (T, T) score block per
  rotation, differentiable through autograd).
* :func:`striped_ring_attention` — the causal ring over striped shards
  (:func:`stripe_sequence`): every rotation runs the causal kernel,
  inclusive for stripes of lower ranks and strict (offset -1) for higher
  ones, so no block is computed and then discarded.
* :func:`ulysses_attention` — ``all_to_all_single`` from sequence-sharded
  to head-sharded, local attention per head group, and back.

At one rank the rings send nothing (one block, an identity merge) and the
all-to-all is the identity.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.parallel import axis as _axis


def _local_attention(q, k, v, scale: float, causal: bool, q_offset: int = 0,
                     k_offset: int = 0):
    """Dense softmax attention on local blocks (``:28``): q (B, Tq, H, D),
    k/v (B, Tk, H, D); the offsets are the blocks' global positions for
    the causal mask."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                        -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return out / p.sum(-1)[..., None].transpose(1, 2).clamp_min(1e-20)


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Single-device multi-head attention, (B, T, H, D) layout (``:47``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _local_attention(q, k, v, scale, causal)


def ring_step_spec(schedule: str, causal: bool):
    """The per-rotation block policy of both flash rings (``:79``):
    ``spec(step, src, my) -> (causal_flag, causal_offset, keep)`` for the
    block that originated at coordinate ``src``, seen by ``my`` after
    ``step`` rotations.

    * ``"contiguous"``: rotation 0 is the diagonal block (causal kernel
      when ``causal``); later rotations run non-causal, and in causal mode
      a block from this rank's future is computed and then nulled
      (``keep`` False: -inf LSE, zero gradients).
    * ``"striped"``: every rotation runs the causal kernel, offset 0 for
      a stripe of a lower or equal rank, -1 (strict) for a higher one.

    ``keep`` is ``None`` where the block always counts."""
    if schedule == "striped":
        def spec(step, src, my):
            return True, (0 if src <= my else -1), None
    elif schedule == "contiguous":
        def spec(step, src, my):
            if step == 0:
                return causal, None, None
            return False, None, (src < my) if causal else None
    else:
        raise ValueError(f"unknown ring schedule {schedule!r}")
    return spec


def merge_block(acc, o_i, lse_i):
    """Fold one block's ``(o_i (B, Tq, H, D), lse_i (B, H, Tq))`` into the
    running ``acc = (m, l, o_acc)`` (``None`` before the first block) by
    the streaming log-sum-exp rescale (``:127-140``); returns the new
    ``acc``."""
    if acc is None:
        return lse_i, torch.ones_like(lse_i), o_i.float()
    m, l, o_acc = acc
    m_new = torch.maximum(m, lse_i)
    corr = torch.exp(m - m_new)           # rescale the old accumulators
    w = torch.exp(lse_i - m_new)          # this block's weight
    o_acc = (o_acc * corr.transpose(1, 2)[..., None]
             + o_i.float() * w.transpose(1, 2)[..., None])
    return m_new, l * corr + w, o_acc


def finish_merge(acc, dtype):
    """``(out in dtype, lse_global (B, H, Tq))`` from a merged ``acc``."""
    m, l, o_acc = acc
    l_safe = l.clamp_min(1e-20)
    out = (o_acc / l_safe.transpose(1, 2)[..., None]).to(dtype)
    return out, m + torch.log(l_safe)


def _keep(keep, device):
    return torch.tensor(bool(keep), device=device)


def _ring_flash_fwd(q, k, v, ax, scale: float, spec):
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_with_lse

    n, my = ax.size, ax.index
    acc = None
    kb, vb = k, v
    for step in range(n):
        src = (my - step) % n
        causal_s, off, keep = spec(step, src, my)
        o_i, lse_i = flash_attention_with_lse(q, kb, vb, scale,
                                              causal=causal_s,
                                              causal_offset=off)
        if keep is not None:
            lse_i = torch.where(_keep(keep, q.device), lse_i, -math.inf)
        acc = merge_block(acc, o_i, lse_i)
        if step < n - 1:                  # the last rotation would be dead
            kb, vb = _axis.rotate(ax, [kb, vb])
    return finish_merge(acc, q.dtype)


def _ring_flash_bwd(q, k, v, o, lse, do, ax, scale: float, spec):
    """dq accumulates here; the dk/dv accumulators travel with their K/V
    block and n rotations bring them home (``:148``)."""
    from bigdl_tpu_torch.ops.flash_attention import (
        flash_attention_block_grads,
    )

    n, my = ax.size, ax.index
    dq = dk_acc = dv_acc = None
    kb, vb = k, v
    for step in range(n):
        src = (my - step) % n
        causal_s, off, keep = spec(step, src, my)
        dq_i, dk_i, dv_i = flash_attention_block_grads(
            q, kb, vb, o, lse, do, scale, causal=causal_s,
            causal_offset=off)
        if keep is not None:
            # an excluded block never entered the global softmax, so its
            # p = exp(s - lse_global) is unbounded (can overflow to inf):
            # null it with a NaN-safe select, never a multiply by zero
            kt = _keep(keep, q.device)
            dq_i = torch.where(kt, dq_i, 0.0)
            dk_i = torch.where(kt, dk_i, 0.0)
            dv_i = torch.where(kt, dv_i, 0.0)
        if step == 0:
            dq, dk_acc, dv_acc = dq_i.float(), dk_i.float(), dv_i.float()
        else:
            dq = dq + dq_i.float()
            dk_acc = dk_acc + dk_i.float()
            dv_acc = dv_acc + dv_i.float()
        # the accumulators rotate every step (n hops bring them home);
        # kb/vb are dead after the last compute
        if step < n - 1:
            kb, vb, dk_acc, dv_acc = _axis.rotate(ax, [kb, vb, dk_acc,
                                                       dv_acc])
        else:
            dk_acc, dv_acc = _axis.rotate(ax, [dk_acc, dv_acc])
    return dq.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring with its custom backward (JAX's ``custom_vjp``,
    ``:207-239``)."""

    @staticmethod
    def forward(ctx, q, k, v, ax, scale, causal, schedule):
        out, lse = _ring_flash_fwd(q, k, v, ax, scale,
                                   ring_step_spec(schedule, causal))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ax, ctx.scale = ax, scale
        ctx.spec = (schedule, causal)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, do, ctx.ax,
                                     ctx.scale, ring_step_spec(*ctx.spec))
        return dq, dk, dv, None, None, None, None


def _scale(q, scale):
    return float(scale if scale is not None else 1.0 / math.sqrt(q.shape[-1]))


def ring_attention(q, k, v, axis_name: str, causal: bool = False,
                   scale: Optional[float] = None, use_flash: bool = False):
    """Blockwise ring attention over the mesh axis ``axis_name``
    (``:55``): q/k/v are this rank's sequence shard (B, T_local, H, D);
    returns the attention output of the local queries over the whole
    sequence."""
    ax = _axis.axis(axis_name)
    if use_flash:
        return _RingFlash.apply(q, k, v, ax, _scale(q, scale), bool(causal),
                                "contiguous")
    return _ring_einsum(q, k, v, ax, causal, scale)


def stripe_sequence(x, n: int):
    """Global (B, T, ...) → striped layout (``:242``): token t moves to
    stripe t % n, slot t // n, so a contiguous n-way shard gives rank r
    the tokens {r, r + n, r + 2n, ...}. Requires T % n == 0."""
    b, t = x.shape[0], x.shape[1]
    assert t % n == 0, f"T {t} not divisible by {n} stripes"
    rest = tuple(x.shape[2:])
    return (x.reshape((b, t // n, n) + rest).transpose(1, 2)
            .reshape((b, t) + rest))


def unstripe_sequence(x, n: int):
    """Inverse of :func:`stripe_sequence` (``:255``)."""
    b, t = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    return (x.reshape((b, n, t // n) + rest).transpose(1, 2)
            .reshape((b, t) + rest))


def striped_ring_attention(q, k, v, axis_name: str,
                           scale: Optional[float] = None):
    """Causal ring attention over striped shards (``:264``); flash blocks
    both ways. The shards must be in stripe layout."""
    ax = _axis.axis(axis_name)
    return _RingFlash.apply(q, k, v, ax, _scale(q, scale), True, "striped")


def _ring_einsum(q, k, v, ax, causal: bool = False,
                 scale: Optional[float] = None):
    """The einsum ring (``:278``): one (T, T) score block per rotation,
    an online softmax, differentiable through autograd (the rotation's
    backward is the reverse rotation)."""
    scale = _scale(q, scale)
    n, my = ax.size, ax.index
    B, T, H, D = q.shape
    q_off = my * T
    m = torch.full((B, H, T), -math.inf, device=q.device)
    l = torch.zeros((B, H, T), device=q.device)
    o = torch.zeros((B, T, H, D), device=q.device)
    kb, vb = k, v
    for step in range(n):
        src = (my - step) % n
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).float() * scale
        if causal:
            qpos = q_off + torch.arange(T, device=q.device)
            kpos = src * T + torch.arange(T, device=q.device)
            s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                            -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        # a block can be fully masked (-inf): keep the correction finite
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        o = o * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p, vb.float())
        m = m_new
        if step < n - 1:                  # the last rotation would be dead
            kb = _axis.ring_shift(kb, ax)
            vb = _axis.ring_shift(vb, ax)
    out = o / l.transpose(1, 2)[..., None].clamp_min(1e-20)
    return out.to(q.dtype)


def ulysses_attention(q, k, v, axis_name: str, causal: bool = False,
                      scale: Optional[float] = None,
                      use_flash: bool = False):
    """All-to-all sequence parallelism (``:333``): (B, T_local, H, D) →
    (B, T_global, H_local, D), attention per head group, and back.
    Requires H divisible by the axis size. ``use_flash=True`` runs the
    per-group attention through
    :func:`bigdl_tpu_torch.ops.flash_attention.flash_attention`."""
    ax = _axis.axis(axis_name)
    n = ax.size
    if q.shape[2] % n:
        raise ValueError(f"heads {q.shape[2]} not divisible by axis size {n}")
    scale = _scale(q, scale)

    def seq_to_heads(x):      # gather seq (axis 1), scatter heads (axis 2)
        b, t, h, d = x.shape
        parts = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        got = _axis.all_to_all(parts, ax)            # (n, b, t, h/n, d)
        return got.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)

    def heads_to_seq(x):
        b, t, h, d = x.shape
        parts = x.reshape(b, n, t // n, h, d).permute(1, 0, 2, 3, 4)
        got = _axis.all_to_all(parts, ax)            # (n, b, t/n, h, d)
        return got.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, d)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if use_flash:
        from bigdl_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(qg, kg, vg, causal=causal, scale=scale)
    else:
        out = _local_attention(qg, kg, vg, scale, causal)
    return heads_to_seq(out)
