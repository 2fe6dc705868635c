"""Tensor (model) parallelism: Megatron-style column- and row-parallel
layers (``bigdl_tpu/parallel/tensor_parallel.py``).

Each rank of the mesh axis (``Engine.current_mesh()``,
:mod:`bigdl_tpu_torch.parallel.axis`) holds its slice of the weights:

* :func:`column_parallel_linear` — weight ``(out/n, in)``: this rank's
  output features from replicated activations; no collective forward,
  an all-reduce of the input's gradient backward (the replicated input's
  transpose), optionally an all-gather of the output;
* :func:`row_parallel_linear` — weight ``(out, in/n)`` on feature-sharded
  activations: a partial product completed by one all-reduce (JAX's
  ``psum``), whose backward passes the gradient through;
* :func:`tp_mlp` — column-parallel expansion, activation, row-parallel
  projection: one collective per block;
* :func:`tp_attention` — heads sharded over the axis.

This is the library half; sharded serving (``ShardedEngine``,
``tp_param_specs``) is not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.parallel import axis as _axis


def column_parallel_linear(x, w_shard, b_shard=None, axis_name: str = "model",
                           gather_output: bool = False):
    """``y_local = x @ w_shard.T (+ b_shard)`` (``:47``); ``(..., out/n)``,
    or the full ``(..., out)`` with ``gather_output`` (one all-gather,
    whose backward keeps this rank's chunk of the gradient)."""
    ax = _axis.axis(axis_name)
    y = torch.matmul(_axis.copy_to(x, ax), w_shard.t())
    if b_shard is not None:
        y = y + b_shard
    if gather_output:
        y = _axis.all_gather_last(y, ax)
    return y


def row_parallel_linear(x_shard, w_shard, b=None, axis_name: str = "model",
                        accum_dtype=None, partial_add=None):
    """``y = all_reduce(x_shard @ w_shard.T) (+ b)`` (``:69``); the bias
    is added once, after the reduction.

    ``accum_dtype`` (e.g. ``torch.float32``) carries each rank's partial
    product and the reduction in that dtype, rounding to ``x_shard``'s
    dtype once after it; ``partial_add`` (requires ``accum_dtype``) is a
    per-rank partial folded into the same reduction."""
    ax = _axis.axis(axis_name)
    if accum_dtype is not None:
        acc = torch.matmul(x_shard.to(accum_dtype),
                           w_shard.to(accum_dtype).t())
        if partial_add is not None:
            acc = acc + partial_add.to(accum_dtype)
        y = _axis.psum(acc, ax).to(x_shard.dtype)
    else:
        if partial_add is not None:
            raise ValueError("partial_add requires accum_dtype")
        y = _axis.psum(torch.matmul(x_shard, w_shard.t()), ax)
    if b is not None:
        y = y + b
    return y


def tp_mlp(x, w1_shard, b1_shard, w2_shard, b2, axis_name: str = "model",
           activation=None):
    """Megatron MLP block (``:111``): column-parallel W1 ``(hidden/n, in)``
    → activation (tanh-form GELU by default, JAX's ``jax.nn.gelu``) →
    row-parallel W2 ``(out, hidden/n)``."""
    act = activation or (lambda h: F.gelu(h, approximate="tanh"))
    h = column_parallel_linear(x, w1_shard, b1_shard, axis_name)
    return row_parallel_linear(act(h), w2_shard, b2, axis_name)


def tp_attention(x, wq, wk, wv, wo, axis_name: str, n_heads_local: int,
                 causal: bool = False, bo=None):
    """Head-sharded self-attention (``:126``): ``wq/wk/wv`` column-parallel
    shards ``(d_local, d_model)``, ``wo`` a row-parallel shard ``(d_model,
    d_local)``, ``d_local = n_heads_local * head_dim``; one all-reduce
    closes the output projection."""
    from bigdl_tpu_torch.parallel.ring_attention import attention

    q = column_parallel_linear(x, wq, axis_name=axis_name)
    k = column_parallel_linear(x, wk, axis_name=axis_name)
    v = column_parallel_linear(x, wv, axis_name=axis_name)
    B, T, d_local = q.shape
    h = n_heads_local
    hd = d_local // h
    o = attention(q.reshape(B, T, h, hd), k.reshape(B, T, h, hd),
                  v.reshape(B, T, h, hd), causal=causal,
                  scale=1.0 / math.sqrt(hd)).reshape(B, T, d_local)
    return row_parallel_linear(o, wo, bo, axis_name)
