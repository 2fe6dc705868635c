"""The fusion pass — an alternate NHWC execution of a ``Graph``
(``bigdl_tpu/nn/tpu_fusion.py``).

``FusedGraph`` holds the wrapped graph as its child ``graph``, so it has
the SAME parameters and buffers (one tree for both, as in JAX
``:153-161``), and executes differently:

* channels-last (NHWC) inside, NCHW at the boundary: a 1×1 convolution is
  then a plain ``(N·H·W, C) × (C, K)`` product over contiguous rows, the
  operand form of the fused kernels;
* each ``BN → ReLU → 1×1 conv`` edge (optionally through the residual
  ``CAddTable``) whose BN has C ≥ ``BIGDL_PALLAS_MIN_C`` channels runs as
  one :func:`bigdl_tpu_torch.ops.fused_conv.bn_relu_conv1x1` call, so the
  activation between BN and conv is never written; narrower edges run the
  same math as plain torch;
* the kernels' per-channel ``Σz/Σz²`` feed the next fused edge's BN, so no
  pass re-reads a kernel's output for statistics;
* BN running statistics follow ``BatchNormalization`` exactly (biased
  variance to normalize, unbiased in the buffer, ``r = (1−m)r + m·batch``).

**Statistics and gradients.** A fused edge passes its BN statistics to the
kernel DETACHED: the edge's own backward adds their chain-rule share (the
q correction inside dx). Only a fused edge whose BN reads another fused
conv's output takes that conv's cached ``zstats``, which carry no
gradient. Every other BN computes differentiable statistics from its
input, so autograd owns their share, and nothing is counted twice.

The lowering threshold is the JAX package's environment knob with its
default (``1 << 30``: no edge takes the kernels); ``BIGDL_PALLAS_MIN_C=128``
sends every ResNet edge with C ≥ 128 to them. Modules without an NHWC rule
get NCHW views of their inputs (correct for any graph).
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch

from bigdl_tpu_torch.nn.activations import ReLU
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.conv import SpatialConvolution
from bigdl_tpu_torch.nn.graph import Graph
from bigdl_tpu_torch.nn.module import AbstractModule, Identity
from bigdl_tpu_torch.nn.normalization import (
    SpatialBatchNormalization, batch_moments, update_running,
)
from bigdl_tpu_torch.nn.pooling import SpatialAveragePooling, SpatialMaxPooling
from bigdl_tpu_torch.nn.shape_ops import CAddTable
from bigdl_tpu_torch.ops.fused_conv import bn_relu_conv1x1


def _pallas_min_c() -> int:
    """Per-edge lowering threshold (the JAX package's knob and default)."""
    return int(os.environ.get("BIGDL_PALLAS_MIN_C", str(1 << 30)))


class _PNode:
    """A primitive node of the expanded DAG: a leaf module and its
    predecessor nodes."""

    __slots__ = ("module", "preds", "is_input")

    def __init__(self, module, preds, is_input=False):
        self.module = module
        self.preds: List[_PNode] = preds
        self.is_input = is_input


def _expand(graph: Graph):
    """Graph topo order → primitive DAG, Sequentials flattened (other
    containers stay opaque primitives)."""
    node_out: Dict[int, _PNode] = {}
    pnodes: List[_PNode] = []

    def expand_module(module, preds):
        if isinstance(module, Sequential) and len(module) > 0:
            cur = preds
            for child in module.layers():
                cur = [expand_module(child, cur)]
            return cur[0]
        p = _PNode(module, preds)
        pnodes.append(p)
        return p

    ins = {}
    for node in graph.topo:
        if any(node is n for n in graph.input_nodes):
            p = _PNode(node.module, [], is_input=True)
            pnodes.append(p)
            node_out[id(node)] = ins[id(node)] = p
            continue
        preds = [node_out[id(q)] for q in node.prev]
        node_out[id(node)] = expand_module(node.module, preds)
    outs = [node_out[id(n)] for n in graph.output_nodes]
    return pnodes, [ins[id(n)] for n in graph.input_nodes], outs


def _is_fusable_conv(m) -> bool:
    return (isinstance(m, SpatialConvolution)
            and m.kernel_w == 1 and m.kernel_h == 1
            and m.stride_w == 1 and m.stride_h == 1
            and m.pad_w == 0 and m.pad_h == 0
            and m.n_group == 1 and not m.with_bias)


class _FusedEdge:
    """One lowered BN → ReLU → conv1×1 edge (optionally through
    CAddTable)."""

    __slots__ = ("bn", "relu", "conv", "add", "residual_src", "want_y")

    def __init__(self, bn, relu, conv, add=None, residual_src=None,
                 want_y=False):
        self.bn, self.relu, self.conv = bn, relu, conv
        self.add, self.residual_src, self.want_y = add, residual_src, want_y


def _nchw(v):
    return v.permute(0, 3, 1, 2) if v.dim() == 4 else v


def _nhwc(v):
    return v.permute(0, 2, 3, 1) if v.dim() == 4 else v


def _conv_nhwc(m: SpatialConvolution, x):
    """A convolution of NHWC ``x``: a 1×1 one as a product contracting C
    (a stride slices the rows first), any other through ``F.conv2d`` on
    the channels-last NCHW view."""
    if (m.kernel_w == 1 and m.kernel_h == 1 and m.pad_w == 0
            and m.pad_h == 0 and m.n_group == 1):
        if m.stride_h != 1 or m.stride_w != 1:
            x = x[:, ::m.stride_h, ::m.stride_w, :]
        out = x @ m.weight[:, :, 0, 0].t().to(x.dtype)
        return out if m.bias is None else out + m.bias
    return _nhwc(m.conv(_nchw(x), m.weight, m.bias))


def _bn_nhwc(m, x, mean, var):
    """BatchNormalization's output on NHWC ``x`` (channel axis last)."""
    inv = (1.0 / torch.sqrt(var + m.eps)).to(x.dtype)
    out = (x - mean.to(x.dtype)) * inv
    if m.affine:
        out = out * m.weight.to(x.dtype) + m.bias.to(x.dtype)
    return out


class FusedGraph(AbstractModule):
    """Drop-in wrapper of ``graph``: same parameters and buffers, NHWC
    fused execution."""

    def __init__(self, graph: Graph) -> None:
        super().__init__()
        self.graph = graph
        self._build_plan()

    def __setstate__(self, state) -> None:
        # the plan is keyed by node ids, which a deep copy or an unpickle
        # (``Module.load`` of a checkpoint) gives new values
        super().__setstate__(state)
        self._build_plan()

    def _build_plan(self) -> None:
        pnodes, ins, outs = _expand(self.graph)
        self._pnodes, self._ins, self._outs = pnodes, ins, outs
        consumers: Dict[int, int] = {}
        for p in pnodes:
            for q in p.preds:
                consumers[id(q)] = consumers.get(id(q), 0) + 1
        for o in outs:
            consumers[id(o)] = consumers.get(id(o), 0) + 1
        order = {id(p): i for i, p in enumerate(pnodes)}
        consumed: Dict[int, _FusedEdge] = {}   # node id -> owning edge
        edges: Dict[int, _FusedEdge] = {}      # conv node id -> edge

        for conv in pnodes:
            if not _is_fusable_conv(conv.module) or len(conv.preds) != 1:
                continue
            relu = conv.preds[0]
            if (not isinstance(relu.module, ReLU) or id(relu) in consumed
                    or len(relu.preds) != 1):
                continue
            src = relu.preds[0]
            want_y = consumers.get(id(relu), 0) > 1 or relu in outs
            if want_y and not all(order[id(p)] > order[id(conv)]
                                  for p in pnodes
                                  if any(q is relu for q in p.preds)
                                  and p is not conv):
                continue  # y's other consumers must run after the conv
            add = residual = None
            if isinstance(src.module, SpatialBatchNormalization):
                if consumers.get(id(src), 0) != 1 or len(src.preds) != 1:
                    continue
                bn = src
            elif isinstance(src.module, CAddTable) and len(src.preds) == 2:
                cand = src.preds[0]
                if not (consumers.get(id(src), 0) == 1
                        and isinstance(cand.module, SpatialBatchNormalization)
                        and consumers.get(id(cand), 0) == 1
                        and len(cand.preds) == 1
                        and id(cand) not in consumed):
                    continue
                bn, add, residual = cand, src, src.preds[1]
            else:
                continue
            if id(bn) in consumed:
                continue
            edge = _FusedEdge(bn, relu, conv, add=add, residual_src=residual,
                              want_y=want_y)
            edges[id(conv)] = edge
            for node in (bn, relu, add):
                if node is not None:
                    consumed[id(node)] = edge
        self._edges = edges
        self._consumed = consumed

    def forward(self, x):
        graph = self.graph
        inputs = [x] if graph._single_input else list(x)
        values: Dict[int, torch.Tensor] = {}
        stats: Dict[int, torch.Tensor] = {}    # conv node id -> (2, K) f32
        for pn, v in zip(self._ins, inputs):
            values[id(pn)] = _nhwc(v).contiguous() if v.dim() == 4 else v
        min_c = _pallas_min_c()

        def bn_mv(bnode, x_val, src_id, use_cache=False):
            """(mean, var) of this BN and its running-stat update. With
            ``use_cache`` the stats come from a fused producer's epilogue
            (no gradient); otherwise they are differentiable."""
            m = bnode.module
            if not self.training:
                return m.running_mean, m.running_var
            n = x_val.numel() // x_val.shape[-1]
            if use_cache and src_id in stats:
                st = stats[src_id]
                mean = st[0] / n
                var = torch.clamp_min(st[1] / n - mean * mean, 0.0)
            else:
                mean, var = batch_moments(x_val, tuple(range(x_val.dim() - 1)),
                                          fused=True)
            update_running(m, mean, var, n)
            return mean, var

        def run_fused(edge):
            src = edge.bn.preds[0]
            x_val = values[id(src)]
            n, h, w_, c = x_val.shape
            bnm = edge.bn.module
            use_kernel = c >= min_c
            mean, var = bn_mv(edge.bn, x_val, id(src), use_cache=use_kernel)
            gamma = (bnm.weight if bnm.affine
                     else torch.ones(c, device=x_val.device))
            beta = (bnm.bias if bnm.affine
                    else torch.zeros(c, device=x_val.device))
            w2 = edge.conv.module.weight[:, :, 0, 0].t()        # (C, K)
            k = w2.shape[1]
            res = (None if edge.residual_src is None
                   else values[id(edge.residual_src)])
            if use_kernel:
                out = bn_relu_conv1x1(
                    x_val.reshape(-1, c), gamma, beta,
                    mean.detach().float(), var.detach().float(), w2,
                    None if res is None else res.reshape(-1, c), bnm.eps,
                    edge.want_y)
                stats[id(edge.conv)] = out[1]
                values[id(edge.conv)] = out[0].reshape(n, h, w_, k)
                if edge.want_y:
                    values[id(edge.relu)] = out[2].reshape(n, h, w_, c)
                return
            # the same math in plain torch, elementwise in the data dtype
            inv = 1.0 / torch.sqrt(var + bnm.eps)
            scale = (inv * gamma).to(x_val.dtype)
            shift = (beta - mean * inv * gamma).to(x_val.dtype)
            p = x_val * scale + shift
            if res is not None:
                p = p + res
            y4 = torch.relu(p)
            values[id(edge.conv)] = y4 @ w2.to(y4.dtype)
            if edge.want_y:
                values[id(edge.relu)] = y4

        def run_prim(p):
            args = [values[id(q)] for q in p.preds]
            x_in = args[0] if len(args) == 1 else args
            m = p.module
            if (isinstance(m, SpatialConvolution) and x_in.dim() == 4
                    and m.n_group == 1):
                values[id(p)] = _conv_nhwc(m, x_in)
            elif isinstance(m, SpatialBatchNormalization) and x_in.dim() == 4:
                mean, var = bn_mv(p, x_in, id(p.preds[0]))
                values[id(p)] = _bn_nhwc(m, x_in, mean, var)
            elif (isinstance(m, (SpatialMaxPooling, SpatialAveragePooling))
                  and x_in.dim() == 4):
                values[id(p)] = _nhwc(m.pool(_nchw(x_in)))
            elif (isinstance(m, (ReLU, CAddTable, Identity))
                  or type(m).__name__ in _AGNOSTIC):
                values[id(p)] = m(x_in)
            else:
                # correct for anything: hand the module NCHW views
                xin = [_nchw(v) for v in args]
                out = m(xin[0] if len(xin) == 1 else xin)
                values[id(p)] = _nhwc(out)

        for p in self._pnodes:
            if p.is_input:
                continue
            if id(p) in self._edges:
                run_fused(self._edges[id(p)])
            elif id(p) not in self._consumed:
                run_prim(p)
        outs = [_nchw(values[id(p)]) for p in self._outs]
        return outs[0] if graph._single_output else outs

    def extra_repr(self) -> str:
        return f"{len(self._edges)} fused edges"


# Modules whose forward is layout-indifferent on NHWC values. Reshape/View
# only follow global pooling here, where the spatial dims are 1×1 and an
# NHWC flatten equals the NCHW one.
_AGNOSTIC = {
    "ReLU", "ReLU6", "Tanh", "Sigmoid", "Dropout", "CAddTable", "CMulTable",
    "Identity", "LogSoftMax", "Linear", "Reshape", "View",
}


def maybe_fuse(model):
    """Wrap a Graph in FusedGraph when it has at least one fusable edge;
    return anything else unchanged."""
    if not isinstance(model, Graph):
        return model
    fused = FusedGraph(model)
    return fused if fused._edges else model
