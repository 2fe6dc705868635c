"""Transformer language model and its serving steps
(``bigdl_tpu/models/transformer.py``).

The model is a ``Sequential`` of ``LookupTable → PositionEmbedding →
n × TransformerBlock → LayerNorm → Linear → LogSoftMax`` with the JAX
package's child order and params layout, so
:func:`load_jax_params` carries a JAX params tree across one to one.

The serving half ports the steps the int8-KV continuous-batching engine
runs:

* :func:`make_batch_prefill_step` — masked multi-row prompt ingestion
  over ``(B, L)`` right-padded tokens with per-row ``lengths`` and start
  offsets (``carry["pos"]``); returns a NEW carry and never writes its
  input carry, so one zero carry can serve every admission, and a cached
  prefix can be continued without being changed;
* :func:`make_prefill_step` — equal-length prompts into a fresh carry,
  the per-request admission step (the same layer loop);
* :func:`make_batch_decode_step` — one token for every pooled row at its
  own position, with the fused per-row sampler when ``sampling=True``.
  It updates the pooled carry IN PLACE (the JAX step donates it): active
  rows write their new K/V column, inactive rows write their own old
  value back and stay bitwise untouched. With ``kv_quant`` the attention
  read goes through :func:`bigdl_tpu_torch.ops.decode_attention.
  decode_attention` — the CUDA kernel on the card, the plain version on
  the CPU; float KV stays inline PyTorch, as the JAX step leaves it to
  XLA. The int8 grow-only scale merge stays on the device too
  (:func:`bigdl_tpu_torch.ops.kv_requant.kv_requant`, the port of the
  JAX step's ``lax.cond``), so the step reads nothing back to the host;
* :func:`make_batch_verify_step` — the speculative engine's target step:
  a per-row chunk of candidate tokens scored in one call, each row
  advanced by the draws the target confirms.

The LM's own decoder sits beside them: :func:`make_decode_step` (one
token for every row at one shared position, attention through
:func:`bigdl_tpu_torch.ops.decode_attention.decode_attention` over a
float cache), its cached twins :func:`get_decode_step` /
:func:`get_prefill_step`, and the two entry points built on them,
:func:`generate` (greedy or per-row-sampled continuation of one prompt)
and :func:`beam_generate` (beam search through
:mod:`bigdl_tpu_torch.nn.beam_search`).

Built with ``adapter=`` (an ``AdapterSpec``), each of the three steps takes
a trailing ``(adapter_ids, bank)`` pair and adds every row's pooled-LoRA
delta to the six projections of every block (:func:`_adapter_proj_fns`);
without it, each runs exactly the ops it ran before adapters existed.

Numerics follow the JAX serving conventions: projections in the serving
dtype, scores/softmax/log-softmax in f32, GELU in its tanh form (JAX's
default).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from bigdl_tpu_torch.nn.activations import LogSoftMax
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.containers import Container, Remat, Sequential
from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.misc import LookupTable
from bigdl_tpu_torch.nn.module import AbstractModule, new_param
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.params_tree import load_jax_tree


def layer_norm(x, weight, bias, eps: float):
    """Per-token LayerNorm in f32, result in the input dtype (the JAX
    spelling: f32 statistics, then ``* weight + bias`` with type
    promotion, then cast back)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mean) / torch.sqrt(var + eps)
    return (out * weight + bias).to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class LayerNorm(AbstractModule):
    """Per-token layer normalization (``transformer.py:27``)."""

    def __init__(self, hidden_size: int, eps: float = 1e-5,
                 device=None) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = new_param((hidden_size,), device, torch.nn.init.ones_)
        self.bias = new_param((hidden_size,), device, torch.nn.init.zeros_)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class PositionEmbedding(AbstractModule):
    """Learned absolute positions added to the token embeddings
    (``transformer.py:53``). With ``sp_axis`` the input is this rank's
    sequence shard of a mesh axis, and its positions start at ``index *
    T_local`` so they stay global (ring attention's causal offsets count
    the same way)."""

    def __init__(self, max_len: int, hidden_size: int,
                 sp_axis: Optional[str] = None, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.max_len = max_len
        self.hidden_size = hidden_size
        self.sp_axis = sp_axis
        self.pos = new_param((max_len, hidden_size), device,
                             lambda t: t.normal_(std=0.02,
                                                 generator=generator))

    def forward(self, x):
        T = x.shape[1]
        if self.sp_axis is None:
            return x + self.pos[:T]
        from bigdl_tpu_torch.parallel.axis import axis

        ax = axis(self.sp_axis)
        if ax.size * T > self.max_len:
            raise ValueError(f"global sequence {ax.size * T} exceeds max_len "
                             f"{self.max_len}")
        return x + self.pos[ax.index * T:(ax.index + 1) * T]


class TransformerBlock(Container):
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x))
    (``transformer.py:89``). Children in the JAX order: ln1, attn, ln2,
    fc1, fc2."""

    def __init__(self, hidden_size: int, n_heads: int, mlp_ratio: int = 4,
                 causal: bool = True, sequence_parallel: Optional[str] = None,
                 sp_axis: str = "seq", use_flash: str = "auto",
                 flash_block: Optional[int] = None, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.add(LayerNorm(hidden_size, device=device))
        self.add(MultiHeadAttention(hidden_size, n_heads, causal=causal,
                                    sequence_parallel=sequence_parallel,
                                    sp_axis=sp_axis, use_flash=use_flash,
                                    flash_block=flash_block, device=device,
                                    generator=generator))
        self.add(LayerNorm(hidden_size, device=device))
        self.add(Linear(hidden_size, mlp_ratio * hidden_size,
                        device=device, generator=generator))
        self.add(Linear(mlp_ratio * hidden_size, hidden_size,
                        device=device, generator=generator))

    # named views of the children (registered once, under their keys)
    ln1 = property(lambda self: self[0])
    attn = property(lambda self: self[1])
    ln2 = property(lambda self: self[2])
    fc1 = property(lambda self: self[3])
    fc2 = property(lambda self: self[4])

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.fc2(gelu(self.fc1(self.ln2(x))))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class ScanBlocks(Container):
    """``n_layers`` applications of one block over stacked parameters
    (``transformer.py:123``, JAX's ``lax.scan``): the template block's
    every parameter has a leading ``(n_layers,)`` axis, under JAX's child
    key, and layer i runs the template through
    ``torch.func.functional_call`` on slice i of each.

    ``layers`` (modules shaped like ``block``, one per layer) gives the
    per-layer values to stack; :func:`TransformerLM` draws them in the
    unrolled stack's generator order, so a ``layer_scan`` model holds the
    unrolled model's weights of the same seed, stacked. Without
    ``layers`` every layer starts at the template's values."""

    def __init__(self, block: AbstractModule, n_layers: int,
                 layers=None) -> None:
        super().__init__()
        if n_layers <= 0:
            raise ValueError(f"n_layers must be positive, got {n_layers}")
        self.n_layers = int(n_layers)
        layers = list(layers) if layers is not None else [block] * n_layers
        if len(layers) != self.n_layers:
            raise ValueError(f"{len(layers)} layers for n_layers "
                             f"{self.n_layers}")
        per_layer = [list(m.parameters()) for m in layers]
        with torch.no_grad():
            for j, (name, _) in enumerate(list(block.named_parameters())):
                owner, _, leaf = name.rpartition(".")
                mod = block.get_submodule(owner) if owner else block
                setattr(mod, leaf, torch.nn.Parameter(torch.stack(
                    [ps[j].detach() for ps in per_layer])))
        self.add(block)

    def unstacked_params(self, params: Optional[Dict] = None):
        """Per-layer views of a stacked params tree (this module's tree
        when ``params`` is None): the inverse of the stacking."""
        if params is None:
            params = _params_tree(self)
        stacked = params[self._child_key(0)]
        return [_tree_map(lambda a, i=i: a[i], stacked)
                for i in range(self.n_layers)]

    def forward(self, x):
        block = self[0]
        stacked = list(block.named_parameters())
        buffers = dict(block.named_buffers())
        for i in range(self.n_layers):
            x = functional_call(
                block, {**{k: t[i] for k, t in stacked}, **buffers}, (x,))
        return x


def TransformerLM(vocab_size: int, hidden_size: int = 256, n_heads: int = 8,
                  n_layers: int = 4, max_len: int = 1024,
                  mlp_ratio: int = 4, causal: bool = True,
                  remat: bool = False,
                  sequence_parallel: Optional[str] = None,
                  sp_axis: str = "seq",
                  output: str = "logprobs",
                  embed_grad_matmul: bool = False,
                  use_flash: str = "auto",
                  flash_block: Optional[int] = None,
                  layer_scan: bool = False,
                  device=None, seed: int = 0) -> Sequential:
    """GPT-style decoder LM over 1-based token ids ``(B, T)`` →
    per-position log-probs ``(B, T, vocab)`` (``transformer.py:181``).

    ``use_flash`` goes to every block's attention (``"auto"``: the flash
    kernels on the card, dense attention on the CPU; see
    :class:`bigdl_tpu_torch.nn.attention.MultiHeadAttention`), and so do
    ``sequence_parallel`` / ``sp_axis`` (the input is then this rank's
    sequence shard of the mesh axis ``sp_axis``, and the positions
    offset by its index) and ``flash_block`` (the TPU tile length:
    validated, stored, no effect on the card). The serving steps compute
    attention themselves and read none of these.

    ``remat=True`` wraps each block in :class:`~bigdl_tpu_torch.nn.
    containers.Remat` (activations recomputed in the backward);
    ``layer_scan=True`` applies one template block over stacked
    per-layer parameters (:class:`ScanBlocks`); both compose, as in JAX
    (``ScanBlocks(Remat(block))``). ``embed_grad_matmul`` computes the
    token embedding's gradient as a one-hot product
    (``LookupTable(grad_via_matmul=True)``).

    Weights are f32, made on ``device`` (default ``cuda``; raises without
    a card unless ``device="cpu"``) from a ``torch.Generator`` seeded
    with ``seed``, with the reference's init distributions, in one draw
    order whatever the knobs: the same seed gives the same weights."""
    if output not in ("logprobs", "logits"):
        raise ValueError(f"unknown output {output!r}")
    if use_flash not in ("auto", "always", "never"):
        raise ValueError(f"unknown use_flash {use_flash!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    model = Sequential()
    model.add(LookupTable(vocab_size, hidden_size, device=dev,
                          generator=gen, grad_via_matmul=embed_grad_matmul))
    model.add(PositionEmbedding(
        max_len, hidden_size, sp_axis=sp_axis if sequence_parallel else None,
        device=dev, generator=gen))

    def make_block():
        return TransformerBlock(hidden_size, n_heads, mlp_ratio, causal,
                                sequence_parallel, sp_axis,
                                use_flash=use_flash, flash_block=flash_block,
                                device=dev, generator=gen)

    blocks = [make_block() for _ in range(n_layers)]
    if layer_scan:
        tmpl = blocks[0]
        model.add(ScanBlocks(Remat(tmpl) if remat else tmpl, n_layers,
                             layers=blocks))
    else:
        for block in blocks:
            model.add(Remat(block) if remat else block)
    model.add(LayerNorm(hidden_size, device=dev))
    model.add(Linear(hidden_size, vocab_size, device=dev, generator=gen))
    if output == "logprobs":
        model.add(LogSoftMax())
    return model


def train_main(argv=None):
    """Train a TransformerLM on a synthetic (or ``-f`` text) corpus
    (``transformer.py:262``): the JAX main's corpus, model and
    ``TimeDistributedCriterion(ClassNLLCriterion())`` with Adam, through
    the shared ``run_training``. Returns the trained model."""
    from bigdl_tpu_torch.dataset.sample import Sample
    from bigdl_tpu_torch.models.utils import run_training, train_parser
    from bigdl_tpu_torch.nn.criterion import (
        ClassNLLCriterion, TimeDistributedCriterion,
    )
    from bigdl_tpu_torch.optim.optim_method import Adam

    p = train_parser("Transformer language model", batch_size=16,
                     learning_rate=3e-3, max_epoch=2)
    p.add_argument("--vocab", type=int, default=100)
    p.add_argument("--seqLen", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--remat", action="store_true")
    args = p.parse_args(argv)

    rng = np.random.default_rng(0)
    samples = []
    if args.folder:
        from bigdl_tpu_torch.dataset.text import (
            Dictionary, SequenceWindower, simple_tokenize,
        )

        with open(args.folder) as f:
            tokens = simple_tokenize(f.read())
        d = Dictionary([tokens])
        vocab = d.vocab_size()
        ids = [d.get_index(t) + 1 for t in tokens]
        for ls in SequenceWindower(args.seqLen)(iter([ids])):
            samples.append(Sample(np.asarray(ls.data, np.float32),
                                  np.asarray(ls.labels, np.float32)))
        if not samples:
            raise ValueError(f"{args.folder}: corpus shorter than --seqLen")
    else:
        vocab = args.vocab
        for _ in range(args.synthetic):
            toks = [int(rng.integers(1, vocab + 1))]
            for _ in range(args.seqLen):
                toks.append(1 + (toks[-1] + int(rng.integers(0, 3))) % vocab)
            arr = np.asarray(toks, np.float32)
            samples.append(Sample(arr[:-1], arr[1:]))

    model = TransformerLM(vocab, hidden_size=args.hidden, n_heads=args.heads,
                          n_layers=args.layers, max_len=args.seqLen,
                          remat=args.remat, device=args.device)
    crit = TimeDistributedCriterion(ClassNLLCriterion())
    return run_training(model, samples, crit, args,
                        optim_method=Adam(learning_rate=args.learningRate))


# -- carrying JAX weights across -------------------------------------------


def load_jax_params(model: AbstractModule, params_np: Dict) -> AbstractModule:
    """Fill ``model`` from a JAX params tree given as nested dicts of
    numpy arrays (``jax.device_get(lm.params)``). Container children are
    matched by the integer before the ``:`` of their key — the names
    after it carry per-instance counters and differ between two builds
    of one model. Every leaf must exist on both sides with equal shape
    (:func:`bigdl_tpu_torch.utils.params_tree.named_leaves`)."""
    return load_jax_tree(model, params_np)


# -- serving params --------------------------------------------------------


def _params_tree(m: AbstractModule) -> Dict:
    """The module's parameters as the JAX-shaped nested dict (containers
    keyed ``"{i}:{name}"``, leaves by parameter name)."""
    if isinstance(m, Container):
        return {k: _params_tree(c) for k, c in m._modules.items()}
    tree = {k: p.detach() for k, p in m.named_parameters(recurse=False)}
    for k, c in m.named_children():
        tree[k] = _params_tree(c)
    return tree


def _cast_keep_scales(tree, compute_dtype):
    """Cast float leaves to the serving dtype; ``w_scale`` leaves stay
    f32 (``transformer.py:320`` — the one copy of the serving-cast
    rule)."""
    if compute_dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: (v if k == "w_scale"
                    else _cast_keep_scales(v, compute_dtype))
                for k, v in tree.items()}
    return tree.to(compute_dtype) if tree.is_floating_point() else tree


def serving_params(model: Sequential, compute_dtype=None) -> Dict:
    """The model's params tree pre-cast for serving (``:337``): floats in
    ``compute_dtype``, detached, on the model's device."""
    return _cast_keep_scales(_params_tree(model), compute_dtype)


def _decode_head_offset(model: Sequential) -> int:
    return 1 if isinstance(model[len(model) - 1], LogSoftMax) else 0


def _layer_views(model: Sequential, Pt: Dict):
    """``[(block module, block params)]`` per layer from a params tree
    (``:355-383``): a ``Remat`` is unwrapped to its child, a
    ``ScanBlocks`` unstacked into per-layer slices of its tree."""
    keys = list(model._modules)
    out = []
    for i, m in enumerate(model.layers()):
        inner, bp = m, Pt[keys[i]]
        if isinstance(inner, Remat):
            inner, bp = inner[0], bp[inner._child_key(0)]
        if isinstance(inner, ScanBlocks):
            tmpl = inner[0]
            for lp in inner.unstacked_params(bp):
                t2, p2 = tmpl, lp
                if isinstance(t2, Remat):
                    t2, p2 = t2[0], p2[t2._child_key(0)]
                out.append((t2, p2))
            continue
        if isinstance(inner, TransformerBlock):
            out.append((inner, bp))
    return out


def _resolve_decode_views(model: Sequential, off: int, Pt: Dict):
    """``(lookup_w, pos_w, [(block, block_params)], lnf_p, lin_p)`` from
    a serving params tree; ``layer_scan`` and ``remat`` models resolve to
    per-layer views like the unrolled stack's."""
    keys = list(model._modules)
    return (Pt[keys[0]]["weight"], Pt[keys[1]]["pos"],
            _layer_views(model, Pt),
            Pt[keys[len(keys) - 2 - off]], Pt[keys[len(keys) - 1 - off]])


def _serving_proj(p, x):
    return F.linear(x, p["weight"], p.get("bias"))


def _plain_proj(p, x, site):
    return _serving_proj(p, x)


def _block_mlp(blk: TransformerBlock, bp: Dict, x, proj, layer: int):
    """``x + fc2(gelu(fc1(ln2(x))))`` on serving params; ``proj(p, h,
    site)`` is the step's projection (with the rows' LoRA delta on an
    adapted step)."""
    h2 = layer_norm(x, bp[blk._child_key(2)]["weight"],
                    bp[blk._child_key(2)]["bias"], blk.ln2.eps)
    return x + proj(bp[blk._child_key(4)], gelu(
        proj(bp[blk._child_key(3)], h2, f"fc1{layer}")), f"fc2{layer}")


# -- multi-tenant LoRA ------------------------------------------------------

#: The six adapted projections of one transformer block, in block order:
#: the layout contract with :class:`~bigdl_tpu_torch.serving.lora.
#: AdapterBank` (bank keys ``f"{site}{layer}_a"`` / ``f"{site}{layer}_b"``)
ADAPTER_SITES = ("wq", "wk", "wv", "wo", "fc1", "fc2")


def adapter_site_shapes(model: Sequential):
    """Per-layer ``{site: (out_dim, in_dim)}`` weight shapes of the six
    adapted projections (``:484``): what an AdapterBank sizes its factors
    against."""
    _, _, blocks, _, _ = _resolve_decode_views(
        model, _decode_head_offset(model), _params_tree(model))
    shapes = []
    for blk, bp in blocks:
        ap = bp[blk._child_key(1)]
        layer = {name: tuple(ap[name]["weight"].shape)
                 for name in ("wq", "wk", "wv", "wo")}
        layer["fc1"] = tuple(bp[blk._child_key(3)]["weight"].shape)
        layer["fc2"] = tuple(bp[blk._child_key(4)]["weight"].shape)
        shapes.append(layer)
    return shapes


def _lora_product(a, b, h32):
    """The per-row pooled-LoRA delta of one adapted projection (JAX's
    ``_adapter_delta``, ``:535``): ``(h @ A_r^T) @ B_r^T`` in f32 with
    ``a`` (N, r, in) and ``b`` (N, out, r) the rows' gathered factors and
    ``h32`` (N, in) or (N, S, in) the input promoted to f32, as JAX
    promotes it against the f32 bank. Bank slot 0 is the all-zero NULL
    adapter, so base-model rows get an exact 0.0. Returns the raw f32
    delta; the caller rounds once."""
    h3 = h32[:, None] if h32.dim() == 2 else h32
    d = torch.bmm(torch.bmm(h3, a.transpose(1, 2)), b.transpose(1, 2))
    return d[:, 0] if h32.dim() == 2 else d


def _gather_factors(bank, ids, site: str):
    """The rows' ``(A (N, r, in), B (N, out, r))`` factors of one site."""
    return (bank[site + "_a"].index_select(0, ids),
            bank[site + "_b"].index_select(0, ids))


class _RowFactors:
    """The rows' gathered ``(A, B)`` pairs per site, kept across calls of
    one decode or verify step while it is given the SAME ``adapter_ids``
    tensor (not modified in place) and the SAME ``bank`` dict: a gather is
    a copy, so reusing it is exact. The engine passes new objects when a
    row's adapter or the bank changes, so the steady decode loop gathers
    nothing (N rows × one slot's factors of memory). A prefill call takes
    a fresh one: its rows are new every call."""

    def __init__(self) -> None:
        self._key = None
        self._rows: Dict[str, tuple] = {}

    def get(self, bank, ids, site: str):
        key = self._key
        if (key is None or key[0] is not ids or key[1] != ids._version
                or key[2] is not bank):
            self._key = (ids, ids._version, bank)
            self._rows = {}
        got = self._rows.get(site)
        if got is None:
            got = self._rows[site] = _gather_factors(bank, ids, site)
        return got


def _adapter_proj_fns(adapter, adapter_ids, bank, device, factors):
    """``proj(p, h, site)`` for one step call (``:560``): the serving
    projection, plus the rows' LoRA delta when the step was built with an
    adapter. The delta is computed in f32, cast once to the projection's
    dtype and added in it (``y + delta``, never folded into the base
    product, whose rounding would change); wq, wk and wv share one f32
    cast of their input. ``factors`` (a :class:`_RowFactors`) gathers the
    rows' factors. The ids and the bank must live on the step's device: a
    bank elsewhere raises, it is not moved."""
    if adapter is None:
        return _plain_proj
    if adapter_ids is None or bank is None:
        raise ValueError(
            "this step was built with an adapter spec — call it with the "
            "trailing (adapter_ids, bank) pair")
    for what, t in (("adapter_ids", adapter_ids),
                    ("bank", next(iter(bank.values())))):
        if t.device != device:
            raise ValueError(
                f"{what} lives on {t.device} but the step runs on {device}")
    last = [None, None]                  # (h, its f32 cast)

    def proj(p, h, site):
        y = _serving_proj(p, h)
        if last[0] is not h:
            last[0], last[1] = h, h.float()
        a, b = factors.get(bank, adapter_ids, site)
        return y + _lora_product(a, b, last[1]).to(y.dtype)

    return proj


def _model_geometry(model: Sequential):
    mods = model.layers()
    if not isinstance(mods[0], LookupTable):
        raise TypeError("expected a TransformerLM-shaped model")
    blocks = [blk for blk, _ in _layer_views(model, _params_tree(model))]
    attn = blocks[0].attn
    off = _decode_head_offset(model)
    return dict(max_len=mods[1].max_len, vocab=mods[0].n_index, off=off,
                lnf=mods[-2 - off], n_layers=len(blocks),
                heads=attn.n_heads, hd=attn.head_dim,
                device=mods[0].weight.device)


# -- int8 KV: the grow-only per-(row, head) scale rule ---------------------
# (the rule itself, ``kv_scale_merge``, lives beside its kernel in
# :mod:`bigdl_tpu_torch.ops.kv_requant`)


def _kv_quant_merge(qc, s_old, amax_new):
    """Grow-only per-(row, head) scale merge for the int8 cache
    (``:597``). ``qc`` (R, L, H, D) int8, ``s_old``/``amax_new`` (R, H)
    f32. Returns ``(requantized NEW cache, s_new, s_safe)``; rows whose
    scale does not grow have ratio exactly 1.0 and requantize to
    themselves bitwise."""
    from bigdl_tpu_torch.ops.kv_requant import (
        kv_requant_reference, kv_scale_merge,
    )

    s_new, s_safe, ratio = kv_scale_merge(s_old, amax_new)
    return kv_requant_reference(qc, ratio), s_new, s_safe


def _kv_quant_merge_step(kc, vc, ks_old, vs_old, k_amax, v_amax):
    """Decode-step spelling of the merge (``:628``), IN PLACE on the
    pooled ``kc``/``vc``, with no read back to the host.

    The JAX step skips the full-cache requantization under ``lax.cond``
    when no scale grew. Here :func:`bigdl_tpu_torch.ops.kv_requant.
    kv_requant` does the scale rule and the requantize of both caches: on
    the card one kernel launch whose (row, head) pairs with ratio 1.0 exit
    after writing their scales (the common no-growth step touches no cache
    byte), on the CPU the unconditional merge. Both are bitwise the
    unconditional merge. Returns ``(kc, vc, ks, vs, ks_safe, vs_safe)``."""
    from bigdl_tpu_torch.ops.kv_requant import kv_requant

    return kv_requant(kc, vc, ks_old, vs_old, k_amax, v_amax)


def _kv_quantize(x32, s_safe):
    """f32 values → int8 at the given (broadcastable) safe scale."""
    return torch.clamp(torch.round(x32 / s_safe), -127, 127).to(torch.int8)


# -- the pooled carry ------------------------------------------------------


def _serving_init_carry(n_layers: int, max_len: int, heads: int, hd: int,
                        cache_dtype, kv_quant: bool, sampling: bool,
                        vocab: int, device):
    """THE pooled-carry layout (``:1123``): per-layer K/V rows + per-row
    ``pos``, int8 dequant scales on the quantized layout, and the per-row
    sampling state. The port's RNG lane is ``rng[r] = (seed, draws)``
    (int64) — see :mod:`bigdl_tpu_torch.serving.sampling`."""

    def init_carry(n_slots: int):
        carry = {"pos": torch.zeros((n_slots,), dtype=torch.int32,
                                    device=device)}
        kv_dt = torch.int8 if kv_quant else cache_dtype
        for i in range(n_layers):
            for kind in ("k", "v"):
                carry[f"{kind}{i}"] = torch.zeros(
                    (n_slots, max_len, heads, hd), dtype=kv_dt,
                    device=device)
                if kv_quant:
                    carry[f"{kind}{i}_scale"] = torch.zeros(
                        (n_slots, heads), dtype=torch.float32, device=device)
        if sampling:
            carry["rng"] = torch.zeros((n_slots, 2), dtype=torch.int64,
                                       device=device)
            carry["tok_counts"] = torch.zeros((n_slots, vocab),
                                              dtype=torch.int32,
                                              device=device)
            carry["prompt_mask"] = torch.zeros((n_slots, vocab),
                                               dtype=torch.bool,
                                               device=device)
        return carry

    return init_carry


# -- batched prefill -------------------------------------------------------


def make_batch_prefill_step(model: Sequential, compute_dtype=None,
                            kv_quant: bool = False, adapter=None):
    """Masked multi-row prompt ingestion (``:847``). Returns
    ``prefill(params, tokens, lengths, carry) -> (logprobs_last, carry)``:

    * ``tokens``: (B, L) 0-based ids on the serving device, each row
      right-padded to the bucket L (pad values are ignored);
    * ``lengths``: (B,) host ints, ``0 <= lengths[r] <= L``; zero-length
      rows are ballast — their cache, scales and ``pos`` come back
      bitwise untouched and their logprob row is garbage;
    * ``carry``: a B-row decode carry; ``carry["pos"][r]`` is row r's
      start offset, and row r writes K/V at ``pos[r]..pos[r]+len-1``.

    The input carry is never written: the new carry holds new K/V
    tensors. Pad columns never reach the cache — the scatter indexes the
    valid (row, column) pairs only, built on the host from ``lengths``
    and the start offsets (one small device→host read of ``pos``, the
    same read the JAX wrapper's guard makes). Queries attend over the
    row's full cache window under an absolute causal mask; the int8
    path attends over the dequantized cache, the values decode reads.

    ``adapter`` (a :class:`~bigdl_tpu_torch.serving.lora.AdapterSpec`)
    makes the signature ``prefill(params, tokens, lengths, carry,
    adapter_ids, bank)``: ``adapter_ids`` (B,) int64 per-ROW bank slots on
    the device (0 = the null adapter) and ``bank`` the AdapterBank's
    ``device_arrays``; the six projections of every block add the rows'
    LoRA delta."""
    rows = _prefill_rows(model, compute_dtype, kv_quant, adapter)
    max_len = rows.max_len

    def prefill(params, tokens, lengths, carry, *adapter_args):
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be (B, L), got {tuple(tokens.shape)}")
        B, L = tokens.shape
        ln = np.asarray(lengths, np.int64)
        if ln.shape != (B,):
            raise ValueError(f"lengths must be ({B},), got {ln.shape}")
        if carry["pos"].shape[0] != B:
            raise ValueError(
                f"carry has {carry['pos'].shape[0]} rows but tokens has {B}")
        start_h = carry["pos"].cpu().numpy().astype(np.int64)
        if (ln < 0).any() or (ln > L).any():
            raise ValueError(f"lengths must lie in 0..L={L} (got {ln.tolist()})")
        if (start_h + ln > max_len).any():
            raise ValueError(
                f"rows would write past max_len {max_len}: "
                f"pos={start_h.tolist()} + lengths={ln.tolist()}")
        if len(adapter_args) != (0 if adapter is None else 2):
            raise ValueError(
                "a prefill step built with an adapter spec takes the "
                "trailing (adapter_ids, bank) pair, one without takes none")
        return rows(params, tokens, ln, start_h, carry, *adapter_args)

    return prefill


def make_prefill_step(model: Sequential, compute_dtype=None,
                      kv_quant: bool = False):
    """One-pass prompt ingestion into a FRESH carry (``:685``), the
    per-request admission step. Returns ``prefill(params, tokens, carry)
    -> (logprobs_last, carry)``:

    * ``tokens``: (B, P) 0-based ids, P <= max_len, every row a full
      prompt of length P (no per-row lengths: ragged batches go through
      :func:`make_batch_prefill_step`);
    * ``carry`` must be fresh (``pos == 0`` in every row, as
      ``init_carry`` builds it): K/V land at positions 0..P-1 and ``pos``
      becomes P. A non-zero ``pos`` raises (one small read of ``pos``,
      the JAX wrapper's guard).

    It shares :func:`make_batch_prefill_step`'s layer loop with every
    length P; on the int8 layout a fresh carry makes the write the
    one-shot case of the grow-only scale merge (the old scale is 0, so
    the prompt's amax sets it). The input carry is never written."""
    rows = _prefill_rows(model, compute_dtype, kv_quant)

    def prefill(params, tokens, carry):
        if tokens.dim() != 2:
            raise ValueError(f"tokens must be (B, P), got {tuple(tokens.shape)}")
        B, P = tokens.shape
        if P > rows.max_len:
            raise ValueError(
                f"prompt length {P} exceeds max_len {rows.max_len}")
        start_h = carry["pos"].cpu().numpy().astype(np.int64)
        if start_h.shape != (B,) or start_h.any():
            raise ValueError(
                "make_prefill_step requires a fresh carry (carry['pos'] "
                "must be all zeros, one row per prompt): prefill writes "
                "K/V at positions 0..P-1 and resets pos, which would "
                "corrupt a partially filled cache (got pos="
                f"{start_h.tolist()})")
        return rows(params, tokens, np.full((B,), P, np.int64), start_h,
                    carry)

    return prefill


def _prefill_rows(model: Sequential, compute_dtype, kv_quant: bool,
                  adapter=None):
    """The layer loop both prefill steps share: ``rows(params, tokens,
    ln, start_h, carry[, adapter_ids, bank])`` with the per-row lengths
    and start offsets already checked, as host int64 arrays."""
    g = _model_geometry(model)
    max_len, off, lnf = g["max_len"], g["off"], g["lnf"]
    heads, hd = g["heads"], g["hd"]
    scale = hd ** -0.5
    cache_dtype = compute_dtype or torch.float32

    def rows(params, tokens, ln, start_h, carry, adapter_ids=None,
             bank=None):
        lookup_w, pos_w, blocks, lnf_p, lin_p = \
            _resolve_decode_views(model, off, params)
        B, L = tokens.shape
        dev = tokens.device
        proj = _adapter_proj_fns(adapter, adapter_ids, bank, dev,
                                 _RowFactors())
        r_h = np.repeat(np.arange(B), ln)
        c_h = np.concatenate([np.arange(n) for n in ln]) if B else r_h
        r_idx = torch.as_tensor(r_h, device=dev)
        c_idx = torch.as_tensor(c_h, dtype=torch.int64, device=dev)
        w_idx = torch.as_tensor(start_h[r_h] + c_h, dtype=torch.int64,
                                device=dev)
        lengths_t = torch.as_tensor(ln, device=dev)
        start = carry["pos"]
        qpos = start.long()[:, None] + torch.arange(L, device=dev)[None]
        inb = torch.arange(L, device=dev)[None] < lengths_t[:, None]
        x = lookup_w[tokens.long().clamp(0, lookup_w.shape[0] - 1)]
        x = x + pos_w[qpos.clamp(0, max_len - 1)]
        valid = (torch.arange(max_len, device=dev)[None, None, None, :]
                 <= qpos[:, None, :, None])
        new_carry = dict(carry)
        for i, (blk, bp) in enumerate(blocks):
            lp = bp[blk._child_key(0)]
            h = layer_norm(x, lp["weight"], lp["bias"], blk.ln1.eps)
            ap = bp[blk._child_key(1)]
            q = proj(ap["wq"], h, f"wq{i}").reshape(B, L, heads, hd)
            k = proj(ap["wk"], h, f"wk{i}").reshape(B, L, heads, hd)
            v = proj(ap["wv"], h, f"wv{i}").reshape(B, L, heads, hd)
            if kv_quant:
                # amax over the VALID columns only, grow-only merge with
                # the cached prefix's scale, then the valid-pair scatter
                k32, v32 = k.float(), v.float()
                inbf = inb[:, :, None, None]
                kc, ks_new, ks_safe = _kv_quant_merge(
                    carry[f"k{i}"], carry[f"k{i}_scale"],
                    (k32.abs() * inbf).amax(dim=(1, 3)))
                vc, vs_new, vs_safe = _kv_quant_merge(
                    carry[f"v{i}"], carry[f"v{i}_scale"],
                    (v32.abs() * inbf).amax(dim=(1, 3)))
                kq = _kv_quantize(k32, ks_safe[:, None, :, None])
                vq = _kv_quantize(v32, vs_safe[:, None, :, None])
                kc[r_idx, w_idx] = kq[r_idx, c_idx]
                vc[r_idx, w_idx] = vq[r_idx, c_idx]
                new_carry[f"k{i}_scale"] = ks_new
                new_carry[f"v{i}_scale"] = vs_new
                katt = kc.float() * ks_new[:, None, :, None]
                vatt = vc.float() * vs_new[:, None, :, None]
                qatt = (q * scale).float()
                p_dt = torch.float32
            else:
                kc = carry[f"k{i}"].clone()
                vc = carry[f"v{i}"].clone()
                kc[r_idx, w_idx] = k[r_idx, c_idx].to(cache_dtype)
                vc[r_idx, w_idx] = v[r_idx, c_idx].to(cache_dtype)
                katt, vatt = kc, vc
                qatt = (q * scale).to(cache_dtype)
                p_dt = cache_dtype
            new_carry[f"k{i}"], new_carry[f"v{i}"] = kc, vc
            s = torch.einsum("blhd,bmhd->bhlm", qatt.float(), katt.float())
            p = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
            ctx = torch.einsum("bhlm,bmhd->blhd", p.to(p_dt).float(),
                               vatt.float()).to(x.dtype)
            x = x + proj(ap["wo"], ctx.reshape(B, L, heads * hd), f"wo{i}")
            x = _block_mlp(blk, bp, x, proj, i)
        # each row's next-token logits come from its LAST VALID position
        last = (lengths_t - 1).clamp(0, L - 1)
        xf = layer_norm(x[torch.arange(B, device=dev), last],
                        lnf_p["weight"], lnf_p["bias"], lnf.eps)
        logits = _serving_proj(lin_p, xf)
        new_carry["pos"] = (start + lengths_t).to(start.dtype)
        return torch.log_softmax(logits.float(), dim=-1), new_carry

    rows.max_len = max_len
    return rows


# -- pooled per-row decode -------------------------------------------------


def make_batch_decode_step(model: Sequential, compute_dtype=None,
                           sampling: bool = False, kv_quant: bool = False,
                           adapter=None):
    """Per-row-position decode step for continuous batching (``:1333``).
    Returns ``(step_fn, init_carry)``:

    * ``init_carry(n_slots)`` — the pooled carry on the model's device;
    * ``step_fn(params, tokens, active, carry) -> (logprobs, carry)`` —
      ``tokens`` (N,) 0-based ids, ``active`` (N,) bool, both on the
      device. Active rows write K/V at their own ``pos[r]``, attend over
      ``0..pos[r]`` of their own row and advance ``pos[r]``; inactive
      rows are ballast, bitwise untouched. The carry is updated IN PLACE
      and returned;
    * ``sampling=True``: ``step_fn(params, tokens, active, carry, knobs)
      -> (token, chosen_logp, carry)`` with the per-row sampler fused in
      (:func:`bigdl_tpu_torch.serving.sampling.sample_rows`); inactive
      rows' lanes and counts stay untouched too.

    ``kv_quant=True`` stores K/V as int8 with one f32 scale per
    (slot, head) and reads them through the pooled decode-attention op
    (the CUDA kernel on the card); a scale that grows requantizes its
    row through the kv_requant op. The step makes no device→host read:
    its outputs can feed the next step on the device.

    ``adapter`` (a :class:`~bigdl_tpu_torch.serving.lora.AdapterSpec`)
    adds a trailing ``(adapter_ids, bank)`` pair to ``step_fn``:
    ``adapter_ids`` (N,) int64 per-slot bank slots on the device, ``bank``
    the AdapterBank's ``device_arrays``. Every block's six projections add
    the rows' LoRA delta (bank slot 0 is all zeros, so null-adapter rows
    add an exact 0.0). The rows' gathered factors are reused across calls
    given the same ``adapter_ids`` tensor and ``bank`` dict
    (:class:`_RowFactors`)."""
    from bigdl_tpu_torch.ops.decode_attention import decode_attention

    g = _model_geometry(model)
    max_len, vocab, off, lnf = g["max_len"], g["vocab"], g["off"], g["lnf"]
    heads, hd = g["heads"], g["hd"]
    scale = hd ** -0.5
    cache_dtype = compute_dtype or torch.float32
    init_carry = _serving_init_carry(g["n_layers"], max_len, heads, hd,
                                     cache_dtype, kv_quant, sampling, vocab,
                                     g["device"])

    factors = _RowFactors()

    def forward(params, tokens, active, carry, adapter_ids=None, bank=None):
        lookup_w, pos_w, blocks, lnf_p, lin_p = \
            _resolve_decode_views(model, off, params)
        n = tokens.shape[0]
        dev = tokens.device
        proj = _adapter_proj_fns(adapter, adapter_ids, bank, dev, factors)
        rows = torch.arange(n, device=dev)
        wpos = carry["pos"].long().clamp(0, max_len - 1)   # write index
        x = lookup_w[tokens.long().clamp(0, lookup_w.shape[0] - 1)]
        x = x + pos_w[wpos]
        act = active[:, None, None]
        for i, (blk, bp) in enumerate(blocks):
            lp = bp[blk._child_key(0)]
            h = layer_norm(x, lp["weight"], lp["bias"], blk.ln1.eps)
            ap = bp[blk._child_key(1)]
            q = proj(ap["wq"], h, f"wq{i}").reshape(n, heads, hd)
            k_new = proj(ap["wk"], h, f"wk{i}").reshape(n, heads, hd)
            v_new = proj(ap["wv"], h, f"wv{i}").reshape(n, heads, hd)
            kc, vc = carry[f"k{i}"], carry[f"v{i}"]
            if kv_quant:
                # inactive rows have amax 0: scale, stored values and the
                # written-back old value all stay bitwise untouched
                k32, v32 = k_new.float(), v_new.float()
                k_amax = torch.where(active[:, None], k32.abs().amax(-1), 0.0)
                v_amax = torch.where(active[:, None], v32.abs().amax(-1), 0.0)
                kc, vc, ks_new, vs_new, ks_safe, vs_safe = \
                    _kv_quant_merge_step(kc, vc, carry[f"k{i}_scale"],
                                         carry[f"v{i}_scale"], k_amax,
                                         v_amax)
                k_wr0 = _kv_quantize(k32, ks_safe[..., None])
                v_wr0 = _kv_quantize(v32, vs_safe[..., None])
                carry[f"k{i}_scale"] = ks_new
                carry[f"v{i}_scale"] = vs_new
            else:
                k_wr0 = k_new.to(cache_dtype)
                v_wr0 = v_new.to(cache_dtype)
            # masked per-row write: inactive rows write their OLD value
            kc[rows, wpos] = torch.where(act, k_wr0, kc[rows, wpos])
            vc[rows, wpos] = torch.where(act, v_wr0, vc[rows, wpos])
            if kv_quant:
                ctx = decode_attention(q, kc, vc, wpos, k_scale=ks_new,
                                       v_scale=vs_new, scale=scale,
                                       out_dtype=x.dtype)
            else:
                s = torch.einsum("nhd,nlhd->nhl",
                                 (q * scale).to(cache_dtype).float(),
                                 kc.float())
                valid = (torch.arange(max_len, device=dev)[None, None, :]
                         <= wpos[:, None, None])
                p = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
                ctx = torch.einsum("nhl,nlhd->nhd",
                                   p.to(cache_dtype).float(),
                                   vc.float()).to(x.dtype)
            x = x + proj(ap["wo"], ctx.reshape(n, heads * hd), f"wo{i}")
            x = _block_mlp(blk, bp, x, proj, i)
        xf = layer_norm(x, lnf_p["weight"], lnf_p["bias"], lnf.eps)
        logits = _serving_proj(lin_p, xf)
        carry["pos"] += active.to(carry["pos"].dtype)
        return torch.log_softmax(logits.float(), dim=-1), carry

    def sample_step(params, tokens, active, carry, knobs, adapter_ids=None,
                    bank=None):
        from bigdl_tpu_torch.serving.sampling import sample_rows

        logp, carry = forward(params, tokens, active, carry, adapter_ids,
                              bank)
        tok, chosen, new_keys, new_counts = sample_rows(
            logp, carry["rng"], knobs, carry["tok_counts"],
            carry["prompt_mask"])
        a = active[:, None]
        carry["rng"] = torch.where(a, new_keys, carry["rng"])
        carry["tok_counts"] = torch.where(a, new_counts, carry["tok_counts"])
        return tok, chosen, carry

    return (sample_step if sampling else forward), init_carry


# -- speculative verify ----------------------------------------------------


def _write_cols(dst, rows, cols, mask, vals):
    """``dst[r, cols[r, j]] = vals[r, j]`` where ``mask[r, j]``, one chunk
    column ``j`` at a time: each write's (row, column) pairs are distinct,
    and a masked-off pair writes back the value it reads, so a column
    clamped onto another one's position leaves it as that one wrote it."""
    shape = (-1,) + (1,) * (vals.dim() - 2)
    for j in range(cols.shape[1]):
        idx = cols[:, j]
        dst[rows, idx] = torch.where(mask[:, j].view(shape),
                                     vals[:, j].to(dst.dtype),
                                     dst[rows, idx])


def make_batch_verify_step(model: Sequential, compute_dtype=None,
                           width: int = 4, kv_quant: bool = False,
                           adapter=None):
    """The speculative engine's target step (``:1648``): one call scores a
    per-row CHUNK of candidate tokens and advances each row by the draws
    the target confirms. Returns ``(verify_fn, init_carry)``;
    ``init_carry`` builds the :func:`make_batch_decode_step`
    ``sampling=True`` carry (one layout: a pool built by either serves
    the other).

    ``verify_fn(params, tokens, lengths, carry, knobs) -> (tokens_out,
    logps_out, n_emit, carry)``:

    * ``tokens``: (N, ``width``) 0-based ids on the device — column 0 is
      row r's current decode input, columns ``1..lengths[r]-1`` its draft
      proposals, later columns pad the step never reads;
    * ``lengths``: (N,) ints on the device, ``0 <= lengths[r] <=
      width`` — chunk positions row r runs. ``lengths[r] == 1`` is the
      plain sampled decode step; ``0`` is ballast (carry bitwise
      untouched, outputs garbage);
    * ``tokens_out``/``logps_out``: (N, width) — position j's draw by the
      one per-row sampler (:func:`bigdl_tpu_torch.serving.sampling.
      sample_rows`) from the target's distribution after chunk inputs
      ``0..j``, the row's lane and penalty counts advanced once per
      position in order, as the plain step would draw them had the
      accepted prefix been fed token by token;
    * ``n_emit``: (N,) int32 — ``1 +`` the leading positions whose draw
      equals the next chunk input (sampled-token agreement; greedy rows:
      argmax agreement), 0 for ballast rows.

    Rollback is pointer arithmetic: K/V of all ``lengths[r]`` inputs are
    written at ``pos[r]..``, but ``pos``, the lane and the counts advance
    by ``n_emit[r]`` only; positions past the accepted prefix are stale
    bytes behind ``pos``. The carry is updated IN PLACE and returned, as
    the decode step's is. Attention is plain PyTorch over the cache (the
    JAX verify step reaches no Pallas kernel either).

    ``kv_quant``: the chunk attends over the stored cache dequantized at
    its CURRENT scales with the chunk's own float K/V laid over it; the
    grow-only scale merge and the quantized write are deferred until
    ``n_emit`` is known and cover the EMITTED columns only (the requantize
    through :func:`bigdl_tpu_torch.ops.kv_requant.kv_requant`), so a
    rejected draft touches neither a row's scales nor its stored bytes.

    ``adapter`` follows :func:`make_batch_decode_step`: a trailing
    ``(adapter_ids, bank)`` pair, and every chunk position of a row runs
    under that row's adapter (the engine pins adapted rows to chunks of
    one: drafts come from a model with no adapter).

    Caller contract (the engine keeps it): ``pos[r] + lengths[r] <=
    max_len``."""
    from bigdl_tpu_torch.serving.sampling import sample_rows

    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    g = _model_geometry(model)
    max_len, vocab, off, lnf = g["max_len"], g["vocab"], g["off"], g["lnf"]
    heads, hd = g["heads"], g["hd"]
    scale = hd ** -0.5
    cache_dtype = compute_dtype or torch.float32
    S = int(width)
    init_carry = _serving_init_carry(g["n_layers"], max_len, heads, hd,
                                     cache_dtype, kv_quant, True, vocab,
                                     g["device"])

    factors = _RowFactors()

    def verify(params, tokens, lengths, carry, knobs, adapter_ids=None,
               bank=None):
        lookup_w, pos_w, blocks, lnf_p, lin_p = \
            _resolve_decode_views(model, off, params)
        N = tokens.shape[0]
        dev = tokens.device
        proj = _adapter_proj_fns(adapter, adapter_ids, bank, dev, factors)
        rows = torch.arange(N, device=dev)
        cols = torch.arange(S, device=dev)
        lengths = lengths.long()
        qpos = carry["pos"].long()[:, None] + cols[None]      # (N, S)
        inb = cols[None] < lengths[:, None]
        wcol = qpos.clamp(max=max_len - 1)
        x = lookup_w[tokens.long().clamp(0, lookup_w.shape[0] - 1)]
        x = x + pos_w[wcol.clamp(min=0)]
        valid = (torch.arange(max_len, device=dev)[None, None, None, :]
                 <= qpos[:, None, :, None])
        chunk_kv = []            # per-layer float chunk K/V (int8 path)
        for i, (blk, bp) in enumerate(blocks):
            lp = bp[blk._child_key(0)]
            h = layer_norm(x, lp["weight"], lp["bias"], blk.ln1.eps)
            ap = bp[blk._child_key(1)]
            q = proj(ap["wq"], h, f"wq{i}").reshape(N, S, heads, hd)
            k = proj(ap["wk"], h, f"wk{i}").reshape(N, S, heads, hd)
            v = proj(ap["wv"], h, f"wv{i}").reshape(N, S, heads, hd)
            if kv_quant:
                k32, v32 = k.float(), v.float()
                katt = (carry[f"k{i}"].float()
                        * carry[f"k{i}_scale"][:, None, :, None])
                vatt = (carry[f"v{i}"].float()
                        * carry[f"v{i}_scale"][:, None, :, None])
                _write_cols(katt, rows, wcol, inb, k32)
                _write_cols(vatt, rows, wcol, inb, v32)
                qatt = (q * scale).float()
                p_dt = torch.float32
                chunk_kv.append((k32, v32))
            else:
                katt, vatt = carry[f"k{i}"], carry[f"v{i}"]
                _write_cols(katt, rows, wcol, inb, k)
                _write_cols(vatt, rows, wcol, inb, v)
                qatt = (q * scale).to(cache_dtype)
                p_dt = cache_dtype
            s = torch.einsum("blhd,bmhd->bhlm", qatt.float(), katt.float())
            p = torch.softmax(torch.where(valid, s, -1e30), dim=-1)
            ctx = torch.einsum("bhlm,bmhd->blhd", p.to(p_dt).float(),
                               vatt.float()).to(x.dtype)
            x = x + proj(ap["wo"], ctx.reshape(N, S, heads * hd), f"wo{i}")
            x = _block_mlp(blk, bp, x, proj, i)
        # EVERY position's next-token distribution
        xf = layer_norm(x, lnf_p["weight"], lnf_p["bias"], lnf.eps)
        logp = torch.log_softmax(_serving_proj(lin_p, xf).float(), dim=-1)
        # sequential per-position draws through the one sampler: the lane
        # and the counts advance once per position, in order
        keys, counts = carry["rng"], carry["tok_counts"]
        toks_out, lps_out = [], []
        for j in range(S):
            t_j, lp_j, keys, counts = sample_rows(
                logp[:, j], keys, knobs, counts, carry["prompt_mask"])
            toks_out.append(t_j)
            lps_out.append(lp_j)
        s_tok = torch.stack(toks_out, dim=1)                   # (N, S)
        s_lp = torch.stack(lps_out, dim=1)
        # acceptance: position j emits iff every draft before it matched
        # the draw before it; the first mismatch still emits
        if S > 1:
            match = s_tok[:, :-1] == tokens[:, 1:].long()
            has_draft = cols[None, 1:] < lengths[:, None]
            n_acc = torch.cumprod((match & has_draft).long(), dim=1).sum(1)
        else:
            n_acc = torch.zeros((N,), dtype=torch.int64, device=dev)
        active = lengths > 0
        n_emit = torch.where(active, n_acc + 1, 0)
        if kv_quant:
            # the deferred accepted-only int8 commit
            emit = cols[None] < n_emit[:, None]                # (N, S)
            emitf = emit[:, :, None, None]
            for i, (k32, v32) in enumerate(chunk_kv):
                kc, vc, ks, vs, ks_safe, vs_safe = _kv_quant_merge_step(
                    carry[f"k{i}"], carry[f"v{i}"], carry[f"k{i}_scale"],
                    carry[f"v{i}_scale"],
                    (k32.abs() * emitf).amax(dim=(1, 3)),
                    (v32.abs() * emitf).amax(dim=(1, 3)))
                _write_cols(kc, rows, wcol, emit,
                            _kv_quantize(k32, ks_safe[:, None, :, None]))
                _write_cols(vc, rows, wcol, emit,
                            _kv_quantize(v32, vs_safe[:, None, :, None]))
                carry[f"k{i}_scale"] = ks
                carry[f"v{i}_scale"] = vs
        # lane and counts advance by exactly n_emit draws; inactive rows
        # add nothing
        lanes = carry["rng"].clone()
        lanes[:, 1] += n_emit
        carry["rng"] = lanes
        for j in range(S):
            carry["tok_counts"].index_put_(
                (rows, s_tok[:, j]), (j < n_emit).to(torch.int32),
                accumulate=True)
        carry["pos"] += n_emit.to(carry["pos"].dtype)
        return s_tok, s_lp, n_emit.to(torch.int32), carry

    return verify, init_carry


# -- the LM's own KV-cached decoder ----------------------------------------


def make_decode_step(model: Sequential, compute_dtype=None):
    """KV-cached incremental decoding of a :func:`TransformerLM`
    (``:1159``). Returns ``(step_fn, init_carry)``:

    * ``init_carry(batch)`` — per-layer K/V caches ``(batch, max_len,
      heads, head_dim)`` in the cache dtype (``compute_dtype``, default
      f32) plus ``pos`` (batch,) int32, on the model's device: the
      pooled carry's float layout (:func:`_serving_init_carry`) without
      sampling state;
    * ``step_fn(params, tokens, carry) -> (logprobs, carry)`` — ``tokens``
      (N,) 0-based ids (logit column c is 1-based word id c + 1); every
      row writes its K/V at the SHARED position ``pos`` (uniform across
      rows, as beam search needs), attends over ``0..pos`` and advances
      ``pos``. ``params`` is a :func:`serving_params` tree, or None for
      the model's own weights cast to ``compute_dtype``. The carry is
      updated IN PLACE and returned; the step reads nothing back to the
      host.

    Attention goes through :func:`bigdl_tpu_torch.ops.decode_attention.
    decode_attention`: the CUDA kernel on a card tensor, its plain version
    on a CPU tensor. The query is scaled and cast to the cache dtype
    before the op, as the JAX step does; projections run in the serving
    dtype, scores, softmax and the final log-softmax in f32."""
    from bigdl_tpu_torch.ops.decode_attention import decode_attention

    g = _model_geometry(model)
    max_len, vocab, off, lnf = g["max_len"], g["vocab"], g["off"], g["lnf"]
    heads, hd = g["heads"], g["hd"]
    scale = hd ** -0.5
    cache_dtype = compute_dtype or torch.float32
    init_carry = _serving_init_carry(g["n_layers"], max_len, heads, hd,
                                     cache_dtype, False, False, vocab,
                                     g["device"])
    own: list = []                 # the model's serving params, built once

    def step(params, tokens, carry):
        if params is None:
            if not own:
                own.append(serving_params(model, compute_dtype))
            params = own[0]
        lookup_w, pos_w, blocks, lnf_p, lin_p = \
            _resolve_decode_views(model, off, params)
        n = tokens.shape[0]
        pos = carry["pos"]
        t = pos[:1].long().clamp(0, max_len - 1)       # uniform across rows
        x = lookup_w[tokens.long().clamp(0, lookup_w.shape[0] - 1)]
        x = x + pos_w.index_select(0, t)
        for i, (blk, bp) in enumerate(blocks):
            lp = bp[blk._child_key(0)]
            h = layer_norm(x, lp["weight"], lp["bias"], blk.ln1.eps)
            ap = bp[blk._child_key(1)]
            q = _serving_proj(ap["wq"], h).reshape(n, heads, hd)
            k_new = _serving_proj(ap["wk"], h).reshape(n, heads, hd)
            v_new = _serving_proj(ap["wv"], h).reshape(n, heads, hd)
            kc, vc = carry[f"k{i}"], carry[f"v{i}"]
            kc.index_copy_(1, t, k_new[:, None].to(cache_dtype))
            vc.index_copy_(1, t, v_new[:, None].to(cache_dtype))
            ctx = decode_attention((q * scale).to(cache_dtype), kc, vc, pos,
                                   scale=1.0, out_dtype=x.dtype)
            x = x + _serving_proj(ap["wo"], ctx.reshape(n, heads * hd))
            x = _block_mlp(blk, bp, x, _plain_proj, i)
        xf = layer_norm(x, lnf_p["weight"], lnf_p["bias"], lnf.eps)
        logits = _serving_proj(lin_p, xf)
        carry["pos"] = pos + 1
        return torch.log_softmax(logits.float(), dim=-1), carry

    return step, init_carry


def _step_cache(model: Sequential, kind: str, compute_dtype, make,
                extra=None):
    """The built step for ``(model, kind, compute_dtype[, extra])``, built
    once (``:2005``). The cache lives on the model, so it goes with it; a copy
    of the model (whose dict holds the same steps, built over the
    original) starts its own. Assumes the model's architecture is frozen
    after first use (weights ride as runtime arguments)."""
    owner, per_model = model.__dict__.get("_serving_steps", (None, None))
    if owner != id(model):
        per_model = {}
        model.__dict__["_serving_steps"] = (id(model), per_model)
    key = (kind, None if compute_dtype is None else str(compute_dtype))
    if extra is not None:
        key = key + (extra,)
    if key not in per_model:
        per_model[key] = make()
    return per_model[key]


def get_decode_step(model: Sequential, compute_dtype=None):
    """Cached :func:`make_decode_step`: the same ``(step, init_carry)``
    for repeated calls with one (model, compute_dtype)."""
    return _step_cache(model, "decode", compute_dtype,
                       lambda: make_decode_step(model, compute_dtype))


def get_prefill_step(model: Sequential, compute_dtype=None,
                     kv_quant: bool = False):
    """Cached :func:`make_prefill_step`; ``kv_quant`` selects the variant
    that writes int8 KV, its own cache entry (its carry differs)."""
    return _step_cache(model, "prefill", compute_dtype,
                       lambda: make_prefill_step(model, compute_dtype,
                                                 kv_quant=kv_quant),
                       extra="int8" if kv_quant else None)


def _primed_carry(model: Sequential, compute_dtype, prompt, rows: int,
                  what: str, n_new: int):
    """``(step, params, carry)`` with ``prompt[:-1]`` (1-based ids)
    prefilled into ``rows`` identical rows in one pass, after the guards
    every entry point shares: a non-empty prompt, and ``len(prompt) - 1 +
    n_new <= max_len`` (past it the cache position would clamp)."""
    if not prompt:
        raise ValueError("need a non-empty prompt")
    max_len = model[1].max_len
    if len(prompt) - 1 + n_new > max_len:
        raise ValueError(
            f"prompt ({len(prompt)}) + {what} ({n_new}) exceeds the "
            f"model's max_len {max_len} — the cache position would "
            "silently clamp (same guard as PositionEmbedding)")
    step, init_carry = get_decode_step(model, compute_dtype)
    params = serving_params(model, compute_dtype)
    carry = init_carry(rows)
    if len(prompt) > 1:
        prefill = get_prefill_step(model, compute_dtype)
        ptoks = torch.tensor([[t - 1 for t in prompt[:-1]]] * rows,
                             dtype=torch.int64, device=model[0].weight.device)
        _, carry = prefill(params, ptoks, carry)
    return step, params, carry


def generate(model: Sequential, prompt_ids, length: int = 32,
             temperature: float = 1.0, top_k: int = 0, seed: int = 0,
             compute_dtype=None, sampling=None, return_logprobs=False):
    """Greedy or sampled continuation of ONE prompt with the KV-cached
    decoder (``:2180``). ``prompt_ids`` are 1-based; returns (n,) 1-based
    ids (n == ``length`` unless a stop set ends the run), or ``(ids,
    logprobs)`` with ``return_logprobs`` (the chosen tokens' raw model
    log-probs).

    ``temperature=0`` is greedy argmax, ``top_k > 0`` keeps the k most
    likely tokens; ``sampling`` (a :class:`~bigdl_tpu_torch.serving.
    sampling.SamplingParams`) overrides the three scalars. The draw runs
    through the serving engine's per-row sampler (:func:`~bigdl_tpu_torch.
    serving.sampling.sample_rows`, one row) from the lane
    ``lane_key(seed)``, so a fixed seed gives the engine's stream for the
    same request. ``compute_dtype`` is the serving precision."""
    from bigdl_tpu_torch.serving.sampling import (
        SamplingParams, knob_row_values, lane_key, match_stop_sequences,
        sample_rows,
    )

    sp = sampling if sampling is not None else SamplingParams(
        temperature=temperature, top_k=top_k, seed=seed)
    if sp.max_tokens is not None:
        length = sp.max_tokens
    prompt = [int(t) for t in prompt_ids]
    step, params, carry = _primed_carry(model, compute_dtype, prompt, 1,
                                        "length", length)
    dev = model[0].weight.device
    vocab = model[0].n_index
    # the engine's one-row knob layout
    scal, ban_row = knob_row_values(sp, -1)
    ban_base = bool(scal["ban"])
    knobs = {k: torch.from_numpy(np.asarray([v])).to(dev)
             for k, v in scal.items()}
    knobs["ban_ids"] = torch.from_numpy(ban_row[None]).to(dev)
    knobs["ban"] = torch.zeros((1,), dtype=torch.bool, device=dev)
    counts = torch.zeros((1, vocab), dtype=torch.int32, device=dev)
    pmask = np.zeros((1, vocab), bool)
    pmask[0, np.clip(np.asarray(prompt) - 1, 0, vocab - 1)] = True
    pmask = torch.from_numpy(pmask).to(dev)
    keys = torch.from_numpy(
        lane_key(sp.seed if sp.seed is not None else seed)[None]).to(dev)
    tok = torch.tensor([prompt[-1] - 1], dtype=torch.int64, device=dev)
    out, lps = [], []
    with torch.no_grad():
        for i in range(length):
            logp, carry = step(params, tok, carry)
            if ban_base:
                knobs["ban"] = torch.tensor([i < sp.min_tokens], device=dev)
            tok, chosen, keys, counts = sample_rows(logp, keys, knobs,
                                                    counts, pmask)
            t1 = int(tok[0]) + 1                 # back to 1-based ids
            out.append(t1)
            lps.append(float(chosen[0]))
            if len(out) >= sp.min_tokens and (
                    t1 in sp.stop_token_ids
                    or match_stop_sequences(out, sp.stop_sequences)):
                break
    ids = np.asarray(out, np.int32)
    if return_logprobs:
        return ids, np.asarray(lps, np.float32)
    return ids


def beam_generate(model: Sequential, prompt_ids, beam_size: int = 4,
                  decode_length: int = 32, eos_id: int = -1,
                  alpha: float = 0.6, compute_dtype=None):
    """Beam-search continuation of ONE prompt with the KV-cached decoder
    (``:2130``). Returns ``(sequences (beam, decode_length) of 1-based
    ids, scores (beam,))`` as numpy arrays, best first; positions after
    an eos come back as 0. ``eos_id`` is 1-based, -1 for none; ``alpha``
    the length penalty's exponent. The prompt is prefilled once into all
    ``beam_size`` rows."""
    from bigdl_tpu_torch.nn.beam_search import beam_search

    prompt = [int(t) for t in prompt_ids]
    step, params, carry = _primed_carry(model, compute_dtype, prompt,
                                        beam_size, "decode_length",
                                        decode_length)
    vocab = model[0].n_index
    with torch.no_grad():
        seqs, scores = beam_search(
            step, params, carry, 1, beam_size, vocab, decode_length,
            sos_id=prompt[-1] - 1,
            eos_id=(eos_id - 1) if eos_id > 0 else vocab + 7,
            alpha=alpha, padding_value=-1)
    return (seqs[0].cpu().numpy().astype(np.int32) + 1,
            scores[0].cpu().numpy())


if __name__ == "__main__":
    train_main()
