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
  input carry, so one zero carry can serve every admission;
* :func:`make_batch_decode_step` — one token for every pooled row at its
  own position, with the fused per-row sampler when ``sampling=True``.
  It updates the pooled carry IN PLACE (the JAX step donates it): active
  rows write their new K/V column, inactive rows write their own old
  value back and stay bitwise untouched. With ``kv_quant`` the attention
  read goes through :func:`bigdl_tpu_torch.ops.decode_attention.
  decode_attention` — the CUDA kernel on the card, the plain version on
  the CPU; float KV stays inline PyTorch, as the JAX step leaves it to
  XLA.

Numerics follow the JAX serving conventions: projections in the serving
dtype, scores/softmax/log-softmax in f32, GELU in its tanh form (JAX's
default).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.activations import LogSoftMax
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.containers import Container, Sequential
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
    (``transformer.py:53``; sequence parallelism waits)."""

    def __init__(self, max_len: int, hidden_size: int, device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.max_len = max_len
        self.hidden_size = hidden_size
        self.pos = new_param((max_len, hidden_size), device,
                             lambda t: t.normal_(std=0.02,
                                                 generator=generator))

    def forward(self, x):
        return x + self.pos[:x.shape[1]]


class TransformerBlock(Container):
    """Pre-norm block: x + MHA(LN(x)); x + MLP(LN(x))
    (``transformer.py:89``). Children in the JAX order: ln1, attn, ln2,
    fc1, fc2."""

    def __init__(self, hidden_size: int, n_heads: int, mlp_ratio: int = 4,
                 causal: bool = True, use_flash: str = "auto", device=None,
                 generator: torch.Generator = None) -> None:
        super().__init__()
        self.add(LayerNorm(hidden_size, device=device))
        self.add(MultiHeadAttention(hidden_size, n_heads, causal=causal,
                                    use_flash=use_flash, device=device,
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


def TransformerLM(vocab_size: int, hidden_size: int = 256, n_heads: int = 8,
                  n_layers: int = 4, max_len: int = 1024,
                  mlp_ratio: int = 4, causal: bool = True,
                  output: str = "logprobs", use_flash: str = "auto",
                  device=None, seed: int = 0) -> Sequential:
    """GPT-style decoder LM over 1-based token ids ``(B, T)`` →
    per-position log-probs ``(B, T, vocab)`` (``transformer.py:181``;
    remat, sequence parallelism and ``layer_scan`` wait).

    ``use_flash`` goes to every block's attention (``"auto"``: the flash
    kernels on the card, dense attention on the CPU; see
    :class:`bigdl_tpu_torch.nn.attention.MultiHeadAttention`). The
    serving steps compute attention themselves and do not read it.

    Weights are f32, made on ``device`` (default ``cuda``; raises without
    a card unless ``device="cpu"``) from a ``torch.Generator`` seeded
    with ``seed``, with the reference's init distributions."""
    if output not in ("logprobs", "logits"):
        raise ValueError(f"unknown output {output!r}")
    if use_flash not in ("auto", "always", "never"):
        raise ValueError(f"unknown use_flash {use_flash!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    model = Sequential()
    model.add(LookupTable(vocab_size, hidden_size, device=dev,
                          generator=gen))
    model.add(PositionEmbedding(max_len, hidden_size, device=dev,
                                generator=gen))
    for _ in range(n_layers):
        model.add(TransformerBlock(hidden_size, n_heads, mlp_ratio, causal,
                                   use_flash=use_flash, device=dev,
                                   generator=gen))
    model.add(LayerNorm(hidden_size, device=dev))
    model.add(Linear(hidden_size, vocab_size, device=dev, generator=gen))
    if output == "logprobs":
        model.add(LogSoftMax())
    return model


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


def _resolve_decode_views(model: Sequential, off: int, Pt: Dict):
    """``(lookup_w, pos_w, [(block, block_params)], lnf_p, lin_p)`` from
    a serving params tree."""
    keys = list(model._modules)
    blocks = [(m, Pt[keys[i]]) for i, m in enumerate(model.layers())
              if isinstance(m, TransformerBlock)]
    return (Pt[keys[0]]["weight"], Pt[keys[1]]["pos"], blocks,
            Pt[keys[len(keys) - 2 - off]], Pt[keys[len(keys) - 1 - off]])


def _serving_proj(p, x):
    return F.linear(x, p["weight"], p.get("bias"))


def _block_mlp(blk: TransformerBlock, bp: Dict, x):
    """``x + fc2(gelu(fc1(ln2(x))))`` on serving params."""
    h2 = layer_norm(x, bp[blk._child_key(2)]["weight"],
                    bp[blk._child_key(2)]["bias"], blk.ln2.eps)
    return x + _serving_proj(bp[blk._child_key(4)], gelu(
        _serving_proj(bp[blk._child_key(3)], h2)))


def _model_geometry(model: Sequential):
    mods = model.layers()
    if not isinstance(mods[0], LookupTable):
        raise TypeError("expected a TransformerLM-shaped model")
    blocks = [m for m in mods if isinstance(m, TransformerBlock)]
    attn = blocks[0].attn
    off = _decode_head_offset(model)
    return dict(max_len=mods[1].max_len, vocab=mods[0].n_index, off=off,
                lnf=mods[-2 - off], n_layers=len(blocks),
                heads=attn.n_heads, hd=attn.head_dim,
                device=mods[0].weight.device)


# -- int8 KV: the grow-only per-(row, head) scale rule ---------------------

# Over-provision a growing scale by this factor (``transformer.py:594``):
# one growth jumps past the running max, so requantizations stay rare.
_KV_SCALE_HEADROOM = 1.25


def _kv_quant_merge(qc, s_old, amax_new):
    """Grow-only per-(row, head) scale merge for the int8 cache
    (``:597``). ``qc`` (R, L, H, D) int8, ``s_old``/``amax_new`` (R, H)
    f32. Returns ``(requantized NEW cache, s_new, s_safe)``; rows whose
    scale does not grow have ratio exactly 1.0 and requantize to
    themselves bitwise."""
    s_cand = amax_new / 127.0
    s_new = torch.where(s_cand > s_old, s_cand * _KV_SCALE_HEADROOM, s_old)
    s_safe = torch.where(s_new > 0, s_new, 1.0)
    ratio = torch.where(s_new > 0, s_old / s_safe, 1.0)
    qc2 = torch.round(qc.float() * ratio[:, None, :, None]).to(torch.int8)
    return qc2, s_new, s_safe


def _kv_quant_merge_step(kc, vc, ks_old, vs_old, k_amax, v_amax):
    """Decode-step spelling of the merge (``:628``), IN PLACE on the
    pooled ``kc``/``vc``.

    The JAX step skips the full-cache requantization under ``lax.cond``
    when no scale grew. PyTorch has no device-side branch, so this reads
    the ``grew`` flag back to the host — one small device→host sync per
    layer per decode step — and requantizes only on growth. The
    alternative, an unconditional merge, is bitwise equal (ratio-1.0
    rows requantize to themselves) but reads and writes the whole cache
    every step; PERF.md holds the measured cost of both."""
    grew = bool(((k_amax / 127.0 > ks_old).any()
                 | (v_amax / 127.0 > vs_old).any()).item())
    if grew:
        kc2, ks, _ = _kv_quant_merge(kc, ks_old, k_amax)
        vc2, vs, _ = _kv_quant_merge(vc, vs_old, v_amax)
        kc.copy_(kc2)
        vc.copy_(vc2)
    else:
        ks, vs = ks_old, vs_old
    ks_safe = torch.where(ks > 0, ks, 1.0)
    vs_safe = torch.where(vs > 0, vs, 1.0)
    return kc, vc, ks, vs, ks_safe, vs_safe


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
                            kv_quant: bool = False):
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
    path attends over the dequantized cache, the values decode reads."""
    g = _model_geometry(model)
    max_len, vocab, off, lnf = g["max_len"], g["vocab"], g["off"], g["lnf"]
    heads, hd = g["heads"], g["hd"]
    scale = hd ** -0.5
    cache_dtype = compute_dtype or torch.float32

    def prefill(params, tokens, lengths, carry):
        lookup_w, pos_w, blocks, lnf_p, lin_p = \
            _resolve_decode_views(model, off, params)
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
        dev = tokens.device
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
            q = _serving_proj(ap["wq"], h).reshape(B, L, heads, hd)
            k = _serving_proj(ap["wk"], h).reshape(B, L, heads, hd)
            v = _serving_proj(ap["wv"], h).reshape(B, L, heads, hd)
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
            x = x + _serving_proj(ap["wo"], ctx.reshape(B, L, heads * hd))
            x = _block_mlp(blk, bp, x)
        # each row's next-token logits come from its LAST VALID position
        last = (lengths_t - 1).clamp(0, L - 1)
        xf = layer_norm(x[torch.arange(B, device=dev), last],
                        lnf_p["weight"], lnf_p["bias"], lnf.eps)
        logits = _serving_proj(lin_p, xf)
        new_carry["pos"] = (start + lengths_t).to(start.dtype)
        return torch.log_softmax(logits.float(), dim=-1), new_carry

    return prefill


# -- pooled per-row decode -------------------------------------------------


def make_batch_decode_step(model: Sequential, compute_dtype=None,
                           sampling: bool = False, kv_quant: bool = False):
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
    (the CUDA kernel on the card)."""
    from bigdl_tpu_torch.ops.decode_attention import decode_attention

    g = _model_geometry(model)
    max_len, vocab, off, lnf = g["max_len"], g["vocab"], g["off"], g["lnf"]
    heads, hd = g["heads"], g["hd"]
    scale = hd ** -0.5
    cache_dtype = compute_dtype or torch.float32
    init_carry = _serving_init_carry(g["n_layers"], max_len, heads, hd,
                                     cache_dtype, kv_quant, sampling, vocab,
                                     g["device"])

    def forward(params, tokens, active, carry):
        lookup_w, pos_w, blocks, lnf_p, lin_p = \
            _resolve_decode_views(model, off, params)
        n = tokens.shape[0]
        dev = tokens.device
        rows = torch.arange(n, device=dev)
        wpos = carry["pos"].long().clamp(0, max_len - 1)   # write index
        x = lookup_w[tokens.long().clamp(0, lookup_w.shape[0] - 1)]
        x = x + pos_w[wpos]
        act = active[:, None, None]
        for i, (blk, bp) in enumerate(blocks):
            lp = bp[blk._child_key(0)]
            h = layer_norm(x, lp["weight"], lp["bias"], blk.ln1.eps)
            ap = bp[blk._child_key(1)]
            q = _serving_proj(ap["wq"], h).reshape(n, heads, hd)
            k_new = _serving_proj(ap["wk"], h).reshape(n, heads, hd)
            v_new = _serving_proj(ap["wv"], h).reshape(n, heads, hd)
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
            x = x + _serving_proj(ap["wo"], ctx.reshape(n, heads * hd))
            x = _block_mlp(blk, bp, x)
        xf = layer_norm(x, lnf_p["weight"], lnf_p["bias"], lnf.eps)
        logits = _serving_proj(lin_p, xf)
        carry["pos"] += active.to(carry["pos"].dtype)
        return torch.log_softmax(logits.float(), dim=-1), carry

    def sample_step(params, tokens, active, carry, knobs):
        from bigdl_tpu_torch.serving.sampling import sample_rows

        logp, carry = forward(params, tokens, active, carry)
        tok, chosen, new_keys, new_counts = sample_rows(
            logp, carry["rng"], knobs, carry["tok_counts"],
            carry["prompt_mask"])
        a = active[:, None]
        carry["rng"] = torch.where(a, new_keys, carry["rng"])
        carry["tok_counts"] = torch.where(a, new_counts, carry["tok_counts"])
        return tok, chosen, carry

    return (sample_step if sampling else forward), init_carry
