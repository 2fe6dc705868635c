"""Train-step builder (``bigdl_tpu/optim/train_step.py``).

``make_train_step`` returns ``step(params, opt_state, model_state, rng,
inputs, targets) -> (params, opt_state, model_state, loss)`` — the JAX
contract, with params as ``{parameter name: tensor}`` (f32 masters). The
forward runs through ``torch.func.functional_call`` on the given params,
so the module's own parameters are never read or written by a step.

Mixed precision is the JAX package's, not ``torch.autocast``: with
``compute_dtype`` set, EVERY float parameter (position table, LayerNorm
and BatchNorm weights included) and every float input is cast to that dtype
inside the autograd graph, the output is cast to f32 for the loss, and
the gradients flow back through the casts to the f32 masters. Integer
inputs (token ids) pass through untouched.

Per-layer regularizers (a layer's ``w_regularizer``/``b_regularizer``)
change the gradients right after the backward pass, before clipping, in
the JAX step's order (``apply_module_regularizers``).

Not ported yet: frozen layers (the step raises if a module asks for
them), stochastic layers (``rng`` is accepted for the JAX signature and
unused: no port layer draws noise), and the JAX step's
``grad_transform``/``device_preprocess`` hooks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.func import functional_call


def cast_floats(tree, dtype):
    """Cast every floating tensor of a dict/list/tuple/tensor to
    ``dtype``; integer tensors (token ids) pass through."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def restore_dtypes(tree, ref):
    """Cast ``tree``'s tensors back to the dtypes of the matching ``ref``
    tensors."""
    if isinstance(tree, dict):
        return {k: restore_dtypes(v, ref[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(restore_dtypes(v, r) for v, r in zip(tree, ref))
    if isinstance(tree, torch.Tensor) and isinstance(ref, torch.Tensor):
        return tree.to(ref.dtype)
    return tree


def resolve_dtype(dtype):
    """Accept "bf16"/"fp16"/"fp32" strings or torch dtypes."""
    if dtype is None or not isinstance(dtype, str):
        return dtype
    table = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
             "fp16": torch.float16, "float16": torch.float16,
             "fp32": None, "float32": None}
    if dtype not in table:
        raise ValueError(
            f"unknown compute dtype {dtype!r}; expected one of {sorted(table)}")
    return table[dtype]


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    return {k: g * scale for k, g in grads.items()}


def clip_by_value(grads: Dict[str, torch.Tensor], min_v: float, max_v: float):
    return {k: g.clamp(min_v, max_v) for k, g in grads.items()}


#: (regularizer attribute, the leaf it regularizes)
_REGULARIZED = (("w_regularizer", "weight"), ("b_regularizer", "bias"))


def module_regularizers(model):
    """``[(parameter name, regularizer)]`` for every regularized leaf,
    named as ``named_parameters`` names it: the module's name in
    ``model.named_modules()`` (child indices included), then the leaf."""
    own = dict(model.named_parameters())
    out = []
    for prefix, m in model.named_modules():
        for reg_attr, key in _REGULARIZED:
            reg = getattr(m, reg_attr, None)
            name = f"{prefix}.{key}" if prefix else key
            if reg is not None and name in own:
                out.append((name, reg))
    return out


def apply_module_regularizers(regs, params, grads):
    """Add each regularizer's gradient term (``regs`` from
    :func:`module_regularizers`); returns a new grads dict."""
    if not regs:
        return grads
    out = dict(grads)
    for name, reg in regs:
        out[name] = reg.grad_update(params[name], out[name])
    return out


def _refuse_unported(model) -> None:
    for m in model.modules():
        if getattr(m, "frozen", None):
            raise NotImplementedError(
                f"{type(m).__name__}: frozen layers are not ported yet")


def make_train_step(model, criterion, optim_method,
                    grad_clip: Optional[dict] = None,
                    loss_scale: float = 1.0,
                    compute_dtype: Optional[Any] = None):
    """Returns ``step(params, opt_state, model_state, rng, inputs,
    targets) -> (params, opt_state, model_state, loss)``; ``loss`` is a
    0-d f32 tensor on the card (reading it is the caller's one sync).

    ``model_state`` holds the module's buffers (``{buffer name:
    tensor}``, the BatchNorm running statistics) and is neither cast nor
    differentiated, as in JAX: the forward runs on these tensors through
    ``functional_call`` and BatchNorm updates them IN PLACE in training
    mode, so the returned ``model_state`` is the dict passed in, holding
    the new statistics. ``loss_scale`` multiplies the loss before the
    backward pass and divides the gradients after (fp16)."""
    _refuse_unported(model)
    compute_dtype = resolve_dtype(compute_dtype)
    regs = module_regularizers(model)

    def step(params, opt_state, model_state, rng, inputs, targets):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        with torch.enable_grad():
            p, x = leaves, inputs
            if compute_dtype is not None:
                p = cast_floats(p, compute_dtype)
                x = cast_floats(x, compute_dtype)
            out = functional_call(model, {**p, **model_state}, (x,))
            if compute_dtype is not None:
                out = cast_floats(out, torch.float32)  # f32 stable softmax
            loss = criterion.apply(out, targets) * loss_scale
            grads = dict(zip(leaves, torch.autograd.grad(
                loss, list(leaves.values()))))
        loss = loss.detach()
        if loss_scale != 1.0:
            loss = loss / loss_scale
            grads = {k: g / loss_scale for k, g in grads.items()}
        grads = apply_module_regularizers(regs, params, grads)
        if grad_clip:
            if grad_clip.get("l2_norm") is not None:
                grads = clip_by_global_norm(grads, grad_clip["l2_norm"])
            if grad_clip.get("constant") is not None:
                lo, hi = grad_clip["constant"]
                grads = clip_by_value(grads, lo, hi)
        new_params, new_opt = optim_method.update(grads, opt_state, params)
        return new_params, new_opt, model_state, loss

    return step


def make_eval_step(model):
    @torch.no_grad()
    def step(params, model_state, inputs):
        return functional_call(model, {**params, **model_state}, (inputs,))

    return step
