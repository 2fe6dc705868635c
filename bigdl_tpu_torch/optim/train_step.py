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

``device_preprocess`` runs on the raw device batch before anything
else, before the compute-dtype cast (the u8-NHWC feed's
``DeviceImageNormalizer``: the host ships uint8 batches, a quarter of the
f32 bytes, and the card normalizes them), in the train and the eval step.

``rng`` is a ``torch.Generator`` on the step's device, or ``None``. The
forward runs with it current (:func:`bigdl_tpu_torch.nn.module.use_rng`),
so stochastic layers (``Dropout``, a recurrent cell's variational
dropout) draw their masks from it and from nothing else; with ``None``
they are the identity, as JAX's are with ``rng=None``.
:class:`~bigdl_tpu_torch.optim.optimizer.Optimizer` seeds one from its
base seed and the iteration counter, as JAX folds ``neval`` into its
base key.

``grad_transform`` maps the gradient dict after the regularizers and
before clipping, where the JAX step applies it.

Not ported yet: frozen layers (the step raises if a module asks for
them).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from bigdl_tpu_torch.nn.module import use_rng


def step_seed(seed: int, neval: int, rank: Optional[int] = None) -> int:
    """The seed of iteration ``neval``'s generator under the base
    ``seed``, JAX's ``fold_in(base_key, neval)``: a 64-bit word of numpy's
    ``SeedSequence`` of the pair, so nearby pairs give unrelated seeds.
    With ``rank`` (a data-parallel rank) the triple is hashed instead, as
    JAX folds the mesh's ``axis_index`` in, so the ranks draw unrelated
    masks."""
    words = [int(seed), int(neval)] + ([] if rank is None else [int(rank)])
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


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


#: (regularizer attribute, the module's key-set attribute, the default
#: keys): a recurrent cell's ``w_ih``/``w_hh``/``b_*`` take part too
_REGULARIZED = (("w_regularizer", "_reg_w_keys", ("weight",)),
                ("u_regularizer", "_reg_u_keys", ("w_hh",)),
                ("b_regularizer", "_reg_b_keys", ("bias", "b_ih", "b_hh")))


def module_regularizers(model):
    """``[(parameter name, regularizer)]`` for every regularized leaf,
    named as ``named_parameters`` names it: the module's name in
    ``model.named_modules()`` (child indices included), then the leaf."""
    own = dict(model.named_parameters())
    out = []
    for prefix, m in model.named_modules():
        for reg_attr, keys_attr, default_keys in _REGULARIZED:
            reg = getattr(m, reg_attr, None)
            if reg is None:
                continue
            for key in getattr(m, keys_attr, default_keys):
                name = f"{prefix}.{key}" if prefix else key
                if name in own:
                    out.append((name, reg))
    return out


def _regs_of(model_or_regs):
    """The ``[(name, regularizer)]`` list itself, or a module's through
    :func:`module_regularizers` (JAX's functions take the model)."""
    if isinstance(model_or_regs, torch.nn.Module):
        return module_regularizers(model_or_regs)
    return model_or_regs


def apply_module_regularizers(model, params, grads):
    """Add each regularizer's gradient term; returns a new grads dict.
    ``model``: the model, as JAX takes it (``bigdl_tpu/optim/train_step.py
    :94``), or the list :func:`module_regularizers` returns (the port's
    step computes it once)."""
    regs = _regs_of(model)
    if not regs:
        return grads
    out = dict(grads)
    for name, reg in regs:
        out[name] = reg.grad_update(params[name], out[name])
    return out


def regularizer_loss(model, params) -> Any:
    """The regularizers' penalty on ``params``: the loss term whose
    gradient :func:`apply_module_regularizers` adds. ``model``: the model,
    as JAX takes it (``bigdl_tpu/optim/train_step.py:177``), or the list
    :func:`module_regularizers` returns."""
    total = 0.0
    for name, reg in _regs_of(model):
        total = total + reg.loss_term(params[name])
    return total


def _refuse_unported(model) -> None:
    for m in model.modules():
        if getattr(m, "frozen", None):
            raise NotImplementedError(
                f"{type(m).__name__}: frozen layers are not ported yet")


def make_train_step(model, criterion, optim_method,
                    grad_clip: Optional[dict] = None,
                    grad_transform: Optional[Callable] = None,
                    loss_scale: float = 1.0,
                    compute_dtype: Optional[Any] = None,
                    device_preprocess: Optional[Callable] = None):
    """Returns ``step(params, opt_state, model_state, rng, inputs,
    targets) -> (params, opt_state, model_state, loss)``; ``loss`` is a
    0-d f32 tensor on the card (reading it is the caller's one sync).

    ``model_state`` holds the module's buffers (``{buffer name:
    tensor}``, the BatchNorm running statistics) and is neither cast nor
    differentiated, as in JAX: the forward runs on these tensors through
    ``functional_call`` and BatchNorm updates them IN PLACE in training
    mode, so the returned ``model_state`` is the dict passed in, holding
    the new statistics. ``loss_scale`` multiplies the loss before the
    backward pass and divides the gradients after (fp16).
    ``grad_transform(grads) -> grads`` runs between the regularizers and
    the clipping. ``device_preprocess`` maps the raw input batch first. ``rng`` (a
    ``torch.Generator`` or ``None``) feeds the stochastic layers. The
    model's output may be a table (a list of tensors, ``Inception_v1``'s
    three heads): the casts and the criterion take it as it is."""
    _refuse_unported(model)
    compute_dtype = resolve_dtype(compute_dtype)
    regs = module_regularizers(model)

    def step(params, opt_state, model_state, rng, inputs, targets):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        if device_preprocess is not None:
            inputs = device_preprocess(inputs)
        with torch.enable_grad():
            p, x = leaves, inputs
            if compute_dtype is not None:
                p = cast_floats(p, compute_dtype)
                x = cast_floats(x, compute_dtype)
            with use_rng(rng):
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
        if grad_transform is not None:
            grads = grad_transform(grads)
        if grad_clip:
            if grad_clip.get("l2_norm") is not None:
                grads = clip_by_global_norm(grads, grad_clip["l2_norm"])
            if grad_clip.get("constant") is not None:
                lo, hi = grad_clip["constant"]
                grads = clip_by_value(grads, lo, hi)
        new_params, new_opt = optim_method.update(grads, opt_state, params)
        return new_params, new_opt, model_state, loss

    return step


def make_eval_step(model, device_preprocess: Optional[Callable] = None):
    @torch.no_grad()
    def step(params, model_state, inputs):
        if device_preprocess is not None:
            inputs = device_preprocess(inputs)
        return functional_call(model, {**params, **model_state}, (inputs,))

    return step
