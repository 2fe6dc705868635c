"""OptimMethods (``bigdl_tpu/optim/optim_method.py``): the ``OptimMethod``
base, ``SGD`` with the ``Default`` learning-rate schedule, and ``Adam``.

Each method keeps the JAX package's functional contract
``update(grads, state, params) -> (new_params, new_state)`` over dicts of
tensors keyed by parameter name, with the step counter ``neval`` in the
state (a Python int here: it never needs the card). The arithmetic
follows the JAX update line by line, with the step's scalars (learning
rate, bias corrections) rounded to f32 as JAX computes them. Unlike the
JAX version, the update runs IN PLACE: the returned params and slot
tensors are the ones passed in, updated with ``torch._foreach_*`` ops
(one launch per op for all tensors), so a step holds no second copy of
the params or the slots.

Not ported yet (they raise ``NotImplementedError``): the other schedules
of SGD, Adam's bf16 slot storage (``state_dtype``) and stochastic
rounding, and the other methods.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def _f32(x) -> float:
    """A step scalar rounded to f32, as JAX computes it."""
    return float(np.float32(x))


class Default:
    """lr / (1 + step * learningRateDecay) — the reference SGD default."""

    def __init__(self, learning_rate_decay: float = 0.0) -> None:
        self.learning_rate_decay = learning_rate_decay

    def lr(self, base_lr: float, step: int) -> float:
        return _f32(np.float32(base_lr) / (np.float32(1.0) + np.float32(step)
                                           * np.float32(
                                               self.learning_rate_decay)))


class OptimMethod:
    """Base: ``init_state``/``update`` plus the reference host state."""

    def __init__(self) -> None:
        self.state = {"epoch": 1, "neval": 1}  # reference-style host state

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0}

    def update(self, grads: Tensors, state: Dict,
               params: Tensors) -> Tuple[Tensors, Dict]:
        raise NotImplementedError


class SGD(OptimMethod):
    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule=None) -> None:
        super().__init__()
        if learning_rate_schedule is not None and not isinstance(
                learning_rate_schedule, Default):
            raise NotImplementedError(
                f"{type(learning_rate_schedule).__name__} schedule is not "
                "ported yet (only Default)")
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = dampening if dampening is not None else 0.0
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            raise ValueError("nesterov requires momentum > 0 and dampening = 0")
        self.learning_rate_schedule = learning_rate_schedule or Default(
            learning_rate_decay)

    def init_state(self, params: Tensors) -> Dict:
        s: Dict = {"neval": 0}
        if self.momentum > 0:
            s["velocity"] = {k: torch.zeros_like(p) for k, p in params.items()}
        return s

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        clr = self.learning_rate_schedule.lr(self.learning_rate,
                                             state["neval"])
        if self.weight_decay > 0:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        new_state = dict(state)
        if self.momentum > 0:
            vel = [state["velocity"][k] for k in names]
            torch._foreach_mul_(vel, self.momentum)
            torch._foreach_add_(vel, g, alpha=1.0 - self.dampening)
            g = (torch._foreach_add(g, vel, alpha=self.momentum)
                 if self.nesterov else vel)
        torch._foreach_add_(p, g, alpha=-clr)
        new_state["neval"] = state["neval"] + 1
        return params, new_state


class Adam(OptimMethod):
    """Torch-convention Adam, the JAX update order (``:373-416``): f32
    slot math, ``bc1``/``bc2`` from ``neval + 1``, ``clr = lr / (1 +
    neval * decay)``, then ``p - clr * (m / bc1) / (sqrt(v / bc2) + eps)``."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 state_dtype: Optional[str] = None,
                 stochastic_rounding: bool = False) -> None:
        super().__init__()
        if state_dtype is not None:
            raise NotImplementedError(
                "Adam(state_dtype=...) (bf16 slots) is not ported yet")
        if stochastic_rounding:
            raise NotImplementedError(
                "Adam(stochastic_rounding=True) (bf16 masters) is not ported "
                "yet")
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0,
                "m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        for k, p in params.items():
            if p.dtype != torch.float32:
                raise NotImplementedError(
                    f"Adam on {p.dtype} params ({k}) is not ported yet: the "
                    "masters are f32")
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k].float() for k in names]
        m = [state["m"][k] for k in names]
        v = [state["v"][k] for k in names]
        neval = state["neval"]
        t = np.float32(neval + 1)
        clr = _f32(np.float32(self.learning_rate) / (
            np.float32(1.0) + np.float32(neval)
            * np.float32(self.learning_rate_decay)))
        bc1 = _f32(np.float32(1.0) - np.float32(self.beta1) ** t)
        bc2 = _f32(np.float32(1.0) - np.float32(self.beta2) ** t)
        # m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g^2
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - self.beta1))
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1.0 - self.beta2))
        # p - clr * (m / bc1) / (sqrt(v / bc2) + eps)
        num = torch._foreach_div(m, bc1)
        torch._foreach_mul_(num, clr)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(num, den)
        torch._foreach_sub_(p, num)
        return params, {"neval": neval + 1, "m": state["m"],
                        "v": state["v"]}


def load_jax_opt_state(model, state_np: Dict) -> Dict:
    """A JAX optimizer state (``{"neval", "m", "v"}`` or
    ``{"neval", "velocity"}``, numpy trees in the JAX params layout) as the
    port's state for ``model``'s parameters: slot trees become
    ``{parameter name: tensor}`` on the model's device."""
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    device = next(model.parameters()).device
    out: Dict = {"neval": int(np.asarray(state_np["neval"]))}
    for key, tree in state_np.items():
        if key == "neval":
            continue
        out[key] = {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
                    for n, a in named_leaves(model, tree).items()}
    return out
