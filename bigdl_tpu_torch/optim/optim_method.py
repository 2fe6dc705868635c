"""OptimMethods (``bigdl_tpu/optim/optim_method.py``): the ``OptimMethod``
base with ``save``/``load``/``clear_history``, ``SGD`` with its
learning-rate schedules (``Default``, ``Step``, ``MultiStep``,
``Exponential``, ``Poly``, ``Warmup``, ``SequentialSchedule``,
``Plateau``; ``:53-190``), ``Adam`` and ``Adagrad`` (``:419``).

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

A schedule is host arithmetic on the optimizer's own step counter
``neval`` (0 at the first update, as in JAX), each operation rounded to
f32 in the order the JAX schedule's operations run one by one, so the
rates equal JAX's bit for bit. (Inside JAX's jitted train step XLA may
contract ``a * b + c`` into one fused multiply-add, or divide by a
constant as a multiply; the rate it applies can then differ from the
op-by-op value, and from the port's, by an ulp.) ``Plateau`` reads the
scale that ``record_score`` (fed by validation) last set.

Not ported yet (they raise ``NotImplementedError``): Adam's bf16 slot
storage (``state_dtype``) and stochastic rounding; the other methods
are not ported either.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


def _f32(x) -> float:
    """A step scalar rounded to f32, as JAX computes it."""
    return float(np.float32(x))


_F32 = np.float32


class LearningRateSchedule:
    def lr(self, base_lr: float, step: int) -> float:
        """The rate of update ``step`` (``neval``, from 0)."""
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + step * learningRateDecay) — the reference SGD default."""

    def __init__(self, learning_rate_decay: float = 0.0) -> None:
        self.learning_rate_decay = learning_rate_decay

    def lr(self, base_lr: float, step: int) -> float:
        return _f32(_F32(base_lr) / (_F32(1.0) + _F32(step)
                                     * _F32(self.learning_rate_decay)))


class Step(LearningRateSchedule):
    """lr * gamma ^ floor(step / stepSize)."""

    def __init__(self, step_size: int, gamma: float) -> None:
        self.step_size = step_size
        self.gamma = gamma

    def lr(self, base_lr, step):
        e = np.floor(_F32(step) / _F32(self.step_size))
        return _f32(_F32(base_lr) * _F32(self.gamma) ** e)


class MultiStep(LearningRateSchedule):
    """lr * gamma ^ (number of milestones passed)."""

    def __init__(self, step_sizes, gamma: float) -> None:
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def lr(self, base_lr, step):
        e = _F32(sum(_F32(step >= s) for s in self.step_sizes))
        return _f32(_F32(base_lr) * _F32(self.gamma) ** e)


class Exponential(LearningRateSchedule):
    """lr * decayRate ^ (step / decayStep), floored when ``stair_case``."""

    def __init__(self, decay_step: int, decay_rate: float,
                 stair_case: bool = False) -> None:
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.stair_case = stair_case

    def lr(self, base_lr, step):
        e = _F32(step) / _F32(self.decay_step)
        if self.stair_case:
            e = np.floor(e)
        return _f32(_F32(base_lr) * _F32(self.decay_rate) ** e)


class Poly(LearningRateSchedule):
    """lr * (1 - step/maxIteration)^power — Inception-v1's schedule."""

    def __init__(self, power: float, max_iteration: int) -> None:
        self.power = power
        self.max_iteration = max_iteration

    def lr(self, base_lr, step):
        frac = np.clip(_F32(step) / _F32(self.max_iteration), _F32(0.0),
                       _F32(1.0))
        return _f32(_F32(base_lr) * (_F32(1.0) - frac) ** _F32(self.power))


class Warmup(LearningRateSchedule):
    """Linear ramp by ``delta`` per step (chained inside a
    SequentialSchedule for the warm-up-then-step recipe)."""

    def __init__(self, delta: float, iteration_num=None) -> None:
        self.delta = delta
        self.iteration_num = iteration_num

    def lr(self, base_lr, step):
        return _f32(_F32(base_lr) + _F32(step) * _F32(self.delta))


class SequentialSchedule(LearningRateSchedule):
    """Chain schedules, each active for its ``iterations`` steps and fed
    the step counted from its own start."""

    def __init__(self, iteration_per_schedule=None) -> None:
        self.schedules = []

    def add(self, schedule: LearningRateSchedule,
            iterations: int) -> "SequentialSchedule":
        self.schedules.append((schedule, iterations))
        return self

    def lr(self, base_lr, step):
        out, offset = None, 0
        for sched, iters in self.schedules:
            if out is None or step >= offset:
                out = sched.lr(base_lr, step - offset)
            offset += iters
        return out


class Plateau(LearningRateSchedule):
    """Reduce on plateau: ``record_score`` (called by the optimizer's
    validation) scales the rate by ``factor`` after ``patience`` scores
    without an improvement of ``epsilon``, then waits ``cooldown``
    scores."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min", epsilon: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0) -> None:
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._scale = 1.0
        self._best = None
        self._wait = 0
        self._cooldown_left = 0

    def record_score(self, score: float) -> None:
        improved = (
            self._best is None
            or (self.mode == "min" and score < self._best - self.epsilon)
            or (self.mode == "max" and score > self._best + self.epsilon))
        if improved:
            self._best = score
            self._wait = 0
        elif self._cooldown_left > 0:
            self._cooldown_left -= 1
        else:
            self._wait += 1
            if self._wait >= self.patience:
                self._scale *= self.factor
                self._wait = 0
                self._cooldown_left = self.cooldown

    def lr(self, base_lr, step):
        return _f32(max(_F32(base_lr * self._scale), _F32(self.min_lr)))


class OptimMethod:
    """Base: ``init_state``/``update`` plus the reference host state."""

    def __init__(self) -> None:
        self.state = {"epoch": 1, "neval": 1}  # reference-style host state

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0}

    def update(self, grads: Tensors, state: Dict,
               params: Tensors) -> Tuple[Tensors, Dict]:
        raise NotImplementedError

    def clear_history(self) -> "OptimMethod":
        self.state = {"epoch": 1, "neval": 1}
        return self

    def save(self, path: str, over_write: bool = False) -> "OptimMethod":
        """Pickle this method (hyper-parameters, schedule, host state) to
        ``path`` atomically (:mod:`bigdl_tpu_torch.utils.file_io`)."""
        from bigdl_tpu_torch.utils.file_io import File

        File.save(self, path, over_write=over_write)
        return self

    @staticmethod
    def load(path: str) -> "OptimMethod":
        from bigdl_tpu_torch.utils.file_io import File

        return File.load(path)


class SGD(OptimMethod):
    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learning_rate_schedule=None) -> None:
        super().__init__()
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


class Adagrad(OptimMethod):
    """The JAX update (``:419-444``): weight decay into the gradient,
    ``clr = lr / (1 + neval * decay)``, ``accum += g²``, then ``p - clr *
    g / (sqrt(accum) + 1e-10)``."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0) -> None:
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0,
                "accum": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.weight_decay > 0:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        neval = state["neval"]
        clr = _f32(np.float32(self.learning_rate) / (
            np.float32(1.0) + np.float32(neval)
            * np.float32(self.learning_rate_decay)))
        accum = [state["accum"][k] for k in names]
        torch._foreach_addcmul_(accum, g, g)
        den = torch._foreach_sqrt(accum)
        torch._foreach_add_(den, 1e-10)
        step = torch._foreach_mul(g, clr)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(p, step)
        return params, {"neval": neval + 1, "accum": state["accum"]}


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
