"""OptimMethods (``bigdl_tpu/optim/optim_method.py``): the ``OptimMethod``
base with ``save``/``load``/``clear_history``, ``SGD`` with its
learning-rate schedules (``Default``, ``Step``, ``MultiStep``,
``Exponential``, ``Poly``, ``Warmup``, ``SequentialSchedule``,
``Plateau``; ``:53-190``), ``Adam``, ``Adagrad`` (``:419``),
``Adadelta`` (``:449``), ``Adamax`` (``:486``), ``RMSprop`` (``:523``),
``Ftrl`` (``:556``) and ``LarsSGD`` (``:610``).

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

``Adam(state_dtype="bf16")`` stores its slots in bf16 and
``Adam(stochastic_rounding=True)`` writes bf16 parameters back through
:func:`stochastic_round`, whose noise comes from a ``torch.Generator``
seeded from ``neval + 1`` (Philox on the card), one draw over the bf16
leaves laid end to end, so a leaf's bits are fixed by the step and its
place in the parameter order. JAX draws
its noise with threefry, so the two packages round the same value with
other bits; the rounding given the bits is :func:`_round_with_noise`,
bitwise JAX's. L-BFGS is not ported.

Slot names are JAX's (``accum``/``delta_accum``, ``m``/``u``, ``sq``,
``accum``/``linear``, ``velocity``), so checkpoints and
:func:`load_jax_opt_state` carry them as they carry Adam's.
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


def _round_with_noise(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 by adding ``noise`` (integers in [0, 2^16), one per
    element) to the f32 bit pattern below the kept mantissa and truncating
    with ``0xFFFF0000`` (``optim_method.py:323``); non-finite values take
    the deterministic cast. Bitwise JAX's ``stochastic_round`` given the
    same noise bits."""
    xf = x.float()
    finite = torch.isfinite(xf)
    # finite values only: a NaN or inf pattern plus noise could overflow
    # the signed add (their result is replaced below anyway)
    bits = torch.where(finite, xf, 0.0).view(torch.int32)
    kept = (bits + noise.to(torch.int32)) & -65536     # & 0xFFFF0000
    return torch.where(finite, kept.view(torch.float32), xf).to(
        torch.bfloat16)


def stochastic_round(x: torch.Tensor, dtype=torch.bfloat16,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """Unbiased f32 → bf16 cast (``optim_method.py:302``): uniform 16-bit
    noise below the kept mantissa, then truncation, so ``E[result] = x``;
    non-finite values pass through the deterministic cast. The noise is
    drawn from ``generator`` (a ``torch.Generator`` on ``x``'s device; JAX
    takes a PRNG key here)."""
    if dtype not in (torch.bfloat16, "bf16", "bfloat16"):
        raise ValueError("stochastic_round targets bfloat16 storage")
    noise = torch.randint(0, 1 << 16, x.shape, generator=generator,
                          device=x.device, dtype=torch.int32)
    return _round_with_noise(x, noise)


def rounding_generator(device, neval_plus_1: int) -> torch.Generator:
    """The generator of the rounding noise of update ``t = neval + 1``:
    seeded from ``t``, as JAX folds ``t`` into its key, so an update is a
    pure function of (grads, state, params)."""
    seed = int(np.random.SeedSequence([int(neval_plus_1)])
               .generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _write_rounded(dsts, vals, neval_plus_1: int) -> None:
    """Writes each f32 ``vals[i]`` into the bf16 ``dsts[i]`` through
    :func:`stochastic_round`, all leaves in one pass: one draw of the
    update's generator covers the leaves laid end to end (JAX folds each
    leaf's index into the key instead), so a leaf's noise is fixed by
    ``neval + 1`` and its place in the order."""
    flat = torch.cat([v.reshape(-1) for v in vals])
    out = stochastic_round(flat, torch.bfloat16,
                           rounding_generator(flat.device, neval_plus_1))
    for dst, part in zip(dsts, out.split([d.numel() for d in dsts])):
        dst.copy_(part.view_as(dst))


class Adam(OptimMethod):
    """Torch-convention Adam, the JAX update order (``:373-416``): f32
    slot math, ``bc1``/``bc2`` from ``neval + 1``, ``clr = lr / (1 +
    neval * decay)``, then ``p - clr * (m / bc1) / (sqrt(v / bc2) + eps)``.

    ``state_dtype="bf16"`` stores the m/v slots in bf16; the slot math
    still runs in f32 (cast in, cast out), and the step reads the f32
    slots before they are rounded, as in JAX. Parameters of any float
    dtype are updated in f32 and written back in their own dtype; with
    ``stochastic_rounding=True`` a bf16 parameter is written back through
    :func:`stochastic_round` (f32 parameters ignore it). Slots of a bf16
    parameter are bf16 whatever ``state_dtype`` says (JAX's slots take
    the leaf's dtype)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 state_dtype: Optional[str] = None,
                 stochastic_rounding: bool = False) -> None:
        super().__init__()
        if state_dtype not in (None, "bf16", "bfloat16"):
            raise ValueError(
                f"state_dtype must be None or 'bf16', got {state_dtype!r}")
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.state_dtype = state_dtype
        self.stochastic_rounding = bool(stochastic_rounding)

    def _slot_dtype(self, leaf_dtype):
        return torch.bfloat16 if self.state_dtype else leaf_dtype

    def init_state(self, params: Tensors) -> Dict:
        def zeros(p):
            return torch.zeros_like(p, dtype=self._slot_dtype(p.dtype))

        return {"neval": 0,
                "m": {k: zeros(p) for k, p in params.items()},
                "v": {k: zeros(p) for k, p in params.items()}}

    def _scalars(self, neval: int):
        t = np.float32(neval + 1)
        clr = _clr(self.learning_rate, self.learning_rate_decay, neval)
        bc1 = _f32(np.float32(1.0) - np.float32(self.beta1) ** t)
        bc2 = _f32(np.float32(1.0) - np.float32(self.beta2) ** t)
        return clr, bc1, bc2

    def _moments(self, m, v, g):
        """m = b1 * m + (1 - b1) * g;  v = b2 * v + (1 - b2) * g^2, in
        place on the f32 lists."""
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - self.beta1))
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                                  1.0 - self.beta2))

    def _step(self, m, v, clr, bc1, bc2):
        """``clr * (m / bc1) / (sqrt(v / bc2) + eps)`` per leaf."""
        num = torch._foreach_div(m, bc1)
        torch._foreach_mul_(num, clr)
        den = torch._foreach_div(v, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(num, den)
        return num

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k].float() for k in names]
        m = [state["m"][k] for k in names]
        v = [state["v"][k] for k in names]
        neval = state["neval"]
        clr, bc1, bc2 = self._scalars(neval)
        plain = all(t.dtype == torch.float32 for t in p + m + v)
        if plain:
            # f32 masters and slots: everything in place
            self._moments(m, v, g)
            torch._foreach_sub_(p, self._step(m, v, clr, bc1, bc2))
            return params, {"neval": neval + 1, "m": state["m"],
                            "v": state["v"]}
        m32 = [t.float() for t in m]
        v32 = [t.float() for t in v]
        self._moments(m32, v32, g)
        new32 = torch._foreach_sub([t.float() for t in p],
                                   self._step(m32, v32, clr, bc1, bc2))
        sr = [self.stochastic_rounding and dst.dtype == torch.bfloat16
              for dst in p]
        if any(sr):
            _write_rounded([d for d, r in zip(p, sr) if r],
                           [v for v, r in zip(new32, sr) if r], neval + 1)
        for dst, val, r in zip(p, new32, sr):
            if not r:
                dst.copy_(val)
        for dst, val in zip(m + v, m32 + v32):
            dst.copy_(val)
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
        clr = _clr(self.learning_rate, self.learning_rate_decay, neval)
        accum = [state["accum"][k] for k in names]
        torch._foreach_addcmul_(accum, g, g)
        den = torch._foreach_sqrt(accum)
        torch._foreach_add_(den, 1e-10)
        step = torch._foreach_mul(g, clr)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(p, step)
        return params, {"neval": neval + 1, "accum": state["accum"]}


def _clr(learning_rate: float, learning_rate_decay: float, neval: int):
    """``lr / (1 + neval * decay)`` in f32, as JAX computes it."""
    return _f32(np.float32(learning_rate) / (
        np.float32(1.0) + np.float32(neval) * np.float32(learning_rate_decay)))


class Adadelta(OptimMethod):
    """The JAX update (``:449-483``): ``accum = ρ·accum + (1 - ρ)·g²``,
    ``Δ = g·sqrt(delta_accum + ε) / sqrt(accum + ε)``, ``delta_accum =
    ρ·delta_accum + (1 - ρ)·Δ²``, ``p -= Δ``."""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10) -> None:
        super().__init__()
        self.decay_rate = decay_rate
        self.epsilon = epsilon
        self.learning_rate = 1.0

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0,
                "accum": {k: torch.zeros_like(p) for k, p in params.items()},
                "delta_accum": {k: torch.zeros_like(p)
                                for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        accum = [state["accum"][k] for k in names]
        dacc = [state["delta_accum"][k] for k in names]
        rho, eps = self.decay_rate, self.epsilon
        torch._foreach_mul_(accum, rho)
        torch._foreach_addcmul_(accum, g, g, value=1 - rho)
        num = torch._foreach_add(dacc, eps)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(accum, eps)
        torch._foreach_sqrt_(den)
        delta = torch._foreach_mul(g, num)
        torch._foreach_div_(delta, den)
        torch._foreach_mul_(dacc, rho)
        torch._foreach_addcmul_(dacc, delta, delta, value=1 - rho)
        torch._foreach_sub_(p, delta)
        return params, {"neval": state["neval"] + 1,
                        "accum": state["accum"],
                        "delta_accum": state["delta_accum"]}


class Adamax(OptimMethod):
    """The JAX update (``:486-520``): ``m = β1·m + (1 - β1)·g``, ``u =
    max(β2·u, |g| + ε)``, ``p -= (lr / (1 - β1^t))·m / u``. The default ε
    is JAX's 1e-8 (the reference's 1e-38 is subnormal in f32)."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8) -> None:
        super().__init__()
        self.learning_rate = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0,
                "m": {k: torch.zeros_like(p) for k, p in params.items()},
                "u": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        m = [state["m"][k] for k in names]
        u = [state["u"][k] for k in names]
        neval = state["neval"]
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - self.beta1))
        torch._foreach_mul_(u, self.beta2)
        absg = torch._foreach_abs(g)
        torch._foreach_add_(absg, self.epsilon)
        torch._foreach_maximum_(u, absg)
        bc = np.float32(1.0) - np.float32(self.beta1) ** np.float32(neval + 1)
        step = torch._foreach_mul(m, _f32(np.float32(self.learning_rate) / bc))
        torch._foreach_div_(step, u)
        torch._foreach_sub_(p, step)
        return params, {"neval": neval + 1, "m": state["m"], "u": state["u"]}


class RMSprop(OptimMethod):
    """The JAX update (``:523-553``): ``clr = lr / (1 + neval·decay)``,
    ``sq = ρ·sq + (1 - ρ)·g²``, ``p -= clr·g / (sqrt(sq) + ε)``."""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 decay_rate: float = 0.99, epsilon: float = 1e-8) -> None:
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.decay_rate = decay_rate
        self.epsilon = epsilon

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0,
                "sq": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        sq = [state["sq"][k] for k in names]
        neval = state["neval"]
        clr = _clr(self.learning_rate, self.learning_rate_decay, neval)
        torch._foreach_mul_(sq, self.decay_rate)
        torch._foreach_addcmul_(sq, g, g, value=1 - self.decay_rate)
        den = torch._foreach_sqrt(sq)
        torch._foreach_add_(den, self.epsilon)
        step = torch._foreach_mul(g, clr)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(p, step)
        return params, {"neval": neval + 1, "sq": state["sq"]}


class Ftrl(OptimMethod):
    """Follow-the-regularized-leader, the JAX update (``:556-607``) with
    ``n = accum``, ``z = linear`` and ``c = -learning_rate_power``:
    ``σ = (n'^c - n^c) / lr`` with ``n' = n + g²``, ``z += g - σ·w``,
    ``w = (clip(z, ±l1) - z) / (n'^c / lr + 2·l2)``."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0) -> None:
        super().__init__()
        self.learning_rate = learning_rate
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength

    def init_state(self, params: Tensors) -> Dict:
        return {"neval": 0,
                "accum": {k: torch.full_like(p, self.init_accum)
                          for k, p in params.items()},
                "linear": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        w = [params[k] for k in names]
        g = [grads[k] for k in names]
        accum = [state["accum"][k] for k in names]
        linear = [state["linear"][k] for k in names]
        lr, c = self.learning_rate, -self.lr_power
        old = torch._foreach_pow(accum, c)
        torch._foreach_addcmul_(accum, g, g)
        new = torch._foreach_pow(accum, c)
        sigma = torch._foreach_sub(new, old)
        torch._foreach_div_(sigma, lr)
        torch._foreach_add_(linear, g)
        torch._foreach_sub_(linear, torch._foreach_mul(sigma, w))
        quad = torch._foreach_div(new, lr)
        torch._foreach_add_(quad, 2.0 * self.l2)
        l1_part = torch._foreach_clamp_min(linear, -self.l1)
        torch._foreach_clamp_max_(l1_part, self.l1)
        torch._foreach_sub_(l1_part, linear)
        torch._foreach_div_(l1_part, quad)
        torch._foreach_copy_(w, l1_part)
        return params, {"neval": state["neval"] + 1,
                        "accum": state["accum"], "linear": state["linear"]}


class LarsSGD(SGD):
    """Layer-wise Adaptive Rate Scaling SGD (``:610-662``): each tensor's
    step is scaled by its trust ratio ``trust·‖w‖ / (‖g‖ + wd·‖w‖ + ε)``
    (1 for a tensor of norm 0), the RAW gradient's norm, then weight
    decay joins the gradient and momentum applies as ``v = μ·v +
    clr·ratio·g``, ``p -= v``."""

    def __init__(self, learning_rate: float = 1e-2, momentum: float = 0.9,
                 weight_decay: float = 0.0, trust: float = 0.001,
                 epsilon: float = 1e-9,
                 learning_rate_schedule: Optional[LearningRateSchedule] = None
                 ) -> None:
        super().__init__(learning_rate=learning_rate, momentum=momentum,
                         weight_decay=weight_decay,
                         learning_rate_schedule=learning_rate_schedule)
        self.trust = trust
        self.epsilon = epsilon

    def trust_ratios(self, grads: Tensors, params: Tensors) -> torch.Tensor:
        """The per-tensor ratios, in ``params``' order, as one tensor."""
        names = list(params)
        wn = torch.stack(torch._foreach_norm([params[k] for k in names]))
        gn = torch.stack(torch._foreach_norm([grads[k] for k in names]))
        ratio = self.trust * wn / (gn + self.weight_decay * wn + self.epsilon)
        return torch.where(wn > 0, ratio, 1.0)

    @torch.no_grad()
    def update(self, grads, state, params):
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        clr = self.learning_rate_schedule.lr(self.learning_rate,
                                             state["neval"])
        ratios = self.trust_ratios(grads, params).unbind(0)
        if self.weight_decay > 0:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        scaled = torch._foreach_mul(g, list(ratios))
        new_state = dict(state)
        if self.momentum > 0:
            vel = [state["velocity"][k] for k in names]
            torch._foreach_mul_(vel, self.momentum)
            torch._foreach_add_(vel, scaled, alpha=clr)
            step = vel
        else:
            step = torch._foreach_mul(scaled, clr)
        torch._foreach_sub_(p, step)
        new_state["neval"] = state["neval"] + 1
        return params, new_state


def load_jax_opt_state(model, state_np: Dict) -> Dict:
    """A JAX optimizer state (``{"neval", <slot>: tree, ...}`` of any
    method: Adam's ``m``/``v``, SGD's ``velocity``, Adagrad's ``accum``,
    Adadelta's ``accum``/``delta_accum``, Adamax's ``m``/``u``,
    RMSprop's ``sq``, Ftrl's ``accum``/``linear``; numpy trees in the JAX
    params layout) as the port's state for ``model``'s parameters: slot
    trees become ``{parameter name: tensor}`` on the model's device."""
    from bigdl_tpu_torch.utils.params_tree import named_leaves

    device = next(model.parameters()).device
    out: Dict = {"neval": int(np.asarray(state_np["neval"]))}
    for key, tree in state_np.items():
        if key == "neval":
            continue
        out[key] = {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
                    for n, a in named_leaves(model, tree).items()}
    return out
