"""Optimizer — the fluent trainer config, its factory and LocalOptimizer
(``bigdl_tpu/optim/optimizer.py``).

``Optimizer(model, dataset, criterion, batch_size, end_trigger)`` returns
a :class:`LocalOptimizer` (the only kind ported so far); ``optimize()``
drives a thin host loop: fetch the next host batch, move it to the card,
run the step of :func:`bigdl_tpu_torch.optim.train_step.make_train_step`,
fetch the following batch while the step runs, and read the loss once
(``float(loss)``, the one sync per step). The state dict (``epoch``,
``neval``, ``seen``, ``loss``) and the ``records/second`` and ``computing
time`` metrics are the JAX loop's.

Not ported yet (the setters raise ``NotImplementedError``): checkpoints
and ``optimize(resume=True)``, validation, summaries, preemption
handling, profiling, device preprocessing, and the JAX factory's
``DistriOptimizer`` branch. The JAX loop retries a failed
attempt from its last checkpoint; with no checkpoints, ``optimize()``
raises on the first failure, so a failing kernel is never retried or
hidden.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, DataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.train_step import make_train_step
from bigdl_tpu_torch.optim.trigger import Trigger

logger = logging.getLogger("bigdl_tpu_torch")


def _ensure_dataset(dataset, batch_size: Optional[int],
                    drop_remainder: bool = True) -> AbstractDataSet:
    if dataset is None:
        raise ValueError(
            "Optimizer requires a dataset (pass dataset=...; a raw Sample "
            "sequence also needs batch_size=...)")
    if not isinstance(dataset, AbstractDataSet):
        if batch_size is None:
            raise ValueError("batch_size required when passing raw samples")
        dataset = DataSet.array(list(dataset))
    if batch_size is not None:
        # a Sample dataset is batched here; one that already yields
        # MiniBatches passes through
        probe = next(iter(dataset.data(train=False)), None)
        if isinstance(probe, Sample):
            dataset = dataset.transform(
                SampleToMiniBatch(batch_size, drop_remainder=drop_remainder))
    return dataset


def _not_ported(what: str):
    def refuse(self, *args, **kwargs):
        raise NotImplementedError(f"Optimizer.{what} is not ported yet")

    refuse.__name__ = what
    return refuse


class Optimizer:
    """Fluent training config; ``Optimizer(...)`` returns a
    :class:`LocalOptimizer` (reference factory semantics)."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(LocalOptimizer if cls is Optimizer else cls)

    def __init__(self, model=None, dataset=None, criterion=None,
                 batch_size: Optional[int] = None, end_trigger=None) -> None:
        self.model = model
        self.dataset = _ensure_dataset(dataset, batch_size)
        self.criterion = criterion
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = end_trigger or Trigger.max_epoch(1)
        self.grad_clip: Dict[str, Any] = {}
        self.compute_dtype = None
        self.loss_scale = 1.0
        self.metrics = Metrics()

    # -- fluent config (reference names, snake_case) -----------------------

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_compute_dtype(self, dtype) -> "Optimizer":
        """Mixed precision: forward/backward in ``"bf16"``/``"fp16"``,
        master weights, optimizer state and loss in f32. fp16 needs
        :meth:`set_loss_scale`."""
        self.compute_dtype = dtype
        if dtype in ("fp16", "float16") and self.loss_scale == 1.0:
            logger.warning(
                "fp16 compute without loss scaling will underflow small "
                "gradients; call set_loss_scale(e.g. 1024.0)")
        return self

    def set_loss_scale(self, scale: float) -> "Optimizer":
        """Static loss scaling (loss × scale before the backward pass,
        gradients ÷ scale after)."""
        self.loss_scale = float(scale)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float
                                         ) -> "Optimizer":
        self.grad_clip["l2_norm"] = clip_norm
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float
                                       ) -> "Optimizer":
        self.grad_clip["constant"] = (min_v, max_v)
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self.grad_clip = {}
        return self

    set_checkpoint = _not_ported("set_checkpoint")
    set_validation = _not_ported("set_validation")
    set_train_summary = _not_ported("set_train_summary")
    set_val_summary = _not_ported("set_val_summary")
    set_profile = _not_ported("set_profile")
    set_device_preprocess = _not_ported("set_device_preprocess")
    handle_preemption = _not_ported("handle_preemption")

    # -- the driver loop ---------------------------------------------------

    def _state0(self) -> Dict[str, Any]:
        return {"epoch": int(self.optim_method.state.get("epoch", 1)),
                "neval": int(self.optim_method.state.get("neval", 1)),
                "loss": None, "epoch_finished": False}

    def optimize(self, resume: bool = False):
        """Train until ``end_when`` fires; returns the model with the
        trained weights written back. Raises on the first failure."""
        if resume:
            raise NotImplementedError(
                "optimize(resume=True) needs checkpoints, not ported yet")
        return self._optimize_once()

    def _prepare(self):
        """Returns (step, place_batch, params, opt_state, model_state)."""
        raise NotImplementedError

    def _writeback(self, params, opt_state, model_state) -> None:
        raise NotImplementedError

    def _optimize_once(self):
        self.model.train()          # the reference's model.training()
        return self._optimize_loop()

    def _optimize_loop(self):
        step, place_batch, params, opt_state, model_state = self._prepare()
        state = self._state0()
        data_iter = self.dataset.data(train=True)
        epoch_size = self.dataset.size()
        seen_this_epoch = 0
        next_ready = None            # (inp, tgt, bsz) placed ahead of time
        epoch_start = time.time()

        while not self.end_when(state):
            state["epoch_finished"] = False
            if next_ready is None:
                try:
                    b = next(data_iter)
                except StopIteration:
                    logger.warning(
                        "data iterator exhausted before end_when fired; "
                        "stopping")
                    break
                next_ready = (*place_batch(b), b.size())
            inp, tgt, bsz = next_ready
            t0 = time.time()
            params, opt_state, model_state, loss = step(
                params, opt_state, model_state, None, inp, tgt)
            # the next batch is fetched and placed while the step runs on
            # the card, but only when the loop will run again
            spec = dict(state)
            spec["neval"] += 1
            spec["epoch_finished"] = seen_this_epoch + bsz >= epoch_size
            if spec["epoch_finished"]:
                spec["epoch"] += 1
            if self.end_when.peek(spec):
                next_ready = None
            else:
                try:
                    b = next(data_iter)
                    next_ready = (*place_batch(b), b.size())
                except StopIteration:
                    next_ready = None
            loss_f = float(loss)
            dt = time.time() - t0
            self.metrics.add("computing time", dt)
            self.metrics.add("records/second", bsz / max(dt, 1e-9))
            state["loss"] = loss_f
            state["neval"] += 1
            self.optim_method.state["neval"] = state["neval"]
            seen_this_epoch += bsz
            state["seen"] = seen_this_epoch
            if seen_this_epoch >= epoch_size:
                state["epoch_finished"] = True
                logger.info(
                    "epoch %d done: %d records in %.1fs, last loss %.4f",
                    state["epoch"], seen_this_epoch,
                    time.time() - epoch_start, loss_f)
                state["epoch"] += 1
                self.optim_method.state["epoch"] = state["epoch"]
                seen_this_epoch = 0
                state["seen"] = 0
                epoch_start = time.time()

        self._writeback(params, opt_state, model_state)
        return self.model


class LocalOptimizer(Optimizer):
    """Single-process trainer driving the model's device with one step
    function (reference ``LocalOptimizer``)."""

    def _prepare(self):
        device = next(self.model.parameters()).device
        # fresh buffers: the step updates them in place, and the module's
        # own parameters change only at the write-back
        params = {k: p.detach().clone()
                  for k, p in self.model.named_parameters()}
        model_state = {k: b.detach().clone()
                       for k, b in self.model.named_buffers()}
        opt_state = self.optim_method.init_state(params)
        step = make_train_step(self.model, self.criterion, self.optim_method,
                               self.grad_clip, loss_scale=self.loss_scale,
                               compute_dtype=self.compute_dtype)

        def to_device(x):
            if isinstance(x, (list, tuple)):
                return [to_device(v) for v in x]
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                device, non_blocking=True)

        def place_batch(batch: MiniBatch):
            return to_device(batch.get_input()), to_device(batch.get_target())

        return step, place_batch, params, opt_state, model_state

    def _writeback(self, params, opt_state, model_state) -> None:
        """Store the trained weights in the module's parameters."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(params[k])
            for k, b in self.model.named_buffers():
                b.copy_(model_state[k])
        self._final_opt_state = opt_state
