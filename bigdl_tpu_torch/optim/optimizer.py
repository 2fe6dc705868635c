"""Optimizer — the fluent trainer config, its factory and LocalOptimizer
(``bigdl_tpu/optim/optimizer.py``).

``Optimizer(model, dataset, criterion, batch_size, end_trigger)`` returns
a :class:`LocalOptimizer` (the only kind ported so far); ``optimize()``
drives a thin host loop: fetch the next host batch, move it to the card,
run the step of :func:`bigdl_tpu_torch.optim.train_step.make_train_step`,
fetch the following batch while the step runs, and read the loss once
(``float(loss)``, the one sync per step). After the step come, where the
JAX loop has them, the epoch bookkeeping, validation (whose first score
feeds a ``Plateau`` schedule) and the checkpoint. The state dict
(``epoch``, ``neval``, ``seen``, ``loss``, ``score``) and the
``records/second`` and ``computing time`` metrics are the JAX loop's.

Checkpoints (``set_checkpoint``, ``backend="pickle"``) are the JAX
``model``/``optimMethod`` snapshot pair, or ``model.N``/``optimMethod.N``
with ``overwrite_checkpoint`` off, with the JAX blob keys.
``optimize(resume=True)`` restores the newest pair into the live model,
matching parameters by child index (the names after each ``i:`` carry
instance counters that differ between builds), and replays the
deterministic data stream up to the checkpointed record, since each epoch
reshuffles by its index: the resumed run then equals an uninterrupted one.

Not ported yet (they raise): summaries (``set_train_summary``,
``set_val_summary``), ``set_profile``, ``set_device_preprocess``,
``handle_preemption``, the orbax checkpoint backends, the pod rank
directories and ``LATEST`` markers, and the JAX factory's
``DistriOptimizer`` branch. The JAX loop retries a failed attempt from
its last checkpoint; the port raises on the first failure, so a failing
kernel is never retried or hidden: resuming is the caller's explicit
``optimize(resume=True)``.
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet, DataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.evaluator import to_device
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.train_step import make_eval_step, make_train_step
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod

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


def _index_key(name: str) -> str:
    """A parameter name with the module names dropped from its
    ``i:name`` parts: ``"8:fc1.weight"`` → ``"8.weight"``."""
    return ".".join(part.split(":", 1)[0] for part in name.split("."))


def _match_by_index(live: Dict[str, Any], restored: Dict[str, Any],
                    what: str) -> Dict[str, Any]:
    """``restored`` re-keyed to ``live``'s names, pairing entries by child
    index; the two must hold the same leaves with the same shapes."""
    if set(live) == set(restored):
        pairs = {k: restored[k] for k in live}
    else:
        by_index = {_index_key(k): v for k, v in restored.items()}
        pairs = {k: by_index.get(_index_key(k)) for k in live}
        if len(by_index) != len(restored) or len(restored) != len(live) \
                or any(v is None for v in pairs.values()):
            raise ValueError(
                f"checkpoint {what} {sorted(restored)} does not match the "
                f"model's {sorted(live)} by child index — different "
                "architecture")
        logger.info("resume: %s names differ from the live model "
                    "(rebuilt module names); matched by child index", what)
    for k, v in pairs.items():
        if tuple(v.shape) != tuple(live[k].shape):
            raise ValueError(
                f"checkpoint {what} {k} has shape {tuple(v.shape)} but the "
                f"model expects {tuple(live[k].shape)} — different "
                "architecture")
    return pairs


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
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.overwrite_checkpoint = True
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset: Optional[AbstractDataSet] = None
        self.validation_methods: List[ValidationMethod] = []
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

    def set_checkpoint(self, path: str = None, trigger: Trigger = None,
                       backend: str = "pickle",
                       checkpoint_trigger: Trigger = None,
                       checkpoint_path: str = None) -> "Optimizer":
        """Write the ``model``/``optimMethod`` snapshot pair under ``path``
        whenever ``trigger`` fires. Scala order ``(path, trigger)``, the
        pyspark positional order ``(trigger, path)`` and the pyspark
        keywords are all accepted, as in JAX."""
        if isinstance(path, Trigger):          # pyspark positional order
            path, trigger = trigger, path
        if checkpoint_trigger is not None:
            trigger = checkpoint_trigger
        if checkpoint_path is not None:
            path = checkpoint_path
        if path is None or trigger is None:
            raise ValueError("set_checkpoint needs both a path and a trigger")
        if backend in ("orbax", "orbax_async"):
            raise NotImplementedError(
                f"checkpoint backend {backend!r} (the JAX ecosystem's "
                "format) is not ported; use backend='pickle'")
        if backend != "pickle":
            raise ValueError(f"unknown checkpoint backend {backend!r}")
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def over_write_checkpoint(self) -> "Optimizer":
        self.overwrite_checkpoint = True
        return self

    def set_validation(self, trigger, dataset=None, methods=None,
                       batch_size: Optional[int] = None,
                       val_rdd=None, val_method=None) -> "Optimizer":
        """Scala order ``(trigger, dataset, methods, batch_size)``; the
        pyspark order ``set_validation(batch_size, val_rdd, trigger,
        val_method)`` is also accepted (an int first argument). Every
        validation record is scored: the trailing partial batch stays."""
        if isinstance(trigger, int):            # pyspark positional order
            batch_size, dataset, trigger, methods = (
                trigger, dataset, methods, batch_size)
        if val_rdd is not None:
            dataset = val_rdd
        if val_method is not None:
            methods = val_method
        self.validation_trigger = trigger
        self.validation_dataset = _ensure_dataset(dataset, batch_size,
                                                  drop_remainder=False)
        self.validation_methods = list(methods)
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

    set_train_summary = _not_ported("set_train_summary")
    set_val_summary = _not_ported("set_val_summary")
    set_profile = _not_ported("set_profile")
    set_device_preprocess = _not_ported("set_device_preprocess")
    handle_preemption = _not_ported("handle_preemption")

    # -- checkpoints -------------------------------------------------------

    def _checkpoint(self, state, params, model_state, opt_state) -> None:
        """The JAX pickle pair; the ``model`` blob has ``Module.save``'s
        keys, so ``Module.load`` opens a checkpoint directly."""
        from bigdl_tpu_torch.utils.file_io import File

        ckpt_dir = self.checkpoint_path
        tag = "" if self.overwrite_checkpoint else f".{state['neval']}"
        os.makedirs(ckpt_dir, exist_ok=True)
        File.save({"params": params, "state": model_state,
                   "module": self.model},
                  os.path.join(ckpt_dir, f"model{tag}"), over_write=True)
        File.save({"method": self.optim_method, "opt_state": opt_state,
                   "epoch": state["epoch"], "neval": state["neval"],
                   "seen": state.get("seen", 0)},
                  os.path.join(ckpt_dir, f"optimMethod{tag}"),
                  over_write=True)

    def _latest_checkpoint(self):
        """(model blob, optimMethod blob) of the newest readable pair, or
        None."""
        from bigdl_tpu_torch.utils.file_io import File

        ckpt_dir = self.checkpoint_path
        if not ckpt_dir or not os.path.isdir(ckpt_dir):
            return None

        def snap_iter(f):
            # "model.12" outranks "model.9"; the overwrite-mode "model" is 0
            try:
                return float(f[len("model."):] or 0)
            except ValueError:
                return -1.0

        models = sorted((f for f in os.listdir(ckpt_dir)
                         if f.startswith("model")), key=snap_iter)
        for f in reversed(models):         # newest first; skip torn ones
            tag = f[len("model"):]
            try:
                return (File.load(os.path.join(ckpt_dir, f"model{tag}")),
                        File.load(os.path.join(ckpt_dir,
                                               f"optimMethod{tag}")))
            except (OSError, EOFError, pickle.UnpicklingError):
                logger.warning(
                    "resume: snapshot model%s is torn — trying older", tag)
        return None

    def _restore(self, snap, params, model_state, opt_state, state) -> None:
        """Copy a checkpoint into the step's tensors, in place."""
        mblob, oblob = snap
        with torch.no_grad():
            for live, restored, what in (
                    (params, mblob["params"], "params"),
                    (model_state, mblob["state"], "model_state")):
                for k, v in _match_by_index(live, restored, what).items():
                    live[k].copy_(v)
            for key, live in opt_state.items():
                restored = oblob["opt_state"][key]
                if isinstance(live, dict):
                    for k, v in _match_by_index(
                            live, restored, f"opt_state[{key!r}]").items():
                        live[k].copy_(v)
                else:
                    opt_state[key] = restored
        state["epoch"] = oblob["epoch"]
        state["neval"] = oblob["neval"]
        state["seen"] = oblob.get("seen", 0)
        logger.info("resumed from checkpoint at iteration %d", state["neval"])

    # -- validation --------------------------------------------------------

    def _run_validation(self, params, model_state, state) -> Optional[float]:
        """Score the validation set with the step's parameters in eval
        mode; returns the first method's value (fed to ``Plateau``)."""
        if not (self.validation_dataset and self.validation_methods):
            return None
        if not hasattr(self, "_eval_step"):
            self._eval_step = make_eval_step(self.model)
        device = next(iter(params.values())).device
        totals = [None] * len(self.validation_methods)
        self.model.eval()
        try:
            for batch in self.validation_dataset.data(train=False):
                out = self._eval_step(params, model_state,
                                      to_device(batch.get_input(), device))
                for i, m in enumerate(self.validation_methods):
                    r = m.apply(out, batch.get_target())
                    totals[i] = r if totals[i] is None else totals[i] + r
        finally:
            self.model.train()
        score = None
        for m, r in zip(self.validation_methods, totals):
            if r is None:
                continue
            val, _ = r.result()
            logger.info("validation [%s] epoch %d iter %d: %s",
                        m.name, state["epoch"], state["neval"], r)
            if score is None:
                score = val
        sched = getattr(self.optim_method, "learning_rate_schedule", None)
        if score is not None and hasattr(sched, "record_score"):
            sched.record_score(score)
        return score

    # -- the driver loop ---------------------------------------------------

    def _state0(self) -> Dict[str, Any]:
        return {"epoch": int(self.optim_method.state.get("epoch", 1)),
                "neval": int(self.optim_method.state.get("neval", 1)),
                "loss": None, "score": None, "epoch_finished": False}

    def optimize(self, resume: bool = False):
        """Train until ``end_when`` fires; returns the model with the
        trained weights written back. ``resume=True`` first restores the
        newest checkpoint under ``set_checkpoint``'s path (no path or no
        checkpoint: a fresh start, as in JAX). Raises on the first
        failure."""
        self.model.train()          # the reference's model.training()
        return self._optimize_loop(resume)

    def _prepare(self):
        """Returns (step, place_batch, params, opt_state, model_state)."""
        raise NotImplementedError

    def _writeback(self, params, opt_state, model_state) -> None:
        raise NotImplementedError

    def _optimize_loop(self, resume: bool = False):
        step, place_batch, params, opt_state, model_state = self._prepare()
        state = self._state0()
        if resume:
            snap = self._latest_checkpoint()
            if snap is not None:
                self._restore(snap, params, model_state, opt_state, state)
        data_iter = self.dataset.data(train=True)
        epoch_size = self.dataset.size()
        seen_this_epoch = 0
        if resume and state["neval"] > 1:
            # replay the deterministic stream up to the checkpointed
            # record: epochs reshuffle by their index, so whole epochs
            # are replayed, not skipped
            target = (state["epoch"] - 1) * epoch_size + state.get("seen", 0)
            skipped = 0
            while skipped < target:
                try:
                    skipped += next(data_iter).size()
                except StopIteration:
                    raise ValueError(
                        f"cannot resume: the data stream ended after "
                        f"{skipped} records but the checkpoint was taken "
                        f"{target} records in — the dataset is smaller (or "
                        f"differently sized) than the one that wrote the "
                        f"checkpoint") from None
            seen_this_epoch = state.get("seen", 0)
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
            if self.validation_trigger is not None and \
                    self.validation_trigger(state):
                score = self._run_validation(params, model_state, state)
                if score is not None:
                    state["score"] = score
            if self.checkpoint_trigger is not None and \
                    self.checkpoint_trigger(state):
                self._checkpoint(state, params, model_state, opt_state)

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

        def place_batch(batch: MiniBatch):
            return (to_device(batch.get_input(), device),
                    to_device(batch.get_target(), device))

        return step, place_batch, params, opt_state, model_state

    def _writeback(self, params, opt_state, model_state) -> None:
        """Store the trained weights in the module's parameters."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(params[k])
            for k, b in self.model.named_buffers():
                b.copy_(model_state[k])
        self._final_opt_state = opt_state
