"""Optimizer — the fluent trainer config, its factory and LocalOptimizer
(``bigdl_tpu/optim/optimizer.py``).

``Optimizer(model, dataset, criterion, batch_size, end_trigger, **kw)``
returns a ``DistriOptimizer`` (``optim/distri_optimizer.py``) for a
``DistributedDataSet`` or ``distributed=True``, else a
:class:`LocalOptimizer`, as the JAX factory dispatches; ``optimize()``
drives a thin host loop: fetch the next host batch, stage it onto the
card (:class:`bigdl_tpu_torch.optim.upload.PinnedUploader`: pinned
staging, a side stream and an event, so the upload of the next batch
overlaps the running step), run the step of
:func:`bigdl_tpu_torch.optim.train_step.make_train_step`, and read the
loss once (``float(loss)``, the one sync per step). After the step come,
where the JAX loop has them, the summaries, the epoch bookkeeping,
validation (whose first score feeds a ``Plateau`` schedule) and the
checkpoint. The state dict (``epoch``, ``neval``, ``seen``, ``loss``,
``score``) and the ``records/second`` and ``computing time`` metrics are
the JAX loop's.

Checkpoints (``set_checkpoint``, ``backend="pickle"``) are the JAX
``model``/``optimMethod`` snapshot pair, or ``model.N``/``optimMethod.N``
with ``overwrite_checkpoint`` off, with the JAX blob keys.
``optimize(resume=True)`` restores the newest pair into the live model,
matching parameters by child index (the names after each ``i:`` carry
instance counters that differ between builds), and replays the
deterministic data stream up to the checkpointed record, since each epoch
reshuffles by its index: the resumed run then equals an uninterrupted one.

Each step draws its stochastic layers' masks (``Dropout``) from a
``torch.Generator`` on the model's device seeded with
:func:`~bigdl_tpu_torch.optim.train_step.step_seed` of the base seed
(``set_seed``, default 0) and the iteration counter ``neval``, as JAX
folds ``neval`` into its base key: a resumed run draws the masks of an
uninterrupted one. The masks are not JAX's (another generator).

``set_train_summary``/``set_val_summary`` write TensorBoard scalars (and
``Parameters/...`` histograms on the summary's trigger) from values the
loop already reads; ``set_profile`` opens a ``torch.profiler`` window over
a range of iterations; ``set_device_preprocess`` maps each raw batch on
the card (the u8-NHWC feed); ``handle_preemption`` turns a SIGTERM into a
checkpoint and :class:`TrainingPreempted` at the next iteration boundary.

The loop calls the JAX loop's layout hooks where it calls them:
``_ckpt_params_to_host``/``_ckpt_opt_state_to_host`` before a checkpoint,
a summary histogram or a restore, ``_host_params_to_device``/
``_opt_state_to_device`` after a restore, ``_eval_forward`` for each
validation batch and ``_teardown`` when ``optimize()`` ends. They are
identities for :class:`LocalOptimizer`; ``DistriOptimizer`` maps its
partitioned or flat layout to the per-parameter one there, so every
checkpoint holds ``{parameter name: tensor}`` trees. At world size > 1
(``torch.distributed``) each rank writes under ``<path>/proc_<rank>`` with
a ``LATEST`` marker of its newest iteration, and a resume rolls back to
the iteration every rank holds (``_pod_common_neval``,
``_pod_rollback``) or refuses to start one rank fresh beside peers with
snapshots (``_assert_pod_peers_not_ahead``); validation results merge
across the ranks.

Not ported yet: the orbax checkpoint backends. The JAX loop retries a failed attempt from its last checkpoint; the port
raises on the first failure (``TrainingPreempted`` included), so a failing
kernel is never retried or hidden: resuming is the caller's explicit
``optimize(resume=True)``.
"""

from __future__ import annotations

import logging
import os
import pickle
import signal
import time
from typing import Any, Dict, List, Optional

import torch

from bigdl_tpu_torch.dataset.dataset import (
    AbstractDataSet, DataSet, DistributedDataSet,
)
from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.nn.tpu_fusion import FusedGraph
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.train_step import (
    make_eval_step, make_train_step, step_seed,
)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.upload import PinnedUploader
from bigdl_tpu_torch.optim.validation import ValidationMethod

logger = logging.getLogger("bigdl_tpu_torch")


class TrainingPreempted(RuntimeError):
    """Raised when training stops at an iteration boundary because a
    SIGTERM arrived under ``handle_preemption()``, after a final
    checkpoint was written. The restarted job continues with
    ``optimize(resume=True)``."""


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


class Optimizer:
    """Fluent training config; ``Optimizer(...)`` returns a Local or
    Distri optimizer by the dataset's type (reference factory
    semantics)."""

    def __new__(cls, model=None, dataset=None, criterion=None,
                batch_size: Optional[int] = None, end_trigger=None, **kw):
        if cls is Optimizer:
            if isinstance(dataset, DistributedDataSet) or \
                    kw.get("distributed", False):
                from bigdl_tpu_torch.optim.distri_optimizer import (
                    DistriOptimizer,
                )

                return object.__new__(DistriOptimizer)
            return object.__new__(LocalOptimizer)
        return object.__new__(cls)

    def __init__(self, model=None, dataset=None, criterion=None,
                 batch_size: Optional[int] = None, end_trigger=None,
                 **kw) -> None:
        kw.pop("distributed", None)
        if kw:
            logger.warning("%s ignores %s", type(self).__name__, sorted(kw))
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
        self.train_summary = None
        self.validation_summary = None
        self.grad_clip: Dict[str, Any] = {}
        self.compute_dtype = None
        self.loss_scale = 1.0
        self.metrics = Metrics()
        self._device_preprocess = None
        self._profile: Optional[Dict[str, Any]] = None
        self._handle_preemption = False
        self._preempt_flag = False
        self.seed = 0

    # -- fluent config (reference names, snake_case) -----------------------

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_seed(self, seed: int) -> "Optimizer":
        """The base seed of the steps' generators (default 0)."""
        self.seed = int(seed)
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

    def set_train_summary(self, summary) -> "Optimizer":
        """``Loss``, ``Throughput`` and ``LearningRate`` at every
        iteration, ``Parameters/...`` histograms when the summary's
        ``"Parameters"`` trigger fires (each reads the parameters to the
        host: the only added sync)."""
        self.train_summary = summary
        return self

    def set_val_summary(self, summary) -> "Optimizer":
        """One scalar per validation method at every validation."""
        self.validation_summary = summary
        return self

    def set_profile(self, trace_dir: str, start_iteration: int = 5,
                    n_iterations: int = 3) -> "Optimizer":
        """Trace iterations ``[start_iteration, start_iteration +
        n_iterations)`` with ``torch.profiler`` (CPU activity, and CUDA
        activity when the model is on the card) and export a Chrome-trace
        JSON file under ``trace_dir`` that Perfetto opens: the counterpart
        of the JAX loop's ``jax.profiler.start_trace``. A window the loop
        leaves early is closed and written at loop exit."""
        self._profile = {"dir": trace_dir, "start": start_iteration,
                         "stop": start_iteration + n_iterations}
        return self

    def set_device_preprocess(self, fn) -> "Optimizer":
        """``fn`` maps each raw input batch on the card before the forward
        pass (and before the compute-dtype cast), in training and in
        validation: pair it with ``NativeImagePipeline(output="u8_nhwc")``
        and its ``device_normalizer()``, so the host uploads uint8
        batches, a quarter of the f32 bytes."""
        self._device_preprocess = fn
        return self

    def handle_preemption(self, enabled: bool = True) -> "Optimizer":
        """While ``optimize()`` runs, a SIGTERM lets the in-flight
        iteration finish, writes a checkpoint (``set_checkpoint`` is
        required) and raises :class:`TrainingPreempted`; the restarted job
        continues with ``optimize(resume=True)``. The handler is installed
        from the main thread only, and the previous one comes back when
        ``optimize()`` returns or raises."""
        self._handle_preemption = bool(enabled)
        return self

    # -- layout hooks (identities here; DistriOptimizer maps its layout) --

    def _ckpt_params_to_host(self, params):
        return params

    def _host_params_to_device(self, params):
        return params

    def _ckpt_opt_state_to_host(self, opt_state):
        return opt_state

    def _opt_state_to_device(self, opt_state):
        return opt_state

    def _eval_forward(self, params, model_state, inp):
        """One validation batch through the eval step on ``params``."""
        if not hasattr(self, "_eval_step"):
            self._eval_step = make_eval_step(self.model,
                                             self._device_preprocess)
        (inp,) = self._upload(inp)
        return self._eval_step(params, model_state, inp)

    def _teardown(self) -> None:
        """Run when ``optimize()`` returns or raises."""

    def _step_seed(self, neval: int) -> int:
        """The seed of iteration ``neval``'s generator."""
        return step_seed(self.seed, neval)

    # -- checkpoints -------------------------------------------------------

    @staticmethod
    def _pod_rank():
        """(world size, rank) of the ``torch.distributed`` group; (1, 0)
        without one."""
        from bigdl_tpu_torch.utils.engine import world_and_rank

        return world_and_rank()

    def _ckpt_dir(self) -> Optional[str]:
        """The checkpoint directory: ``<path>/proc_<rank>`` at world size >
        1, so ranks given one shared path never write or restore each
        other's snapshots."""
        if not self.checkpoint_path:
            return self.checkpoint_path
        n, rank = self._pod_rank()
        if n > 1:
            return os.path.join(self.checkpoint_path, f"proc_{rank}")
        return self.checkpoint_path

    def _write_latest_marker(self, ckpt_dir: str, neval: int) -> None:
        """The newest snapshot's iteration, for peers to read at resume
        (written at world size > 1 only; atomic rename)."""
        tmp = os.path.join(ckpt_dir, f".LATEST.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(int(neval)))
        os.replace(tmp, os.path.join(ckpt_dir, "LATEST"))

    def _peer_latest_markers(self, exclude_rank=None) -> Dict[str, int]:
        """{``proc_<r>``: its LATEST iteration} under the shared path."""
        out = {}
        try:
            siblings = os.listdir(self.checkpoint_path)
        except OSError:
            return out
        for d in sorted(siblings):
            if not d.startswith("proc_") or d == f"proc_{exclude_rank}":
                continue
            try:
                with open(os.path.join(self.checkpoint_path, d,
                                       "LATEST")) as f:
                    out[d] = int(f.read().strip())
            except (OSError, ValueError):
                continue
        return out

    def _pod_common_neval(self, own_neval: int) -> int:
        """The iteration every rank can resume from: the least of the
        ranks' LATEST markers (ranks checkpoint on their own, so a kill can
        leave them at different iterations)."""
        if self._pod_rank()[0] <= 1:
            return own_neval
        markers = self._peer_latest_markers()
        if not markers:
            return own_neval
        return min([own_neval] + list(markers.values()))

    def _pod_rollback(self, own_neval: int, exists_fn, load_fn):
        """``load_fn(common)`` when this rank must roll back to the
        pod-wide common iteration, ``None`` when its own snapshot stands;
        raises when the ranks are skewed and the common snapshot is gone."""
        common = self._pod_common_neval(own_neval)
        if common == own_neval:
            return None
        if self.overwrite_checkpoint or not exists_fn(common):
            raise RuntimeError(
                f"pod resume: this rank's newest checkpoint is at "
                f"iteration {own_neval} but the pod-wide common iteration "
                f"is {common}, and no snapshot for it is retained "
                "(overwrite mode keeps one). Use overwrite_checkpoint=False "
                "on pods, or align the per-rank checkpoints manually.")
        try:
            result = load_fn(common)
        except Exception as e:
            raise RuntimeError(
                f"pod resume: the pod-common snapshot at iteration {common} "
                f"exists but is not restorable ({e!r}): align the per-rank "
                "checkpoints manually") from e
        logger.warning("pod resume: rolled back to the pod-common snapshot "
                       "at iteration %d", common)
        return result

    def _assert_pod_peers_not_ahead(self) -> None:
        """A rank with nothing to restore must not start fresh while its
        peers resume from snapshots."""
        n, rank = self._pod_rank()
        if n <= 1 or not self.checkpoint_path:
            return
        peers = self._peer_latest_markers(exclude_rank=rank)
        if peers:
            raise RuntimeError(
                f"pod resume: this rank (proc_{rank}) has no restorable "
                f"checkpoint but pod peers do ({peers}): starting fresh "
                "would skew the pod. Restore this rank's snapshot or clear "
                "every rank's checkpoints.")

    def _checkpoint(self, state, params, model_state, opt_state) -> None:
        """The JAX pickle pair; the ``model`` blob has ``Module.save``'s
        keys, so ``Module.load`` opens a checkpoint directly."""
        from bigdl_tpu_torch.utils.file_io import File

        ckpt_dir = self._ckpt_dir()
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
        if self._pod_rank()[0] > 1:
            self._write_latest_marker(ckpt_dir, state["neval"])

    def _latest_checkpoint(self):
        """(model blob, optimMethod blob) of the newest readable pair, or
        None."""
        from bigdl_tpu_torch.utils.file_io import File

        ckpt_dir = self._ckpt_dir()
        if not ckpt_dir or not os.path.isdir(ckpt_dir):
            self._assert_pod_peers_not_ahead()
            return None

        def snap_iter(f):
            # "model.12" outranks "model.9"; the overwrite-mode "model" is 0
            try:
                return float(f[len("model."):] or 0)
            except ValueError:
                return -1.0

        def load(tag):
            return (File.load(os.path.join(ckpt_dir, f"model{tag}")),
                    File.load(os.path.join(ckpt_dir, f"optimMethod{tag}")))

        models = sorted((f for f in os.listdir(ckpt_dir)
                         if f.startswith("model")), key=snap_iter)
        for f in reversed(models):         # newest first; skip torn ones
            tag = f[len("model"):]
            try:
                snap = load(tag)
            except (OSError, EOFError, pickle.UnpicklingError):
                logger.warning(
                    "resume: snapshot model%s is torn — trying older", tag)
                continue
            rolled = self._pod_rollback(
                int(snap[1]["neval"]),
                lambda c: os.path.exists(os.path.join(ckpt_dir,
                                                      f"model.{c}")),
                lambda c: load(f".{c}"))
            return snap if rolled is None else rolled
        self._assert_pod_peers_not_ahead()
        return None

    def _restore(self, snap, params, model_state, opt_state, state):
        """Copy a checkpoint into the step's tensors (through the layout
        hooks); returns the step's (params, opt_state)."""
        mblob, oblob = snap
        host_params = self._ckpt_params_to_host(params)
        host_opt = self._ckpt_opt_state_to_host(opt_state)
        with torch.no_grad():
            for live, restored, what in (
                    (host_params, mblob["params"], "params"),
                    (model_state, mblob["state"], "model_state")):
                for k, v in _match_by_index(live, restored, what).items():
                    live[k].copy_(v)
            for key, live in host_opt.items():
                restored = oblob["opt_state"][key]
                if isinstance(live, dict):
                    for k, v in _match_by_index(
                            live, restored, f"opt_state[{key!r}]").items():
                        live[k].copy_(v)
                else:
                    host_opt[key] = restored
        state["epoch"] = oblob["epoch"]
        state["neval"] = oblob["neval"]
        state["seen"] = oblob.get("seen", 0)
        logger.info("resumed from checkpoint at iteration %d", state["neval"])
        return (self._host_params_to_device(host_params),
                self._opt_state_to_device(host_opt))

    # -- validation --------------------------------------------------------

    def _run_validation(self, params, model_state, state) -> Optional[float]:
        """Score the validation set with the step's parameters in eval
        mode; returns the first method's value (fed to ``Plateau``). At
        world size > 1 each rank scores its own validation data and the
        results merge across the ranks (a collective: every rank joins,
        with an empty result where its shard gave no batch)."""
        if not (self.validation_dataset and self.validation_methods):
            return None
        totals = [None] * len(self.validation_methods)
        self.model.eval()
        try:
            for batch in self.validation_dataset.data(train=False):
                out = self._eval_forward(params, model_state,
                                         batch.get_input())
                for i, m in enumerate(self.validation_methods):
                    r = m.apply(out, batch.get_target())
                    totals[i] = r if totals[i] is None else totals[i] + r
        finally:
            self.model.train()
        multi = self._pod_rank()[0] > 1
        score = None
        for m, r in zip(self.validation_methods, totals):
            if r is None:
                if not multi:
                    continue
                r = m.empty_result()
            r = r.merge_across_processes()
            val, n_scored = r.result()
            if multi and n_scored == 0:
                continue
            logger.info("validation [%s] epoch %d iter %d: %s",
                        m.name, state["epoch"], state["neval"], r)
            if self.validation_summary is not None:
                self.validation_summary.add_scalar(m.name, val,
                                                   state["neval"])
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
        if self._handle_preemption and not self.checkpoint_path:
            raise ValueError(
                "handle_preemption() needs set_checkpoint(...) configured: "
                "an eviction with nowhere to write the final snapshot "
                "would lose all progress")
        self.model.train()          # the reference's model.training()
        prev_sigterm, installed = None, False
        if self._handle_preemption:
            self._preempt_flag = False

            def on_sigterm(signum, frame):
                logger.warning(
                    "SIGTERM received: finishing the current iteration, "
                    "checkpointing, then stopping (TrainingPreempted)")
                self._preempt_flag = True

            try:        # a handler installs from the main thread only
                prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
                installed = True
            except ValueError:
                logger.warning("handle_preemption: not on the main thread, "
                               "SIGTERM hook not installed")
        try:
            return self._optimize_loop(resume)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, prev_sigterm)
            self._stop_profile()     # the loop ended inside the window
            self._teardown()

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
                params, opt_state = self._restore(snap, params, model_state,
                                                  opt_state, state)
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
        # reseeded every iteration from (seed, neval)
        gen = torch.Generator(device=self._device)

        while not self.end_when(state):
            if self._preempt_flag:
                self._checkpoint(state, self._ckpt_params_to_host(params),
                                 model_state,
                                 self._ckpt_opt_state_to_host(opt_state))
                raise TrainingPreempted(
                    f"evicted at iteration {state['neval']}; checkpoint "
                    f"written to {self.checkpoint_path}")
            state["epoch_finished"] = False
            if self._profile is not None:
                self._profile_window(state["neval"])
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
            gen.manual_seed(self._step_seed(state["neval"]))
            params, opt_state, model_state, loss = step(
                params, opt_state, model_state, gen, inp, tgt)
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
            rate = bsz / max(dt, 1e-9)
            self.metrics.add("computing time", dt)
            self.metrics.add("records/second", rate)
            state["loss"] = loss_f
            state["neval"] += 1
            self.optim_method.state["neval"] = state["neval"]
            seen_this_epoch += bsz
            state["seen"] = seen_this_epoch
            if self.train_summary is not None:
                self._summarize(params, state, loss_f, rate)
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
                self._checkpoint(state, self._ckpt_params_to_host(params),
                                 model_state,
                                 self._ckpt_opt_state_to_host(opt_state))

        self._writeback(params, opt_state, model_state)
        return self.model

    def _summarize(self, params, state, loss: float, throughput: float):
        """The JAX loop's train-summary block, at iteration ``neval - 1``."""
        it = state["neval"] - 1
        ts = self.train_summary
        ts.add_scalar("Loss", loss, it)
        ts.add_scalar("Throughput", throughput, it)
        sched = getattr(self.optim_method, "learning_rate_schedule", None)
        base_lr = getattr(self.optim_method, "learning_rate", None)
        if sched is not None and base_lr is not None:
            # the optim state's neval counts from 0, the host's from 1: the
            # rate just applied was sched.lr(neval - 2)
            ts.add_scalar("LearningRate",
                          float(sched.lr(base_lr, max(0, state["neval"] - 2))),
                          it)
        if ts.should_record("Parameters", state):
            # a FusedGraph shares its graph's tree in JAX: no "graph" level
            strip = "graph." if isinstance(self.model, FusedGraph) else ""
            for name, p in self._ckpt_params_to_host(params).items():
                tag = name[len(strip):] if name.startswith(strip) else name
                ts.add_histogram("Parameters/" + tag.replace(".", "/"), p,
                                 it)

    def _profile_window(self, neval: int) -> None:
        """Open the profile at the window's first iteration, close it at
        the first one after."""
        if neval == self._profile["start"]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self._device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profile["active"] = profile(activities=acts)
            self._profile["active"].start()
        elif neval == self._profile["stop"]:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """Close an open profile window and write its Chrome trace."""
        prof = (self._profile or {}).pop("active", None)
        if prof is None:
            return
        prof.stop()
        os.makedirs(self._profile["dir"], exist_ok=True)
        path = os.path.join(
            self._profile["dir"], f"iterations_{self._profile['start']}-"
            f"{self._profile['stop'] - 1}.pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info("profile of iterations [%d, %d) written to %s",
                    self._profile["start"], self._profile["stop"], path)

class LocalOptimizer(Optimizer):
    """Single-process trainer driving the model's device with one step
    function (reference ``LocalOptimizer``)."""

    def _prepare(self):
        device = self._device = next(self.model.parameters()).device
        # fresh buffers: the step updates them in place, and the module's
        # own parameters change only at the write-back
        params = {k: p.detach().clone()
                  for k, p in self.model.named_parameters()}
        model_state = {k: b.detach().clone()
                       for k, b in self.model.named_buffers()}
        opt_state = self.optim_method.init_state(params)
        step = make_train_step(self.model, self.criterion, self.optim_method,
                               self.grad_clip, loss_scale=self.loss_scale,
                               compute_dtype=self.compute_dtype,
                               device_preprocess=self._device_preprocess)
        self._upload = PinnedUploader(device)

        def place_batch(batch: MiniBatch):
            return self._upload(batch.get_input(), batch.get_target())

        return step, place_batch, params, opt_state, model_state

    def _writeback(self, params, opt_state, model_state) -> None:
        """Store the trained weights in the module's parameters."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(params[k])
            for k, b in self.model.named_buffers():
                b.copy_(model_state[k])
        self._final_opt_state = opt_state
