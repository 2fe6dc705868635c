"""Evaluator / Predictor — batched inference on one device
(``bigdl_tpu/optim/evaluator.py:26-50``, ``:92-178``).

Each batch goes to the model's device, runs through
:func:`bigdl_tpu_torch.optim.train_step.make_eval_step` on the module's
own parameters and buffers in eval mode, and is scored by the
ValidationMethods (``Evaluator.test``) or brought back to the host
(``Predictor``). Every record counts: a dataset keeps its trailing
partial batch. A ``device_preprocess`` (the twin of
``Optimizer.set_device_preprocess``) maps each raw batch on the device
first, so a model trained on the u8-NHWC feed is scored on the same
feed.

With ``mesh=`` (a ``DeviceMesh`` over the ranks of a process group,
``Engine.mesh()``) every rank is handed the same batches and scores them
together, the counterpart of JAX's batch sharded over the mesh's
``data`` axis (``bigdl_tpu/optim/evaluator.py:52-89``):
:func:`make_sharded_eval_step` runs each rank's contiguous 1/n of the
rows and all-gathers the outputs, so every rank holds the whole output;
:func:`pad_shard_call` first pads a batch whose rows do not divide n
(repeating row 0) and trims the outputs after.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.sample import MiniBatch, Sample, stack_samples
from bigdl_tpu_torch.optim.train_step import make_eval_step
from bigdl_tpu_torch.optim.validation import (
    ValidationMethod, ValidationResult, to_host,
)


def _batches(data, batch_size: int):
    """Samples / arrays / DataSets / MiniBatches → a MiniBatch stream."""
    if isinstance(data, MiniBatch):
        yield data
        return
    if hasattr(data, "data") and callable(getattr(data, "data")):  # DataSet
        from bigdl_tpu_torch.optim.optimizer import _ensure_dataset

        yield from _ensure_dataset(
            data, batch_size, drop_remainder=False).data(train=False)
        return
    items = list(data) if not isinstance(data, (list, tuple)) else data
    if items and isinstance(items[0], MiniBatch):
        yield from items
        return
    if items and isinstance(items[0], Sample):
        for i in range(0, len(items), batch_size):
            yield stack_samples(items[i:i + batch_size])
    else:  # raw feature arrays
        arr = np.asarray(items, np.float32)
        for i in range(0, len(arr), batch_size):
            yield MiniBatch(arr[i:i + batch_size])


def to_device(x, device):
    """Host arrays (or lists of them) → tensors on ``device``."""
    if isinstance(x, (list, tuple)):
        return [to_device(v, device) for v in x]
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device,
                                                        non_blocking=True)


def _n_rows(inp) -> int:
    return (inp[0] if isinstance(inp, (list, tuple)) else inp).shape[0]


def _rows(x, lo: int, hi: int):
    return [v[lo:hi] for v in x] if isinstance(x, (list, tuple)) \
        else x[lo:hi]


def make_sharded_eval_step(model, mesh, device_preprocess=None):
    """``step(params, model_state, inp)`` for every rank of ``mesh``
    holding the same batch ``inp`` (its rows a multiple of the mesh
    size): the rank runs its contiguous share of the rows through the
    eval step and the outputs are all-gathered, so each rank returns the
    output of the whole batch. ``device_preprocess`` runs on the rank's
    raw rows first, as in the training step."""
    from bigdl_tpu_torch.parallel.all_reduce import all_gather_into

    group = mesh.get_group(0)
    n, rank = mesh.size(), mesh.get_local_rank(0)
    local = make_eval_step(model, device_preprocess)

    def gather(out):
        if isinstance(out, (list, tuple)):
            return type(out)(gather(o) for o in out)
        full = out.new_empty((n * out.shape[0],) + tuple(out.shape[1:]))
        return all_gather_into(full, out.contiguous(), group)

    def step(params, model_state, inp):
        k = _n_rows(inp) // n
        device = next(iter(params.values())).device
        mine = to_device(_rows(inp, rank * k, (rank + 1) * k), device)
        return gather(local(params, model_state, mine))

    return step


def pad_shard_call(step, n_dev: int, params, model_state, inp):
    """``step`` on a batch whose rows need not divide ``n_dev``: pad the
    rows (repeating row 0) to a multiple, call, trim the outputs."""
    n = _n_rows(inp)
    pad = (-n) % n_dev
    if not pad:
        return step(params, model_state, inp)

    def pad_rows(x):
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
        x = np.asarray(x)
        return np.concatenate([x, np.repeat(x[:1], pad, axis=0)])

    inp = ([pad_rows(v) for v in inp] if isinstance(inp, (list, tuple))
           else pad_rows(inp))
    out = step(params, model_state, inp)
    return ([o[:n] for o in out] if isinstance(out, (list, tuple))
            else out[:n])


class Evaluator:
    """Batched evaluation of a model against ValidationMethods (reference
    ``Evaluator(model).test(dataset, methods, batchSize)``)."""

    def __init__(self, model, mesh=None, device_preprocess=None) -> None:
        """``device_preprocess`` mirrors ``Optimizer.set_device_preprocess``:
        raw (e.g. uint8-NHWC) batches reach the model through it. With
        ``mesh`` the ranks share each batch (module docstring)."""
        self.model = model
        self.mesh = mesh
        self.device_preprocess = device_preprocess
        self._step = (make_eval_step(model, device_preprocess) if mesh is None
                      else make_sharded_eval_step(model, mesh,
                                                  device_preprocess))

    def _forward(self, inp):
        m = self.model
        params, buffers = dict(m.named_parameters()), dict(m.named_buffers())
        if self.mesh is not None:
            return pad_shard_call(self._step, self.mesh.size(), params,
                                  buffers, inp)
        return self._step(params, buffers, to_device(inp, m._facade_device()))

    def test(self, dataset, methods: Sequence[ValidationMethod],
             batch_size: int = 32) -> List[ValidationResult]:
        """Scores every record; leaves the model in eval mode, as the
        JAX evaluator does."""
        self.model.evaluate()
        totals: List[Optional[ValidationResult]] = [None] * len(methods)
        for batch in _batches(dataset, batch_size):
            out = self._forward(batch.get_input())
            tgt = batch.get_target()
            for i, m in enumerate(methods):
                r = m.apply(out, tgt)
                totals[i] = r if totals[i] is None else totals[i] + r
        return [t for t in totals if t is not None]


class Predictor:
    """Batched prediction (reference ``Predictor.predict/predictClass``)."""

    def __init__(self, model, mesh=None, device_preprocess=None) -> None:
        self._ev = Evaluator(model, mesh=mesh,
                             device_preprocess=device_preprocess)
        self.model = model

    @staticmethod
    def _host(o, n: int) -> np.ndarray:
        """The output on the host; a Reshape head that took a batch-1
        tail's batch dim away gets it back, so batches concatenate."""
        a = to_host(o)
        return a[None] if (a.ndim == 0 or a.shape[0] != n) else a

    def predict(self, data, batch_size: int = 32):
        self.model.evaluate()
        outs = []
        for b in _batches(data, batch_size):
            n = b.size()
            o = self._ev._forward(b.get_input())
            outs.append([self._host(x, n) for x in o]
                        if isinstance(o, (list, tuple)) else self._host(o, n))
        if outs and isinstance(outs[0], list):    # multi-output model
            return [np.concatenate([o[i] for o in outs], axis=0)
                    for i in range(len(outs[0]))]
        return np.concatenate(outs, axis=0)

    def predict_class(self, data, batch_size: int = 32) -> np.ndarray:
        """1-based class predictions (Torch convention)."""
        return self.predict(data, batch_size).argmax(axis=-1) + 1


LocalPredictor = Predictor  # single-process alias (reference LocalPredictor)
Validator = Evaluator       # reference alias
