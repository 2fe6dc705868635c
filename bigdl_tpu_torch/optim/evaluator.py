"""Evaluator / Predictor — batched inference on one device
(``bigdl_tpu/optim/evaluator.py:26-50``, ``:92-178``).

Each batch goes to the model's device, runs through
:func:`bigdl_tpu_torch.optim.train_step.make_eval_step` on the module's
own parameters and buffers in eval mode, and is scored by the
ValidationMethods (``Evaluator.test``) or brought back to the host
(``Predictor``). Every record counts: a dataset keeps its trailing
partial batch. The sharded evaluator (``make_sharded_eval_step``,
``pad_shard_call``) comes with the data-parallel slice.
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


class Evaluator:
    """Batched evaluation of a model against ValidationMethods (reference
    ``Evaluator(model).test(dataset, methods, batchSize)``)."""

    def __init__(self, model) -> None:
        self.model = model
        self._step = make_eval_step(model)

    def _forward(self, inp):
        m = self.model
        return self._step(dict(m.named_parameters()), dict(m.named_buffers()),
                          to_device(inp, m._facade_device()))

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

    def __init__(self, model) -> None:
        self._ev = Evaluator(model)
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
