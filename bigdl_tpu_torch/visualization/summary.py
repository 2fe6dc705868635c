"""TrainSummary / ValidationSummary (``bigdl_tpu/visualization/summary.py``).

``Optimizer.set_train_summary`` / ``set_val_summary`` hook these into the
training loop: a TrainSummary records ``Loss``, ``Throughput`` and
``LearningRate`` every iteration and the ``Parameters/...`` histograms
when its ``"Parameters"`` trigger fires; a ValidationSummary records each
validation method's score. The files live in ``log_dir/app_name/train``
and ``log_dir/app_name/validation``; ``read_scalar(tag)`` reads a tag's
history back (the reference's ``readScalar``).
"""

from __future__ import annotations

import os
from typing import List, Tuple

from bigdl_tpu_torch.visualization.tensorboard import FileWriter, read_scalars


class Summary:
    def __init__(self, log_dir: str, app_name: str, tag: str) -> None:
        self.log_dir = os.path.join(log_dir, app_name, tag)
        self.writer = FileWriter(self.log_dir)
        self._triggers = {}

    def add_scalar(self, tag: str, value: float, step: int) -> "Summary":
        self.writer.add_scalar(tag, float(value), int(step))
        return self

    def add_histogram(self, tag: str, values, step: int) -> "Summary":
        """``values``: a tensor on any device or a host array."""
        self.writer.add_histogram(tag, values, int(step))
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float]]:
        """(step, value) history of one tag across this summary's files."""
        out = []
        for name in sorted(os.listdir(self.log_dir)):
            for t, v, step in read_scalars(os.path.join(self.log_dir, name)):
                if t == tag:
                    out.append((step, v))
        return out

    def close(self) -> None:
        self.writer.close()


class TrainSummary(Summary):
    def __init__(self, log_dir: str, app_name: str) -> None:
        super().__init__(log_dir, app_name, "train")

    def set_summary_trigger(self, name: str, trigger) -> "TrainSummary":
        """A recording trigger per tag (the reference throttles the
        costly ``"Parameters"`` histograms, e.g.
        ``Trigger.several_iteration(20)``)."""
        self._triggers[name] = trigger
        return self

    def should_record(self, name: str, state) -> bool:
        trig = self._triggers.get(name)
        return trig is not None and trig(state)


class ValidationSummary(Summary):
    def __init__(self, log_dir: str, app_name: str) -> None:
        super().__init__(log_dir, app_name, "validation")
