"""Trigger — composable stop/fire conditions (``bigdl_tpu/optim/trigger.py``).

Evaluated on the host against the optimizer's state dict each iteration.
``peek`` must be a side-effect-free predictor of the trigger: the
optimizer peeks at a speculative post-step state to decide whether to
fetch the next batch while the step runs.
"""

from __future__ import annotations

from typing import Callable


class Trigger:
    def __init__(self, fn: Callable[[dict], bool],
                 peek_fn: Callable[[dict], bool] = None) -> None:
        self._fn = fn
        self._peek = peek_fn or fn

    def __call__(self, state) -> bool:
        return self._fn(state)

    def peek(self, state) -> bool:
        """Would the trigger fire on this state? (no side effects)"""
        return self._peek(state)

    def and_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) and other(s),
                       lambda s: self.peek(s) and other.peek(s))

    def or_(self, other: "Trigger") -> "Trigger":
        return Trigger(lambda s: self(s) or other(s),
                       lambda s: self.peek(s) or other.peek(s))

    @staticmethod
    def max_epoch(max_e: int) -> "Trigger":
        return Trigger(lambda s: s["epoch"] > max_e)

    @staticmethod
    def max_iteration(max_it: int) -> "Trigger":
        return Trigger(lambda s: s["neval"] > max_it)
