"""Trigger — composable stop/fire conditions (``bigdl_tpu/optim/trigger.py``):
``max_epoch``, ``max_iteration``, ``every_epoch``, ``several_iteration``,
``min_loss``, ``max_score``, ``and_``/``or_``.

Evaluated on the host against the optimizer's state dict each iteration.
``peek`` must be a side-effect-free predictor of the trigger: the
optimizer peeks at a speculative post-step state to decide whether to
fetch the next batch while the step runs, so ``every_epoch``'s one-shot
latch moves only when the trigger itself is called.
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

    @staticmethod
    def every_epoch() -> "Trigger":
        """Fires once at the end of each epoch."""
        holder = {"last": None}

        def would_fire(s):
            return (s["epoch"] != holder["last"]
                    and s.get("epoch_finished", False))

        def fn(s):
            if would_fire(s):
                holder["last"] = s["epoch"]
                return True
            return False

        return Trigger(fn, would_fire)

    @staticmethod
    def several_iteration(interval: int) -> "Trigger":
        return Trigger(
            lambda s: (s["neval"] - 1) % interval == 0 and s["neval"] > 1)

    @staticmethod
    def min_loss(min_l: float) -> "Trigger":
        return Trigger(
            lambda s: s.get("loss") is not None and s["loss"] < min_l)

    @staticmethod
    def max_score(max_s: float) -> "Trigger":
        return Trigger(
            lambda s: s.get("score") is not None and s["score"] > max_s)


# module-level factory aliases, the reference's ``Trigger.xxx`` style
max_epoch = Trigger.max_epoch
max_iteration = Trigger.max_iteration
every_epoch = Trigger.every_epoch
several_iteration = Trigger.several_iteration
min_loss = Trigger.min_loss
max_score = Trigger.max_score
