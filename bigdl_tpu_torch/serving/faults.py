"""Step-health pieces of the serving plane (``bigdl_tpu/serving/faults.py``).

The port carries what the engine's step-health check uses: the
:class:`FaultError` a failed dispatch raises, the :class:`WatchdogConfig`
that bounds step time and per-request retries, and the default clock.
The deterministic fault injector and the virtual clocks come with the
resilience slice (ROADMAP queue A, slice 7 step 3).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


class FaultError(RuntimeError):
    """A dispatch failure the engine recovers from: the step's outputs
    are discarded and its rows evicted and replayed."""

    def __init__(self, site: str, kind: str = "fail") -> None:
        super().__init__(f"{kind} at {site!r} dispatch")
        self.site = site
        self.kind = kind


@dataclass(frozen=True)
class WatchdogConfig:
    """``step_timeout_s``: a decode dispatch whose elapsed time on the
    engine clock exceeds this is treated as failed (armed only after the
    first healthy step; None = no timeout). ``max_retries``: a request
    evicted by recovery more than this many times finishes with
    ``finish_reason='error'`` (None = retry forever)."""

    step_timeout_s: Optional[float] = None
    max_retries: Optional[int] = 3

    def __post_init__(self):
        if self.step_timeout_s is not None and self.step_timeout_s <= 0:
            raise ValueError(
                f"step_timeout_s must be positive, got {self.step_timeout_s}")
        if self.max_retries is not None and self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")


def default_clock() -> float:
    """The engine's default time source (the wall clock)."""
    return time.perf_counter()
