"""Fault injection, virtual clocks and the watchdog config of the serving
plane (``bigdl_tpu/serving/faults.py``).

Recovery leans on the engine's loss-free eviction: per-request RNG lanes
plus prefill replay of ``prompt + emitted``. So the answer to any
suspect step — a raised dispatch, garbage outputs, a watchdog timeout —
is one: discard the step's outputs, evict the implicated rows and let
admission replay them. :class:`FaultInjector` exercises that path
deterministically: every dispatch the engine routes through it draws
one uniform from a private ``np.random.default_rng(seed)``, exactly as
the JAX injector does, so the same seed and the same dispatch order fire
the same faults in both packages. Stalls advance a shared
:class:`VirtualClock` instead of sleeping.

    clk = VirtualClock()
    eng = ServingEngine(
        lm, n_slots=4, device="cpu", clock=clk,
        watchdog=WatchdogConfig(step_timeout_s=5.0, max_retries=3),
        faults=FaultInjector(seed=1, p_fail=0.2, p_stall=0.1,
                             stall_s=30.0, clock=clk))

The JAX injector's ``"transfer"`` site belongs to disaggregated serving
(ROADMAP.md A.2.i) and is not carried.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


class FaultError(RuntimeError):
    """A dispatch failure the engine recovers from: the step's outputs
    are discarded and its rows evicted and replayed."""

    def __init__(self, site: str, kind: str = "fail") -> None:
        super().__init__(f"{kind} at {site!r} dispatch")
        self.site = site
        self.kind = kind


class VirtualClock:
    """A manually advanced clock the engine and the injector can share:
    a "slow step" is ``advance(stall_s)`` between dispatch and readback,
    so deadline and stall tests never sleep."""

    def __init__(self, start: float = 0.0) -> None:
        self.t = float(start)

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"cannot rewind the clock ({seconds})")
        self.t += float(seconds)

    def __call__(self) -> float:
        return self.t


class SteppingClock(VirtualClock):
    """A :class:`VirtualClock` that advances ``tick_s`` on every read:
    virtual time that passes as the engine runs, fixed per code path,
    hence deterministic per trace."""

    def __init__(self, tick_s: float = 0.001, start: float = 0.0) -> None:
        super().__init__(start)
        if tick_s <= 0:
            raise ValueError(f"tick_s must be positive, got {tick_s}")
        self.tick_s = float(tick_s)

    def __call__(self) -> float:
        self.advance(self.tick_s)
        return self.t


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


#: Dispatch sites the engine routes through the injector: "decode" is the
#: pooled decode step, "verify"/"draft" the speculative plane's two
#: dispatches, "prefill" every admission-side prefill (per-request,
#: bucketed, prefix suffix, chunk and draft alike).
SITES = ("decode", "verify", "draft", "prefill")


class FaultInjector:
    """Deterministic per-dispatch fault source.

    ``p_fail``/``p_garbage``/``p_stall`` apply to the step sites
    ("decode", "verify", "draft"):
    raise before dispatching, corrupt the returned outputs (float leaves
    → NaN, int leaves → -1), or advance the shared clock by ``stall_s``
    after the dispatch. ``p_admit_fail`` applies to "prefill". At most one
    fault fires per dispatch; ``max_faults`` caps the total injected.
    ``counts`` tallies injections by kind."""

    def __init__(self, seed: int = 0, p_fail: float = 0.0,
                 p_garbage: float = 0.0, p_stall: float = 0.0,
                 p_admit_fail: float = 0.0, stall_s: float = 10.0,
                 clock: Optional[VirtualClock] = None,
                 max_faults: Optional[int] = None) -> None:
        for name, p in (("p_fail", p_fail), ("p_garbage", p_garbage),
                        ("p_stall", p_stall),
                        ("p_admit_fail", p_admit_fail)):
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must lie in [0, 1], got {p}")
        if p_fail + p_garbage + p_stall > 1.0:
            raise ValueError("p_fail + p_garbage + p_stall must be <= 1")
        if p_stall > 0.0 and clock is None:
            raise ValueError(
                "p_stall needs a shared VirtualClock — stalls are "
                "simulated by advancing it, never by sleeping")
        self.p_fail = float(p_fail)
        self.p_garbage = float(p_garbage)
        self.p_stall = float(p_stall)
        self.p_admit_fail = float(p_admit_fail)
        self.stall_s = float(stall_s)
        self.clock = clock
        self.max_faults = max_faults
        self.counts: Dict[str, int] = {
            "fail": 0, "garbage": 0, "stall": 0, "admit_fail": 0}
        self._rng = np.random.default_rng(int(seed))

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def _armed(self) -> bool:
        return self.max_faults is None or self.total < self.max_faults

    def call(self, site: str, fn, *args):
        """Dispatch ``fn(*args)`` through the fault schedule: one uniform
        draw per call decides the outcome."""
        if site not in SITES:
            raise ValueError(
                f"unknown dispatch site {site!r} (one of {SITES})")
        u = float(self._rng.random())
        if site == "prefill":
            if self._armed() and u < self.p_admit_fail:
                self.counts["admit_fail"] += 1
                raise FaultError(site, "admit_fail")
            return fn(*args)
        if self._armed() and u < self.p_fail:
            self.counts["fail"] += 1
            raise FaultError(site, "fail")
        out = fn(*args)
        if self._armed() and u < self.p_fail + self.p_garbage:
            self.counts["garbage"] += 1
            return _corrupt(out)
        if self._armed() and u < self.p_fail + self.p_garbage + self.p_stall:
            self.counts["stall"] += 1
            self.clock.advance(self.stall_s)
        return out


def _corrupt(out: Tuple):
    """The garbage-output transform: every float tensor of a dispatch's
    output tuple becomes all-NaN and every integer tensor all -1, each a
    new tensor on its own device; dict leaves (the carry) pass through —
    the engine evicts every implicated row, so the carry dies with the
    slots."""

    def bad(x):
        if not isinstance(x, torch.Tensor) or x.dtype == torch.bool:
            return x
        if x.is_floating_point():
            return torch.full_like(x, float("nan"))
        return torch.full_like(x, -1)

    if isinstance(out, tuple):
        return tuple(bad(x) for x in out)
    return bad(out)


def default_clock() -> float:
    """The engine's default time source (the wall clock)."""
    return time.perf_counter()
