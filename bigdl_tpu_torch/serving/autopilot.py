"""The SLO autopilot: the closed control loop over the serving engine
(``bigdl_tpu/serving/autopilot.py``).

The engine's sensors (goodput, decode-gap p99, accept rate, queue depth:
``metrics.py``) and actuators (loss-free preemption, ``Degrade``,
``chunk_budget``, the speculative draft count, the pool autoscaler) run
on static knobs until an :class:`Autopilot` closes the loop. It is host
bookkeeping only, with no torch import, sampled once per engine step on
the ENGINE clock, so a ``SteppingClock`` drives the whole loop
deterministically. Three pieces:

* :class:`Controller` — the dead-band / sustain / cooldown hysteresis over
  one scalar signal that every loop shares (the pool autoscaler,
  ``health.OccupancyAutoscaler``, subclasses it), so a signal riding a
  waterline cannot flap an actuator;
* :class:`ActuatorBus` — the one declared write surface for engine knobs:
  every mutation the autopilot makes goes through a method named in
  :data:`ACTUATION_SITES` and lands in ``log`` as ``(sample_no,
  actuator, value)`` and on the metrics plane (``serving/actuations``).
  An actuation changes host data the next step reads, never a step's
  inputs' layout;
* :class:`Autopilot` — the per-step ``sample()`` over WINDOWED metrics
  (``ServingMetrics.window``) driving the controllers, plus deadline-aware
  preemption: with a measured per-token service time, a short-deadline
  feasible waiter that would miss while a long-slack row holds its slot
  evicts that row (preemption is loss-free, so this reorders latency,
  never tokens). ``attach`` folds the same estimate into the scheduler's
  priority key as a least-laxity term (``Scheduler.service_estimate``).

Wiring: ``ServingEngine(..., autopilot=Autopilot())`` attaches the bus and
samples the loop at the end of every ``step()``;
``DisaggregatedEngine(..., autopilot=...)`` attaches it to the prefill
engine and registers the pool autoscaler on the bus as ``"pool_scale"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: The closed actuation vocabulary: the only units that mutate engine or
#: scheduler knobs (``chunk_budget``, degrade fields, the draft cap) or
#: drive the pool lifecycle outside ``__init__``. A new actuator is added
#: here first.
ACTUATION_SITES = frozenset({
    "autopilot.ActuatorBus.set_chunk_budget",   # chunked pump budget
    "autopilot.ActuatorBus.set_draft_cap",      # speculative k ceiling
    "autopilot.ActuatorBus.degrade_waiting",    # per-class Degrade apply
    "autopilot.ActuatorBus.restore_waiting",    # per-class Degrade revert
    "engine.ServingEngine._apply_degrade",      # the one degrade writer
    "engine.ServingEngine._restore_degrade",    # the one degrade restorer
    "disagg.DisaggregatedEngine._autoscale",    # pool scale execution
    "disagg.DisaggregatedEngine._failover_pool",  # standby activation
})


class Controller:
    """Dead-band / sustain / cooldown hysteresis over ONE scalar signal.

    The discipline of :class:`~bigdl_tpu_torch.serving.health.
    OccupancyAutoscaler`, shared by every control loop: a
    sample at or past ``high_water`` extends the high run, at or below
    ``low_water`` the low run, anywhere in the dead band between
    resets BOTH (hysteresis demands consecutive evidence). An action
    fires only after ``sustain`` consecutive same-side samples AND
    ``cooldown`` samples since the last action — born ready, so the
    first action needs no cooldown to expire. Pure host arithmetic:
    deterministic given the signal series, which is what lets tests
    assert flap-freedom instead of eyeballing it.

    ``observe`` returns ``"up"`` (signal high), ``"down"`` (signal
    low), or None; what "up" MEANS (shrink a budget, add a pool) is
    the caller's mapping — the controller only owns the debounce.
    """

    def __init__(self, high_water: float, low_water: float,
                 sustain: int = 3, cooldown: int = 8) -> None:
        if not low_water < high_water:
            raise ValueError(
                f"need low_water < high_water, got "
                f"{low_water}/{high_water}")
        if sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {sustain}")
        if cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {cooldown}")
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.sustain = int(sustain)
        self.cooldown = int(cooldown)
        self._hi_run = 0
        self._lo_run = 0
        # born ready: the first action needs no cooldown to expire
        self._since_action = self.cooldown

    def observe(self, signal: float, can_up: bool = True,
                can_down: bool = True,
                hold_down: bool = False) -> Optional[str]:
        """One control sample. ``can_up``/``can_down`` gate on what
        the actuator can actually do (a budget already at its bound, no
        standby pool); ``hold_down`` vetoes the LOW side only (the
        autoscaler's backlogged-lull case: a low signal with queued
        work means admission is catching up, not that capacity is
        idle)."""
        if signal >= self.high_water:
            self._hi_run += 1
            self._lo_run = 0
        elif signal <= self.low_water and not hold_down:
            self._lo_run += 1
            self._hi_run = 0
        else:
            # the dead band (or a vetoed lull): both runs restart —
            # hysteresis demands CONSECUTIVE evidence
            self._hi_run = 0
            self._lo_run = 0
        self._since_action += 1
        if self._since_action <= self.cooldown:
            return None
        if self._hi_run >= self.sustain and can_up:
            self._act()
            return "up"
        if self._lo_run >= self.sustain and can_down:
            self._act()
            return "down"
        return None

    def _act(self) -> None:
        self._hi_run = 0
        self._lo_run = 0
        self._since_action = 0


@dataclass(frozen=True)
class AutopilotConfig:
    """Setpoints of the closed loop: each controller's waterlines and the
    shared debounce.

    Chunk budget: signal = windowed decode-gap p99 over ``gap_target_s``
    (above ``gap_high`` sustained → halve the pump's budget toward
    ``chunk_min``; below ``gap_low`` with prompts queued → double it
    toward ``chunk_max``). Degrade: signal = live queue depth (past
    ``queue_high`` → apply each WAITING row's submitted ``Degrade`` for
    classes at or below ``degrade_below_priority``; at or below
    ``queue_low`` → restore the originals of rows still waiting). Draft
    cap (speculative engines): signal = windowed accept rate (below
    ``accept_low`` → cut the cap one toward 0; above ``accept_high`` →
    raise it one toward ``k``). Deadline preemption: ``preempt_margin_s``
    pads the would-miss test."""

    gap_target_s: float = 0.05
    gap_high: float = 2.0
    gap_low: float = 0.5
    chunk_min: int = 8
    chunk_max: int = 256
    queue_high: float = 6.0
    queue_low: float = 1.0
    degrade_below_priority: int = 0
    accept_high: float = 0.7
    accept_low: float = 0.3
    sustain: int = 3
    cooldown: int = 8
    window: int = 64
    preempt: bool = True
    preempt_margin_s: float = 0.0

    def __post_init__(self):
        if self.gap_target_s <= 0:
            raise ValueError(
                f"gap_target_s must be positive, got {self.gap_target_s}")
        for lo, hi, what in ((self.gap_low, self.gap_high, "gap"),
                             (self.queue_low, self.queue_high, "queue"),
                             (self.accept_low, self.accept_high,
                              "accept")):
            if not lo < hi:
                raise ValueError(
                    f"need {what}_low < {what}_high, got {lo}/{hi}")
        if not 1 <= self.chunk_min <= self.chunk_max:
            raise ValueError(
                f"need 1 <= chunk_min <= chunk_max, got "
                f"{self.chunk_min}/{self.chunk_max}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {self.sustain}")
        if self.cooldown < 0:
            raise ValueError(
                f"cooldown must be >= 0, got {self.cooldown}")
        if self.preempt_margin_s < 0:
            raise ValueError(
                f"preempt_margin_s must be >= 0, got "
                f"{self.preempt_margin_s}")


class ActuatorBus:
    """The declared write surface for engine knobs (module docstring).
    Each actuation is appended to ``log`` as ``(sample_no, actuator,
    value)`` and counted by ``metrics.on_actuation``."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.log: List[Tuple[int, str, object]] = []
        self._sample_no = 0

    def _record(self, actuator: str, value) -> None:
        self.log.append((self._sample_no, actuator, value))
        self.engine.metrics.on_actuation(actuator)

    def set_chunk_budget(self, n: int) -> bool:
        """Set the chunked pump's per-step prompt-token budget (read at
        every ``pump()``, so it takes effect next step). False on an
        engine without chunked admission or when already there."""
        adm = self.engine.admitter
        if adm is None or not hasattr(adm, "chunk_budget"):
            return False
        n = max(1, int(n))
        if adm.chunk_budget == n:
            return False
        adm.chunk_budget = n
        self._record("chunk_budget", n)
        return True

    def set_draft_cap(self, n: Optional[int]) -> bool:
        """Set the engine-wide ceiling on speculative drafts per row
        (None = the configured k); per-row ``draft_tokens`` hints apply
        below it. The next super-step's draft budgets read it."""
        n = None if n is None else max(0, int(n))
        if self.engine.draft_cap == n:
            return False
        self.engine.draft_cap = n
        self._record("draft_cap", n)
        return True

    def degrade_waiting(self, below_priority: int = 0) -> int:
        """Apply each WAITING request's submitted ``Degrade`` for priority
        classes AT OR BELOW ``below_priority``; the originals are kept on
        the request for :meth:`restore_waiting`. Returns the count."""
        eng = self.engine
        n = 0
        for req in eng.scheduler.iter_waiting():
            if req.priority <= below_priority and eng._apply_degrade(req):
                n += 1
        if n:
            self._record("degrade", n)
        return n

    def restore_waiting(self, below_priority: Optional[int] = None) -> int:
        """Give each degraded row that still WAITS (of classes at or below
        ``below_priority``, or all) its original ``max_new_tokens`` and
        ``draft_tokens`` back; seated rows keep their caps. Returns the
        count."""
        eng = self.engine
        n = 0
        for req in eng.scheduler.iter_waiting():
            if below_priority is not None and req.priority > below_priority:
                continue
            if eng._restore_degrade(req):
                n += 1
        if n:
            self._record("restore", n)
        return n

    def note_pool_scale(self, direction: str) -> None:
        """Log a pool scale decision that ``DisaggregatedEngine.
        _autoscale`` executed, so pool and knob actuations share one
        log."""
        self._record("pool_scale", direction)


class Autopilot:
    """The per-step control loop (module docstring). One instance per
    engine: ``ServingEngine(..., autopilot=Autopilot())``."""

    def __init__(self, config: Optional[AutopilotConfig] = None) -> None:
        self.config = cfg = config if config is not None \
            else AutopilotConfig()
        self.bus: Optional[ActuatorBus] = None
        self._chunk = Controller(cfg.gap_high, cfg.gap_low,
                                 cfg.sustain, cfg.cooldown)
        self._load = Controller(cfg.queue_high, cfg.queue_low,
                                cfg.sustain, cfg.cooldown)
        # accept rate: HIGH raises the cap, LOW cuts it
        self._draft = Controller(cfg.accept_high, cfg.accept_low,
                                 cfg.sustain, cfg.cooldown)
        #: name -> Controller, external ones (the plane's "pool_scale")
        #: included
        self.controllers: Dict[str, Controller] = {
            "chunk_budget": self._chunk, "degrade": self._load,
            "draft_cap": self._draft}
        self._n_samples = 0

    def attach(self, engine) -> "Autopilot":
        """Bind the bus to ``engine`` and fold its measured service-time
        estimate into its scheduler's priority key (least laxity)."""
        if self.bus is not None and self.bus.engine is not engine:
            raise ValueError(
                "this Autopilot is already attached to another engine "
                "— one instance per engine (the bus binds to it)")
        self.bus = ActuatorBus(engine)
        engine.scheduler.service_estimate = \
            engine.metrics.service_time_estimate
        return self

    def register_controller(self, name: str,
                            controller: Controller) -> None:
        """Adopt an externally built controller (the plane's pool
        scaler) into :attr:`controllers`."""
        self.controllers[name] = controller

    def sample(self, engine) -> None:
        """ONE control sample, called by the engine at the end of every
        ``step()``, idle steps included (pressure relief happens in lulls,
        which is why the degrade loop reads the LIVE queue depth)."""
        cfg = self.config
        bus = self.bus
        if bus is None or bus.engine is not engine:
            raise ValueError("autopilot not attached to this engine "
                             "(pass autopilot= at engine construction)")
        bus._sample_no = self._n_samples
        m = engine.metrics

        # chunk budget <- windowed decode-gap p99 against the target
        adm = engine.admitter
        if adm is not None and hasattr(adm, "chunk_budget"):
            gap = m.window("decode_gap_s", cfg.window)
            if gap is not None:
                d = self._chunk.observe(
                    gap["p99"] / cfg.gap_target_s,
                    can_up=adm.chunk_budget > cfg.chunk_min,
                    can_down=(adm.chunk_budget < cfg.chunk_max
                              and engine.scheduler.queue_depth > 0))
                if d == "up":
                    bus.set_chunk_budget(
                        max(cfg.chunk_min, adm.chunk_budget // 2))
                elif d == "down":
                    bus.set_chunk_budget(
                        min(cfg.chunk_max, adm.chunk_budget * 2))

        # per-class Degrade <- live queue depth
        d = self._load.observe(float(engine.scheduler.queue_depth))
        if d == "up":
            bus.degrade_waiting(cfg.degrade_below_priority)
        elif d == "down":
            bus.restore_waiting()

        # draft cap <- windowed accept rate (speculative engines)
        spec = getattr(engine, "_spec", None)
        if spec is not None:
            drafted = m.window("draft_tokens", cfg.window)
            accepted = m.window("accepted_tokens", cfg.window)
            if drafted is not None and drafted["mean"] > 0:
                rate = (accepted["mean"] / drafted["mean"]
                        if accepted is not None else 0.0)
                cap = engine.draft_cap
                cur = spec.k if cap is None else cap
                d = self._draft.observe(rate, can_up=cur < spec.k,
                                        can_down=cur > 0)
                if d == "up":
                    bus.set_draft_cap(None if cur + 1 >= spec.k
                                      else cur + 1)
                elif d == "down":
                    bus.set_draft_cap(cur - 1)

        self._n_samples += 1

    def deadline_victims(self, engine, now: float) -> List:
        """RUNNING rows to evict so short-deadline feasible waiters seat in
        time; the engine's ``_admit`` consults it after the static
        priority loop.

        A waiter triggers only when it has a deadline, is FEASIBLE if
        seated now (``now + est * remaining <= deadline``), no free slot
        will seat it, and waiting for one victim's completion would make
        it miss (padded by ``preempt_margin_s``). The victim is the
        running row with the most deadline slack (no deadline = infinite),
        never of a higher priority class, and only when its slack after
        the detour still exceeds the waiter's; ties break by arrival."""
        cfg = self.config
        if not cfg.preempt:
            return []
        est = engine.metrics.service_time_estimate()
        if est is None or est <= 0:
            return []
        sched = engine.scheduler
        running = list(sched.running.values())
        if not running:
            return []

        def rem(req) -> int:
            return max(1, req.max_new_tokens - len(req.output))

        free = engine.pool.free_slots
        victims: List = []
        taken = set()
        for w in sched.peek_waiting(len(running) + free):
            dl = w.deadline_time
            if dl is None:
                continue
            slack_w = dl - now - est * rem(w)
            if slack_w < 0:
                continue                    # infeasible even seated now
            if free > 0:
                free -= 1                   # this admission seats it
                continue
            # the shortest-remaining running row bounds the natural wait
            left = [rem(r) for r in running if id(r) not in taken]
            if not left:
                break                       # every row already traded
            if slack_w - est * min(left) >= cfg.preempt_margin_s:
                continue                    # it can afford to wait
            best, best_slack = None, None
            for r in running:
                if id(r) in taken or r.priority > w.priority:
                    continue
                rdl = r.deadline_time
                slack_r = float("inf") if rdl is None \
                    else rdl - now - est * rem(r)
                # sound: after waiting behind the waiter, the victim keeps
                # more slack than the waiter has now
                if slack_r - est * rem(w) <= slack_w:
                    continue
                if best is None or slack_r > best_slack or \
                        (slack_r == best_slack and r.seq < best.seq):
                    best, best_slack = r, slack_r
            if best is None:
                break                       # no sound trade for anyone
            taken.add(id(best))
            victims.append(best)
        return victims
