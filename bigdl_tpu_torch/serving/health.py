"""Pool-level health, transfer retry and occupancy autoscaling for the
disaggregated serving plane (``bigdl_tpu/serving/health.py``;
``disagg.py`` uses them).

* :class:`PoolHealth` — each decode pool's liveness: a heartbeat stamped
  after every completed worker step on the ENGINE's clock (a
  :class:`~bigdl_tpu_torch.serving.faults.VirtualClock` runs the state
  machine in tests without a sleep) and the run of consecutive transfer
  failures to the pool. Missed beats or failures move a pool HEALTHY →
  SUSPECT → DEAD (:class:`HealthConfig` holds the thresholds); SUSPECT
  pools get no new handoffs, a DEAD pool is failed over
  (``DisaggregatedEngine._failover_pool``).
* :class:`TransferRetryConfig` — a failed handoff backs off
  exponentially per request (``delay(n)``, on the engine clock), and a
  send slower than ``send_timeout_s`` counts as failed-unconfirmed: the
  request resends and the receiver deduplicates by request id. Retries
  stay bounded by the watchdog's ``max_retries``.
* :class:`OccupancyAutoscaler` — activates standby pools under sustained
  occupancy and drains cold ones, with hysteresis (a dead band, a
  sustain run and a cooldown in steps) so it never flaps.

Host bookkeeping over floats and ints only: no device traffic, so pool
decisions keep working while devices fail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from bigdl_tpu_torch.serving.autopilot import Controller

#: The closed pool-health vocabulary (the FINISH_REASONS pattern):
#: HEALTHY pools receive new handoffs, SUSPECT pools keep their rows
#: but stop receiving new work, DEAD pools are failed over and never
#: touched again (their device state is untrusted by definition).
HEALTHY, SUSPECT, DEAD = "healthy", "suspect", "dead"

#: Pool lifecycle states the front end tracks per decode pool. ACTIVE
#: pools are routed to and stepped; STANDBY pools are built (weights
#: resident, step programs shared through the process-wide caches — so
#: activation is compile-free) but idle; DEAD pools were failed over.
#: ``drain_pool`` moves active → standby; the autoscaler moves both
#: directions.
POOL_ACTIVE, POOL_STANDBY, POOL_DEAD = "active", "standby", "dead"


@dataclass(frozen=True)
class HealthConfig:
    """Thresholds for :class:`PoolHealth`.

    ``suspect_after_s``/``dead_after_s`` — seconds of heartbeat SILENCE
    (on the engine clock) before a pool is classified SUSPECT / DEAD. A
    worker beats once per completed super-step, so silence means the
    pool is not making progress — hung, crashed, or partitioned.
    ``suspect_after_failures``/``dead_after_failures`` — CONSECUTIVE
    transfer-send failures to the pool before the same verdicts (a
    delivered send resets the run): the fabric-side death signal, which
    sees a pool the heartbeat path cannot even reach."""

    suspect_after_s: float = 3.0
    dead_after_s: float = 10.0
    suspect_after_failures: int = 2
    dead_after_failures: int = 5

    def __post_init__(self):
        if not 0 < self.suspect_after_s <= self.dead_after_s:
            raise ValueError(
                f"need 0 < suspect_after_s <= dead_after_s, got "
                f"{self.suspect_after_s}/{self.dead_after_s}")
        if not 0 < self.suspect_after_failures \
                <= self.dead_after_failures:
            raise ValueError(
                f"need 0 < suspect_after_failures <= "
                f"dead_after_failures, got "
                f"{self.suspect_after_failures}/"
                f"{self.dead_after_failures}")


class PoolHealth:
    """One pool's liveness record: last heartbeat + the consecutive
    transfer-failure run, classified against a :class:`HealthConfig`
    on demand. ``force_dead()`` is the operator/router short-circuit
    for a death known out-of-band (connection refused, process exit) —
    classification never resurrects a forced-dead pool."""

    def __init__(self, clock, config: Optional[HealthConfig] = None) -> None:
        self._clock = clock
        self.config = config if config is not None else HealthConfig()
        self._last_beat = float(clock())
        self._failures = 0
        self._forced_dead = False

    def beat(self) -> None:
        """Stamp a liveness beat (one per completed worker super-step)."""
        self._last_beat = float(self._clock())

    def on_transfer_failure(self) -> None:
        self._failures += 1

    def on_transfer_ok(self) -> None:
        self._failures = 0

    def force_dead(self) -> None:
        self._forced_dead = True

    def reset(self) -> None:
        """Fresh bill of health (pool activation from standby): the
        beat clock restarts NOW so a pool idle on the bench since
        construction is not born dead. Forced death is permanent."""
        if self._forced_dead:
            raise ValueError("a forced-dead pool cannot be reset")
        self._last_beat = float(self._clock())
        self._failures = 0

    @property
    def silent_s(self) -> float:
        """Seconds since the last beat, on the shared clock."""
        return float(self._clock()) - self._last_beat

    def state(self) -> str:
        """Classify: DEAD / SUSPECT / HEALTHY (module docstring)."""
        cfg = self.config
        if self._forced_dead or self.silent_s > cfg.dead_after_s \
                or self._failures >= cfg.dead_after_failures:
            return DEAD
        if self.silent_s > cfg.suspect_after_s \
                or self._failures >= cfg.suspect_after_failures:
            return SUSPECT
        return HEALTHY


@dataclass(frozen=True)
class TransferRetryConfig:
    """Send-side hardening knobs for the handoff path.

    ``send_timeout_s`` — a send whose elapsed time (engine clock)
    exceeds this is treated as FAILED even if it eventually returned:
    delivery is unconfirmed (the abandoned-hang shape), so the request
    requeues for resend and the RECEIVER deduplicates by request id
    (``DecodeWorker.ingest``) in case the slow send did land. None =
    no timeout verdict. ``backoff_base_s``/``backoff_cap_s`` — the
    per-request exponential backoff between retries: attempt ``n``
    waits ``min(cap, base * 2**(n-1))`` before the row re-enters the
    queue, so a down fabric is probed at a decaying rate instead of
    hammered every pump."""

    send_timeout_s: Optional[float] = None
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 2.0

    def __post_init__(self):
        if self.send_timeout_s is not None and self.send_timeout_s <= 0:
            raise ValueError(
                f"send_timeout_s must be positive or None, got "
                f"{self.send_timeout_s}")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff times must be >= 0")

    def delay(self, n_retries: int) -> float:
        """Backoff before retry ``n_retries`` (1-based)."""
        if n_retries <= 0:
            return 0.0
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2.0 ** (n_retries - 1)))


@dataclass(frozen=True)
class AutoscalerConfig:
    """Hysteresis knobs for :class:`OccupancyAutoscaler`.

    ``high_water``/``low_water`` — mean ACTIVE-decode-pool occupancy
    thresholds; the gap between them is the dead band (a signal inside
    it never triggers anything). ``sustain`` — consecutive samples the
    signal must sit past a threshold before the action fires (one
    sample per front-end step). ``cooldown`` — front-end steps after
    ANY action during which no further action may fire (counted in
    steps, not seconds, so a VirtualClock test is deterministic).
    ``min_pools`` — the floor scale-down never goes below."""

    high_water: float = 0.85
    low_water: float = 0.30
    sustain: int = 3
    cooldown: int = 8
    min_pools: int = 1

    def __post_init__(self):
        if not 0.0 <= self.low_water < self.high_water <= 1.0:
            raise ValueError(
                f"need 0 <= low_water < high_water <= 1, got "
                f"{self.low_water}/{self.high_water}")
        if self.sustain < 1:
            raise ValueError(f"sustain must be >= 1, got {self.sustain}")
        if self.cooldown < 0:
            raise ValueError(
                f"cooldown must be >= 0, got {self.cooldown}")
        if self.min_pools < 1:
            raise ValueError(
                f"min_pools must be >= 1, got {self.min_pools}")


class OccupancyAutoscaler(Controller):
    """The pool-count control loop (module docstring): one
    :meth:`observe` per front-end step returns ``"up"``, ``"down"``,
    or None; the engine executes (activate a standby pool / drain the
    least-loaded active pool). Pure host arithmetic — deterministic
    given the occupancy series, which is what lets the bench assert
    flap-freedom instead of eyeballing it.

    It is the :class:`~bigdl_tpu_torch.serving.autopilot.Controller`
    base plus the occupancy sample's shape: ``backlog`` vetoes the low
    side (a backlogged lull means admission is catching up, not that
    capacity is idle)."""

    def __init__(self, config: Optional[AutoscalerConfig] = None) -> None:
        self.config = config if config is not None else AutoscalerConfig()
        super().__init__(self.config.high_water, self.config.low_water,
                         sustain=self.config.sustain,
                         cooldown=self.config.cooldown)

    def observe(self, occupancy: float, backlog: int,
                can_up: bool, can_down: bool) -> Optional[str]:
        """One control sample: ``occupancy`` is the mean over ACTIVE
        decode pools, ``backlog`` the prefill pool's waiting depth
        (scale-down is refused while work is queued).
        ``can_up``/``can_down`` gate on what the engine can actually
        do (a standby pool exists / more than ``min_pools`` active)."""
        return Controller.observe(self, occupancy, can_up=can_up,
                                  can_down=can_down,
                                  hold_down=backlog > 0)
