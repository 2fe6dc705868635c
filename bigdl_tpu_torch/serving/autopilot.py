"""The control discipline of the SLO autopilot
(``bigdl_tpu/serving/autopilot.py:77-152``): :class:`Controller`, the
dead-band / sustain / cooldown hysteresis over one scalar signal that the
pool autoscaler (``health.OccupancyAutoscaler``) subclasses, so every
control loop shares one flap-freedom argument. Host arithmetic only, no
device traffic.

The autopilot proper — ``Autopilot``, ``ActuatorBus``,
``AutopilotConfig``, deadline victims, the draft cap and the
least-laxity key — is ROADMAP.md A.2.i's second half.
"""

from __future__ import annotations

from typing import Optional


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
