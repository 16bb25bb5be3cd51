"""Engine health state machine: HEALTHY → DEGRADED → DRAINING (a copy
of ``paddle_tpu/resilience/health.py`` without its telemetry hooks).

Driven by a single pressure signal in [0, 1] (for the serving engine:
live page-pool occupancy).  Transitions carry hysteresis so the state
cannot flap across a threshold every step:

- HEALTHY  → DEGRADED  at pressure >= ``degraded_at``
- DEGRADED → DRAINING  at pressure >= ``drain_at``
- DEGRADED → HEALTHY   at pressure <= ``recover_at`` (< degraded_at)
- DRAINING → DEGRADED  at pressure <= ``degraded_at``

Semantics the serving engine attaches:

- HEALTHY: admit everything the page budget allows.
- DEGRADED: keep admitting (the scheduler's page gate already slows
  intake) but the state is exported.
- DRAINING: REJECT new admissions (explicit backpressure) and let
  running requests finish.
"""
from __future__ import annotations

import enum
import threading

__all__ = ["HealthState", "HealthMonitor"]


class HealthState(enum.IntEnum):
    HEALTHY = 0
    DEGRADED = 1
    DRAINING = 2


class HealthMonitor:
    """Hysteretic three-state monitor over a [0, 1] pressure signal."""

    def __init__(self, degraded_at=0.85, drain_at=0.97, recover_at=0.70):
        if not 0.0 <= recover_at < degraded_at < drain_at <= 1.0:
            raise ValueError(
                "need 0 <= recover_at < degraded_at < drain_at <= 1, "
                f"got {recover_at}/{degraded_at}/{drain_at}")
        self.degraded_at = float(degraded_at)
        self.drain_at = float(drain_at)
        self.recover_at = float(recover_at)
        self._lock = threading.Lock()
        self._state = HealthState.HEALTHY
        self.transitions = []          # [(from, to, pressure)]
        self.last_pressure = 0.0

    @property
    def state(self):
        return self._state

    @property
    def admitting(self):
        """DRAINING is the only state that refuses admissions."""
        return self._state != HealthState.DRAINING

    def update(self, pressure):
        """Feed the current pressure; returns the (possibly new) state."""
        pressure = float(pressure)
        with self._lock:
            old = self._state
            new = self._next_state(old, pressure)
            self.last_pressure = pressure
            if new is not old:
                self._state = new
                self.transitions.append((old, new, pressure))
        return new

    def _next_state(self, state, p):
        if state == HealthState.HEALTHY:
            if p >= self.drain_at:
                return HealthState.DRAINING
            if p >= self.degraded_at:
                return HealthState.DEGRADED
            return state
        if state == HealthState.DEGRADED:
            if p >= self.drain_at:
                return HealthState.DRAINING
            if p <= self.recover_at:
                return HealthState.HEALTHY
            return state
        # DRAINING recovers stepwise: pool pressure must fall below the
        # degraded threshold first; full recovery goes through DEGRADED
        if p <= self.degraded_at:
            return HealthState.DEGRADED
        return state
