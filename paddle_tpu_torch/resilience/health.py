"""Engine health state machine: HEALTHY → DEGRADED → DRAINING
(counterpart of ``paddle_tpu/resilience/health.py``).

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
  intake) but the state is exported — a router in front of replicas
  uses it to shift load.
- DRAINING: REJECT new admissions (explicit backpressure) and let
  running requests finish.

Every transition is recorded as a ``resilience.health`` span plus the
``serving_health_state`` gauge (0/1/2), so dashboards and the chaos
suite read the same signal.
"""
from __future__ import annotations

import enum
import threading
from collections import deque

from paddle_tpu_torch import observability as obs

__all__ = ["HealthState", "HealthMonitor"]


class HealthState(enum.IntEnum):
    HEALTHY = 0
    DEGRADED = 1
    DRAINING = 2


class HealthMonitor:
    """Hysteretic three-state monitor over a [0, 1] pressure signal."""

    def __init__(self, degraded_at=0.85, drain_at=0.97, recover_at=0.70,
                 on_transition=None, gauge=None):
        if not 0.0 <= recover_at < degraded_at < drain_at <= 1.0:
            raise ValueError(
                "need 0 <= recover_at < degraded_at < drain_at <= 1, "
                f"got {recover_at}/{degraded_at}/{drain_at}")
        self.degraded_at = float(degraded_at)
        self.drain_at = float(drain_at)
        self.recover_at = float(recover_at)
        self.on_transition = on_transition
        self._gauge = gauge            # observability Gauge or None
        self._lock = threading.Lock()
        self._state = HealthState.HEALTHY
        self.transitions = []          # [(from, to, pressure)]
        self.last_pressure = 0.0
        self._pending = deque()        # transitions awaiting emission
        self._emitting = False         # one drainer at a time
        if self._gauge is not None:
            self._gauge.set(int(self._state))

    @property
    def state(self):
        return self._state

    @property
    def admitting(self):
        """DRAINING is the only state that refuses admissions."""
        return self._state != HealthState.DRAINING

    def update(self, pressure):
        """Feed the current pressure; returns the (possibly new) state.

        The transition decision and the `transitions` append happen
        under the lock; gauge/span recording and the `on_transition`
        callback run only AFTER it is released.  The callback is
        arbitrary user code: under the non-reentrant lock, a callback
        that feeds pressure back through ``update()`` (a drain hook
        reacting to DRAINING) deadlocks the monitor, and a slow one
        convoys every other updater.  Emission goes through a FIFO
        queue drained by one thread at a time, so gauge values and
        callback invocations arrive in TRANSITION order even when two
        updates race — the gauge can never be left stale showing a
        state older than the monitor's."""
        pressure = float(pressure)
        with self._lock:
            old = self._state
            new = self._next_state(old, pressure)
            self.last_pressure = pressure
            if new is not old:
                self._state = new
                self.transitions.append((old, new, pressure))
                self._pending.append((old, new, pressure))
        if new is not old:
            self._drain_events()
        return new

    def _drain_events(self):
        """Emit queued transitions in order.  Exactly one thread
        drains at a time; a thread arriving while another is emitting
        (including a reentrant update() from inside on_transition)
        leaves its event queued — the active drainer's loop picks it
        up, preserving FIFO delivery without holding any lock across
        user code."""
        while True:
            with self._lock:
                if self._emitting or not self._pending:
                    return
                self._emitting = True
                evt = self._pending.popleft()
            try:
                self._record(*evt)
            finally:
                with self._lock:
                    self._emitting = False

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

    def _record(self, old, new, pressure):
        if self._gauge is not None:
            try:
                self._gauge.set(int(new))
            except Exception:
                pass
        try:
            with obs.span("resilience.health", from_state=old.name,
                          to_state=new.name,
                          pressure=round(pressure, 4)):
                pass
        except Exception:
            pass
        if self.on_transition is not None:
            try:
                self.on_transition(old, new, pressure)
            except Exception:
                pass
