"""SLO autoscaler: a hysteretic policy loop over the fleet's telemetry,
scaling the replica set through the router's own park / unpark (drain
and respawn queue) (counterpart of
``paddle_tpu/serving/traffic/autoscaler.py``).

The policy reads the per-replica queue depth and page occupancy
(``ReplicaHandle.telemetry()``) and an optional TTFT-p99 feed, and
compares them against a declared :class:`SLO`. It never looks inside an
engine.

**Hysteresis, so it never flaps**: a breach must persist for
``up_after`` consecutive observations before a scale-up, a clear for
``down_after`` (larger) before a scale-down, readings in the dead band
between ``queue_low`` and ``queue_high`` reset both streaks, and every
action starts a ``cooldown`` window in which no other action fires.

**Scale-up rides the respawn queue**: ``router.unpark(i)`` re-queues a
parked (spare) slot and the next ``router.step()`` boots it, outside the
router lock and warm from the shared AOT program cache. Scale-down is
``router.park(i)``: a drain whose emptied slot is not respawned. The
reaction time (unpark to replica admitting) is recorded in
``traffic_scaleup_reaction_seconds`` on the injected clock.
"""
from __future__ import annotations

import threading
import time

from paddle_tpu_torch.observability import span
from paddle_tpu_torch.observability.metrics import (next_instance_label,
                                                    registry)
from paddle_tpu_torch.serving.metrics import _acquire_labels, _release_labels
from paddle_tpu_torch.serving.router.replica import ReplicaState

__all__ = ["SLO", "AutoscalerConfig", "SLOAutoscaler"]


class SLO:
    """Declared service-level objectives (JSON-able, FaultPlan house
    style).  ``queue_high``/``queue_low`` bound the dead band on mean
    queue depth; ``occupancy_high`` guards the page pool; a TTFT p99
    bound applies when the caller wires a TTFT feed."""

    def __init__(self, ttft_p99_s=0.5, queue_high=6.0, queue_low=1.0,
                 occupancy_high=0.85):
        if queue_low >= queue_high:
            raise ValueError("queue_low must be < queue_high "
                             "(the hysteresis dead band)")
        if not 0.0 < occupancy_high <= 1.0:
            raise ValueError("occupancy_high must be in (0, 1]")
        self.ttft_p99_s = float(ttft_p99_s)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.occupancy_high = float(occupancy_high)

    def to_dict(self):
        return {"ttft_p99_s": self.ttft_p99_s,
                "queue_high": self.queue_high,
                "queue_low": self.queue_low,
                "occupancy_high": self.occupancy_high}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("ttft_p99_s", 0.5), d.get("queue_high", 6.0),
                   d.get("queue_low", 1.0),
                   d.get("occupancy_high", 0.85))

    def __repr__(self):
        return (f"SLO(ttft_p99_s={self.ttft_p99_s}, "
                f"queue=[{self.queue_low},{self.queue_high}], "
                f"occupancy_high={self.occupancy_high})")


class AutoscalerConfig:
    """Hysteresis knobs.  ``up_after`` < ``down_after`` by default:
    scaling up is cheap (warm boot) and protects the SLO; scaling down
    only saves capacity, so it must be much surer."""

    def __init__(self, min_replicas=1, max_replicas=None, up_after=2,
                 down_after=8, cooldown=4):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if up_after < 1 or down_after < 1 or cooldown < 0:
            raise ValueError("up_after/down_after >= 1, cooldown >= 0")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas) \
            if max_replicas is not None else None
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self.cooldown = int(cooldown)

    def to_dict(self):
        return {"min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "up_after": self.up_after,
                "down_after": self.down_after,
                "cooldown": self.cooldown}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("min_replicas", 1), d.get("max_replicas"),
                   d.get("up_after", 2), d.get("down_after", 8),
                   d.get("cooldown", 4))


class SLOAutoscaler:
    """The policy loop (module docstring has the semantics).

    Drive it either by calling :meth:`observe` once per scheduling
    quantum (the traffic driver's ``on_tick`` slot — policy and load
    then share one deterministic timeline) or via the
    :meth:`start`/:meth:`stop` background thread for a live fleet.
    `ttft_p99_s_fn` is an optional zero-arg callable returning the
    current TTFT p99 in seconds (None = signal absent).
    """

    def __init__(self, router, slo=None, config=None,
                 clock=time.perf_counter, ttft_p99_s_fn=None,
                 name=None):
        self.router = router
        self.slo = slo or SLO()
        self.config = config or AutoscalerConfig()
        self.clock = clock
        self.ttft_p99_s_fn = ttft_p99_s_fn
        self.name = name or next_instance_label("autoscaler")
        self.labels = {"autoscaler": self.name}
        _acquire_labels(self.labels)
        self._released = False
        reg = registry()
        self._up_counter = reg.counter(
            "traffic_scale_up_total", labels=self.labels,
            help="replicas unparked by the SLO autoscaler")
        self._down_counter = reg.counter(
            "traffic_scale_down_total", labels=self.labels,
            help="replicas parked by the SLO autoscaler")
        self._active_gauge = reg.gauge(
            "traffic_replicas_active", labels=self.labels,
            help="replicas active in rotation, autoscaler view")
        self._reaction_hist = reg.histogram(
            "traffic_scaleup_reaction_seconds", labels=self.labels,
            help="unpark decision to replica-admitting latency")
        self._lock = threading.Lock()
        self._stop_event = threading.Event()
        self._thread = None
        self._breach_streak = 0
        self._clear_streak = 0
        self._cooldown = 0
        self._pending_up = {}        # replica index -> decision time
        self.scale_ups = 0
        self.scale_downs = 0
        self.reaction_times = []     # seconds, per completed scale-up
        self.observations = 0

    # --------------------------------------------------------- signals
    def _read_signals(self):
        """(active_handles, parked_indices, mean_queue, max_occupancy)
        — all from router-public telemetry."""
        replicas = self.router.replicas
        parked = self.router.parked
        active = [h for h in replicas
                  if h.state is ReplicaState.ACTIVE
                  and h.index not in parked]
        if not active:
            return active, parked, float("inf"), 1.0
        tele = [h.telemetry() for h in active]
        mean_q = sum(t["queue_depth"] + t["running"]
                     for t in tele) / len(tele)
        max_occ = max(t["page_occupancy"] for t in tele)
        return active, parked, mean_q, max_occ

    # --------------------------------------------------------- observe
    def observe(self):
        """One policy evaluation; returns ``"scale_up"``,
        ``"scale_down"``, or None.  Deterministic given the telemetry
        sequence — no wall clock, no RNG."""
        # user callbacks (clock, TTFT probe) run OUTSIDE _lock: either
        # may block or re-enter the autoscaler
        now = self.clock()
        p99 = self.ttft_p99_s_fn() if self.ttft_p99_s_fn else None
        with self._lock:
            self.observations += 1
            active, parked, mean_q, max_occ = self._read_signals()
            self._active_gauge.set(len(active))
            # close out completed scale-ups (reaction-time record)
            for idx in list(self._pending_up):
                h = next((r for r in self.router.replicas
                          if r.index == idx), None)
                if h is not None and h.admitting:
                    dt = now - self._pending_up.pop(idx)
                    self.reaction_times.append(dt)
                    self._reaction_hist.observe(dt)
            breach = (mean_q > self.slo.queue_high
                      or max_occ > self.slo.occupancy_high
                      or (p99 is not None
                          and p99 > self.slo.ttft_p99_s))
            clear = (mean_q < self.slo.queue_low
                     and max_occ <= self.slo.occupancy_high
                     and (p99 is None or p99 <= self.slo.ttft_p99_s))
            if breach:
                self._breach_streak += 1
                self._clear_streak = 0
            elif clear:
                self._clear_streak += 1
                self._breach_streak = 0
            else:
                # dead band: neither streak may grow — this is the
                # hysteresis that keeps an oscillating load from
                # flapping the fleet
                self._breach_streak = 0
                self._clear_streak = 0
            if self._cooldown > 0:
                self._cooldown -= 1
                return None
            if (self._breach_streak >= self.config.up_after
                    and parked
                    and (self.config.max_replicas is None
                         or len(active) < self.config.max_replicas)):
                idx = min(parked)
                self.router.unpark(idx)
                self._pending_up[idx] = now
                self.scale_ups += 1
                self._up_counter.inc()
                self._breach_streak = 0
                self._cooldown = self.config.cooldown
                with span("serving.traffic.scale_up", replica=idx,
                          mean_queue=round(mean_q, 2),
                          occupancy=round(max_occ, 3)):
                    pass
                return "scale_up"
            if (self._clear_streak >= self.config.down_after
                    and len(active) > self.config.min_replicas
                    and not self._pending_up):
                # deterministic victim: the highest-index active
                # replica (same tie-break direction as routing scores)
                idx = max(h.index for h in active)
                self.router.park(idx)
                self.scale_downs += 1
                self._down_counter.inc()
                self._clear_streak = 0
                self._cooldown = self.config.cooldown
                with span("serving.traffic.scale_down", replica=idx,
                          mean_queue=round(mean_q, 2)):
                    pass
                return "scale_down"
            return None

    # --------------------------------------------------- background loop
    def start(self, interval_s=0.05):
        """Spawn the live policy loop (daemon thread; idempotent).  Use
        only outside the virtual-time driver — under the driver, slot
        :meth:`observe` into ``on_tick`` instead."""
        with self._lock:
            if self._thread is not None:
                return self._thread
            self._stop_event.clear()
            t = threading.Thread(target=self._loop,
                                 args=(float(interval_s),),
                                 name=f"{self.name}.loop", daemon=True)
            self._thread = t
        t.start()
        return t

    def _loop(self, interval_s):
        while not self._stop_event.is_set():
            try:
                self.observe()
            except Exception as e:
                # the policy loop must survive a bad observation (a
                # replica mid-respawn can race telemetry reads) —
                # record and keep watching, never die silently
                with span("serving.traffic.autoscaler_error",
                          exc=type(e).__name__):
                    pass
            self._stop_event.wait(interval_s)

    def stop(self):
        """Stop and join the loop (no-op when not running)."""
        self._stop_event.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    # ----------------------------------------------------------- report
    def snapshot(self):
        with self._lock:
            return {
                "observations": self.observations,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "reaction_times_s": [round(t, 6)
                                     for t in self.reaction_times],
                "pending_scale_ups": len(self._pending_up),
                "slo": self.slo.to_dict(),
                "config": self.config.to_dict(),
            }

    def release(self):
        """Stop the loop and drop the registry claim (idempotent)."""
        self.stop()
        if self._released:
            return
        self._released = True
        _release_labels(self.labels)
