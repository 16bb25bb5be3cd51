"""Router observability: fleet-level counters, gauges and boot-time
histograms in the process-wide :mod:`paddle_tpu_torch.observability`
registry (counterpart of ``paddle_tpu/serving/router/metrics.py``).

The design of :class:`~paddle_tpu_torch.serving.metrics.EngineMetrics`,
one level up: every instrument is registry-owned under a
``router=<name>`` label (``router_spillover_total{router=...}``), so
the Prometheus scrape, the registry's report and :meth:`snapshot` never
diverge. Boot times are split cold and warm: the AOT program cache's
payoff.
"""
from __future__ import annotations

import time
import weakref

from paddle_tpu_torch.observability.metrics import (next_instance_label,
                                                    registry)
from paddle_tpu_torch.serving.metrics import _acquire_labels, _release_labels

__all__ = ["RouterMetrics"]


class RouterMetrics:
    """All router counters in one place; `snapshot()` is the contract."""

    def __init__(self, clock=time.perf_counter, name=None):
        self.clock = clock
        self.started_t = clock()
        reg = registry()
        self.labels = {"router": name or next_instance_label("router")}
        labels = self.labels
        _acquire_labels(labels)
        self._released = False
        self._finalizer = weakref.finalize(
            self, _release_labels, dict(labels))
        # counters (plain attrs mirrored into registry instruments)
        self.requests_received = 0
        self.requests_routed = 0
        self.requests_rejected = 0    # every replica refused
        self.requests_finished = 0
        self.spillovers = 0           # AdmissionRejected → next replica
        self.failovers = 0            # replica crashes handled
        self.adoptions = 0            # requests migrated off a replica
        self.respawns = 0             # replicas re-booted
        self.drains = 0               # router-initiated drains
        self.generated_tokens = 0
        self._spill_counter = reg.counter(
            "router_spillover_total", labels=labels,
            help="admissions spilled to another replica on rejection")
        self._failover_counter = reg.counter(
            "router_failover_total", labels=labels,
            help="replica failures absorbed by migration")
        self._respawn_counter = reg.counter(
            "router_respawn_total", labels=labels,
            help="replica engines re-booted by the router")
        # gauges
        self.replicas_live = 0
        self.replicas_draining = 0
        self.replicas_live_gauge = reg.gauge(
            "router_replicas_live", labels=labels,
            help="replicas accepting or finishing work")
        self.replicas_draining_gauge = reg.gauge(
            "router_replicas_draining", labels=labels,
            help="replicas draining (no new admissions)")
        # histograms (seconds, registry convention)
        self.boot_cold_s = reg.histogram(
            "router_boot_cold_seconds", labels=labels,
            help="replica boot time when programs were built cold")
        self.boot_warm_s = reg.histogram(
            "router_boot_warm_seconds", labels=labels,
            help="replica boot time when programs were built from the AOT "
                 "cache's records")

    def release(self):
        """Drop the registry claim (idempotent; last release wins)."""
        if self._released:
            return
        self._released = True
        self._finalizer.detach()
        _release_labels(self.labels)

    def note_spillover(self):
        self.spillovers += 1
        self._spill_counter.inc()

    def note_failover(self):
        self.failovers += 1
        self._failover_counter.inc()

    def note_respawn(self):
        self.respawns += 1
        self._respawn_counter.inc()

    def note_boot(self, seconds, warm):
        (self.boot_warm_s if warm else self.boot_cold_s).observe(seconds)

    def sync_gauges(self, live, draining):
        self.replicas_live = live
        self.replicas_draining = draining
        self.replicas_live_gauge.set(live)
        self.replicas_draining_gauge.set(draining)

    def snapshot(self):
        elapsed = max(self.clock() - self.started_t, 1e-9)
        return {
            "uptime_s": round(elapsed, 3),
            "requests": {
                "received": self.requests_received,
                "routed": self.requests_routed,
                "rejected": self.requests_rejected,
                "finished": self.requests_finished,
            },
            "spillovers": self.spillovers,
            "failovers": self.failovers,
            "adoptions": self.adoptions,
            "respawns": self.respawns,
            "drains": self.drains,
            "replicas": {
                "live": self.replicas_live,
                "draining": self.replicas_draining,
            },
            "tokens": {
                "generated": self.generated_tokens,
                "per_s": round(self.generated_tokens / elapsed, 2),
            },
            "boot_cold_ms": self.boot_cold_s.summary(),
            "boot_warm_ms": self.boot_warm_s.summary(),
        }
