"""One routed engine replica: lifecycle state and the telemetry view
the router balances on (counterpart of
``paddle_tpu/serving/router/replica.py``).

A :class:`ReplicaHandle` wraps a live
:class:`~paddle_tpu_torch.serving.LLMEngine` with the router-level
lifecycle (ACTIVE -> DRAINING -> DEAD, plus respawn generations) and
exposes the engine's admission signals (queue depth, page occupancy,
the hysteretic health state) as a deterministic routing score. It reads
nothing but that telemetry, the same a remote router would scrape from
``observability.export.serve_prometheus``.
"""
from __future__ import annotations

import enum

__all__ = ["ReplicaState", "ReplicaHandle"]


class ReplicaState(enum.Enum):
    ACTIVE = "active"        # routable
    DRAINING = "draining"    # finishes owned work; no new admissions
    DEAD = "dead"            # crashed or drained-out; awaiting respawn


class ReplicaHandle:
    """Router-side view of one engine replica.

    Mutable state (`state`, `engine`, `generation`) is owned by the
    Router and mutated only under the Router's lock.
    """

    def __init__(self, index, engine, generation=0, boot_info=None):
        self.index = int(index)
        self.engine = engine
        self.state = ReplicaState.ACTIVE
        self.generation = int(generation)   # bumped per respawn
        self.boot_info = dict(boot_info or {})

    # ------------------------------------------------------- telemetry
    @property
    def alive(self):
        return self.state is not ReplicaState.DEAD

    @property
    def admitting(self):
        """Routable right now (router-level lifecycle only).  An
        engine-health-DRAINING replica stays a candidate: its health
        score already sorts it last, and if it IS tried its engine
        answers with the machine-readable ``AdmissionRejected`` the
        router's spillover path consumes — the backpressure contract,
        not a silent filter."""
        return self.state is ReplicaState.ACTIVE

    def telemetry(self):
        """The admission signals — the same quantities the
        ``serving_queue_depth`` / ``serving_page_occupancy`` scrape
        gauges export, read live at the source so burst admissions
        between step boundaries see each other land."""
        e = self.engine
        return {
            "health": int(e.health.state),
            "queue_depth": int(e.queue_depth),
            "page_occupancy": round(float(e.page_occupancy), 4),
            "running": int(e.num_running),
        }

    def score(self):
        """Deterministic routing preference: healthier, emptier-queued,
        lower-occupancy replicas first; replica index breaks ties so
        two identical runs route identically."""
        t = self.telemetry()
        return (t["health"], t["queue_depth"], t["page_occupancy"],
                t["running"], self.index)

    def describe(self):
        d = {"index": self.index, "state": self.state.value,
             "generation": self.generation}
        d.update(self.telemetry())
        if self.boot_info:
            d["boot"] = dict(self.boot_info)
        return d

    def __repr__(self):
        return (f"ReplicaHandle({self.index}, {self.state.value}, "
                f"gen={self.generation})")
