"""Serving metrics: counters, gauges and latency histograms, exposed as
one plain-dict snapshot (counterpart of ``paddle_tpu/serving/metrics.py``).

Backing store: the process-wide :mod:`paddle_tpu_torch.observability`
registry. ``Histogram`` here IS ``observability.metrics.Histogram``,
every latency histogram is registered under an engine-labeled
Prometheus name (``serving_ttft_seconds{engine=...}``), and
``note_compile`` bumps the registry's ``serving_compile_total`` counter,
so the registry's report and the Prometheus exporter see the engine's
compile count, TTFT and inter-token latency directly. A compile is one
program the engine builds with a cold build's work: a captured CUDA
graph on CUDA, the plain function on the CPU; a program built from a
record of the AOT program cache (``serving/aot_cache.py``) is a load
(``note_aot_load``, ``serving_aot_load_total``), not a compile. The
`snapshot()` dict stays the coarse contract (`LLMEngine` registers it as
a metrics source).
"""
from __future__ import annotations

import threading
import time
import weakref

from paddle_tpu_torch.observability.metrics import (Histogram, _label_key,
                                                    next_instance_label,
                                                    registry)

__all__ = ["Histogram", "EngineMetrics"]

# Live-instance count per label set.  Two engines created with the same
# explicit `metrics_name` SHARE registry instruments (same (name,
# labels) key — Prometheus semantics), so the instruments may only be
# dropped when the LAST owner releases; otherwise one engine's
# shutdown() would silently delete a live engine's histograms from the
# registry while its snapshot() kept reporting them — exactly the
# snapshot-vs-Prometheus divergence this layer exists to rule out.
_live_labels = {}
_live_lock = threading.Lock()


def _acquire_labels(labels):
    key = _label_key(labels)
    with _live_lock:
        _live_labels[key] = _live_labels.get(key, 0) + 1


def _release_labels(labels):
    key = _label_key(labels)
    # Drop while still holding _live_lock: deciding n==0 and then
    # dropping outside the lock would let a same-named engine created
    # in the gap lose its freshly re-created instruments.
    with _live_lock:
        n = _live_labels.get(key, 0) - 1
        if n > 0:
            _live_labels[key] = n
            return
        _live_labels.pop(key, None)
        if n == 0:
            registry().drop_labeled(labels)


class EngineMetrics:
    """All engine counters in one place; `snapshot()` is the contract.

    ``clock`` (default the host's perf_counter; a virtual clock makes
    latency accounting deterministic) is the engine's whole timebase:
    arrival stamps, deadlines, latency histograms. It is this instance's
    own, so one engine's clock never reaches another's. ``name`` labels
    this instance's registry instruments; an unnamed instance (tests,
    ad-hoc use) gets a unique generated label so two engines never share
    a histogram by accident."""

    def __init__(self, clock=time.perf_counter, name=None):
        self.clock = clock
        self.started_t = clock()
        reg = registry()
        self.labels = {"engine": name or next_instance_label("engine")}
        labels = self.labels
        _acquire_labels(labels)
        self._released = False
        # GC safety net: an instance dropped without release() must
        # still decrement the live count, or the labels leak forever
        self._finalizer = weakref.finalize(
            self, _release_labels, dict(labels))
        # counters
        self.requests_received = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self.requests_evicted = 0
        self.requests_rejected = 0   # backpressure (queue_full/draining)
        self.requests_expired = 0    # deadline enforcement
        self.requests_adopted = 0    # router failover migrations in
        self.decode_fault_recoveries = 0
        self.guard_anomalies = 0     # guard-flagged requests
        self.prefill_steps = 0
        self.decode_steps = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.compile_count = 0
        self.compile_bound = 0
        self.aot_cache_loads = 0     # programs built from a cache record
        self._compile_counter = reg.counter(
            "serving_compile_total", labels=labels,
            help="programs built by the serving engine")
        self._aot_load_counter = reg.counter(
            "serving_aot_load_total", labels=labels,
            help="programs built from the AOT cache's record of a cold "
                 "build")
        # gauges (engine pushes current values)
        self.queue_depth = 0
        self.running = 0
        self.pages_in_use = 0
        self.pages_total = 0
        self.health = "healthy"      # engine-pushed health-state name
        self.health_state = reg.gauge(
            "serving_health_state", labels=labels,
            help="engine health: 0 healthy / 1 degraded / 2 draining")
        # live admission signals for a scrape
        # (observability.export.serve_prometheus): refreshed from the
        # plain attrs above by sync_gauges() at every engine step
        self.queue_depth_gauge = reg.gauge(
            "serving_queue_depth", labels=labels,
            help="requests waiting for admission")
        self.page_occupancy_gauge = reg.gauge(
            "serving_page_occupancy", labels=labels,
            help="KV page-pool occupancy fraction (0..1)")
        # histograms (seconds) — registry-owned, engine-labeled
        self.ttft = reg.histogram(
            "serving_ttft_seconds", labels=labels,
            help="time to first token")
        # TTFT stage decomposition (fleettrace): for a fresh request
        # TTFT = queue + prefill exactly; decode is the resume latency
        # of adopted work (adoption on THIS engine to the first token it
        # produces) and is absent otherwise
        self.ttft_queue = reg.histogram(
            "serving_ttft_queue_seconds", labels=labels,
            help="TTFT stage: arrival to prefill start (queue wait)")
        self.ttft_prefill = reg.histogram(
            "serving_ttft_prefill_seconds", labels=labels,
            help="TTFT stage: prefill start to first token")
        self.ttft_decode = reg.histogram(
            "serving_ttft_decode_seconds", labels=labels,
            help="TTFT stage: adoption/import to first resumed token")
        self.inter_token = reg.histogram(
            "serving_inter_token_seconds", labels=labels,
            help="inter-token latency")
        self.e2e_latency = reg.histogram(
            "serving_e2e_latency_seconds", labels=labels,
            help="request end-to-end latency")
        self.prefill_step_s = reg.histogram(
            "serving_prefill_step_seconds", labels=labels,
            help="prefill step wall time")
        self.decode_step_s = reg.histogram(
            "serving_decode_step_seconds", labels=labels,
            help="decode step wall time")

    def release(self):
        """Release this instance's claim on its registry instruments —
        a finite-lifetime engine must not grow the registry forever.
        The instruments are dropped only when the last same-labeled
        instance releases (idempotent)."""
        if self._released:
            return
        self._released = True
        self._finalizer.detach()
        _release_labels(self.labels)

    def sync_gauges(self):
        """Mirror the engine-pushed plain attrs into their registry
        gauges, so the Prometheus scrape and snapshot() can't diverge
        (same invariant the histograms get by being registry-owned)."""
        self.queue_depth_gauge.set(self.queue_depth)
        self.page_occupancy_gauge.set(
            self.pages_in_use / self.pages_total if self.pages_total
            else 0.0)

    def note_aot_load(self):
        """One program built from the AOT cache's record: not a compile,
        so outside `note_compile` and the recompile log."""
        self.aot_cache_loads += 1
        self._aot_load_counter.inc()

    def note_compile(self):
        """One program built; raises past ``compile_bound``."""
        self.compile_count += 1
        self._compile_counter.inc()
        if self.compile_bound and self.compile_count > self.compile_bound:
            raise RuntimeError(
                f"recompile storm: {self.compile_count} compiles exceeds "
                f"the declared bound {self.compile_bound} — a shape "
                f"escaped the bucket set")

    def snapshot(self):
        """Plain-dict view of everything (the reference's keys)."""
        elapsed = max(self.clock() - self.started_t, 1e-9)
        return {
            "uptime_s": round(elapsed, 3),
            "requests": {
                "received": self.requests_received,
                "admitted": self.requests_admitted,
                "finished": self.requests_finished,
                "evicted": self.requests_evicted,
                "rejected": self.requests_rejected,
                "expired": self.requests_expired,
                "adopted": self.requests_adopted,
            },
            "queue_depth": self.queue_depth,
            "running": self.running,
            "health": self.health,
            "decode_fault_recoveries": self.decode_fault_recoveries,
            "guard_anomalies": self.guard_anomalies,
            "steps": {
                "prefill": self.prefill_steps,
                "decode": self.decode_steps,
            },
            "tokens": {
                "prompt": self.prompt_tokens,
                "generated": self.generated_tokens,
                "per_s": round(self.generated_tokens / elapsed, 2),
            },
            "pages": {
                "in_use": self.pages_in_use,
                "total": self.pages_total,
                "utilization": round(
                    self.pages_in_use / self.pages_total, 4)
                if self.pages_total else 0.0,
            },
            "compiles": {
                "count": self.compile_count,
                "bound": self.compile_bound,
                "cache_loads": self.aot_cache_loads,
            },
            "ttft_ms": self.ttft.summary(),
            "inter_token_ms": self.inter_token.summary(),
            "e2e_latency_ms": self.e2e_latency.summary(),
            "prefill_step_ms": self.prefill_step_s.summary(),
            "decode_step_ms": self.decode_step_s.summary(),
        }
