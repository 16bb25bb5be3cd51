"""Serving metrics: plain counters, gauges and latency histograms,
exposed as one plain-dict snapshot (counterpart of
``paddle_tpu/serving/metrics.py``; the port has no observability
registry yet). A compile is one program the engine builds: a captured
CUDA graph on CUDA, the plain function on the CPU.
"""
from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["EngineMetrics", "Histogram"]


class Histogram:
    """Bounded-memory reservoir of the most recent ``cap`` observations
    (seconds), summarized on demand."""

    def __init__(self, cap=4096):
        self.cap = int(cap)
        self._vals = deque(maxlen=self.cap)
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self._vals.append(v)

    def _sorted_vals(self):
        with self._lock:
            return sorted(self._vals)

    @staticmethod
    def _at(vs, q):
        idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
        return vs[idx]

    def summary(self, scale=1000.0):
        """{count, mean, p50, p99} — scaled (default: seconds -> ms)."""
        vs = self._sorted_vals()
        if not vs:
            return {"count": self.count, "mean": None, "p50": None,
                    "p99": None}
        return {
            "count": self.count,
            "mean": sum(vs) / len(vs) * scale,
            "p50": self._at(vs, 0.50) * scale,
            "p99": self._at(vs, 0.99) * scale,
        }


class EngineMetrics:
    """All engine counters in one place; `snapshot()` is the contract.
    ``clock`` (default the host's perf_counter; a virtual clock makes
    latency accounting deterministic) is the engine's whole timebase:
    arrival stamps, deadlines, latency histograms. It is this instance's
    own, so one engine's clock never reaches another's."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.started_t = clock()
        # counters
        self.requests_received = 0
        self.requests_admitted = 0
        self.requests_finished = 0
        self.requests_evicted = 0
        self.requests_rejected = 0   # backpressure (queue_full/draining)
        self.requests_expired = 0    # deadline enforcement
        self.decode_fault_recoveries = 0
        self.guard_anomalies = 0     # guard-flagged requests
        self.prefill_steps = 0
        self.decode_steps = 0
        self.prompt_tokens = 0
        self.generated_tokens = 0
        self.compile_count = 0
        self.compile_bound = 0       # 0: no bound (the engine sets it)
        self.aot_cache_loads = 0     # no AOT program cache yet: stays 0
        # gauges (engine pushes current values)
        self.queue_depth = 0
        self.running = 0
        self.pages_in_use = 0
        self.pages_total = 0
        self.health = "healthy"
        # histograms (seconds)
        self.ttft = Histogram()
        self.inter_token = Histogram()
        self.e2e_latency = Histogram()
        self.prefill_step_s = Histogram()
        self.decode_step_s = Histogram()

    def note_compile(self):
        """One program built; raises past ``compile_bound``."""
        self.compile_count += 1
        if self.compile_bound and self.compile_count > self.compile_bound:
            raise RuntimeError(
                f"recompile storm: {self.compile_count} compiles exceeds "
                f"the declared bound {self.compile_bound} — a shape "
                f"escaped the bucket set")

    def snapshot(self):
        """Plain-dict view of everything (the reference's keys, less the
        fleet counters)."""
        elapsed = max(self.clock() - self.started_t, 1e-9)
        return {
            "uptime_s": elapsed,
            "requests": {
                "received": self.requests_received,
                "admitted": self.requests_admitted,
                "finished": self.requests_finished,
                "evicted": self.requests_evicted,
                "rejected": self.requests_rejected,
                "expired": self.requests_expired,
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
                "per_s": self.generated_tokens / elapsed,
            },
            "pages": {
                "in_use": self.pages_in_use,
                "total": self.pages_total,
                "utilization": (self.pages_in_use / self.pages_total
                                if self.pages_total else 0.0),
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
