"""Open-loop trace replay against a
:class:`~paddle_tpu_torch.serving.router.Router` on a virtual clock
(counterpart of ``paddle_tpu/serving/traffic/driver.py``).

**Open-loop**: arrivals come from the compiled trace's schedule, never
from the fleet's completion rate, so the generator keeps offering load
at the spec's QPS while queues build (a closed loop throttles itself and
hides saturation).

**Virtual time** makes the measurement deterministic: the driver owns a
:class:`VirtualClock` that advances by exactly ``quantum_s`` per fleet
step, and the same clock is injected into the router and every engine
(``Router(clock=...)`` -> ``EngineMetrics.clock``), so arrival stamps,
deadlines, TTFT histograms and goodput counters are functions of the
spec alone: two same-seed runs give identical reports and metric
snapshots. One fleet step models one quantum; wall time never enters.

Outcomes land in the observability registry under a ``traffic=<name>``
label: ``traffic_goodput_total``, ``traffic_slo_violation_total``,
per-class ``traffic_ttft_seconds{class=...}`` histograms. A request
counts toward goodput only if it finished normally, with every expected
token, within its class's TTFT SLO; everything else (deadline expiry, a
late first token, a lost admission) is an SLO violation.

Chaos composes: ``spec.fault_plan`` (a FaultPlan dict) is armed around
the run, and each tick polls the ``serving.traffic.tick`` fault site: a
``qps_surge`` spec there injects ``payload["requests"]`` extra arrivals
(compiled from the same seed, so the surge replays identically).
"""
from __future__ import annotations

import threading

from paddle_tpu_torch.observability.metrics import (next_instance_label,
                                                    registry)
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.serving.metrics import _acquire_labels, _release_labels
from paddle_tpu_torch.serving.scheduler import AdmissionRejected
from paddle_tpu_torch.serving.traffic.workload import (TrafficSpec,
                                                       compile_trace)

__all__ = ["VirtualClock", "TrafficDriver", "TrafficMetrics"]

_SURGE_BASE = 1 << 20   # surge request indices: disjoint from any trace


class VirtualClock:
    """A deterministic, caller-advanced clock — drop-in for
    ``time.perf_counter`` wherever a clock is injectable
    (``EngineMetrics.clock``, ``Router(clock=...)``).  Monotonic by
    construction: only :meth:`advance` moves it, forward only."""

    def __init__(self, start=0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self._now

    @property
    def now(self):
        return self()

    def advance(self, dt):
        if dt < 0:
            raise ValueError("a clock only advances")
        with self._lock:
            self._now += float(dt)
            return self._now

    def __repr__(self):
        return f"VirtualClock({self():.6f}s)"


class TrafficMetrics:
    """The traffic run's registry instruments, all labeled
    ``traffic=<name>`` (+ ``class=`` on the per-class TTFT
    histograms).  Same refcounted label lifecycle as
    :class:`~paddle_tpu_torch.serving.metrics.EngineMetrics`: instruments are
    dropped when the last same-named owner releases."""

    def __init__(self, name=None):
        self.name = name or next_instance_label("traffic")
        self.labels = {"traffic": self.name}
        reg = registry()
        _acquire_labels(self.labels)
        self._released = False
        self._class_labels = {}
        self.offered = reg.counter(
            "traffic_offered_total", labels=self.labels,
            help="requests offered by the load generator")
        self.goodput = reg.counter(
            "traffic_goodput_total", labels=self.labels,
            help="requests completed in full within their TTFT SLO")
        self.slo_violation = reg.counter(
            "traffic_slo_violation_total", labels=self.labels,
            help="requests that missed their SLO (late, expired, lost)")
        self.expired = reg.counter(
            "traffic_expired_total", labels=self.labels,
            help="requests expired by engine deadline enforcement")
        self.admission_retry = reg.counter(
            "traffic_admission_retry_total", labels=self.labels,
            help="admission attempts deferred by fleet backpressure")
        self.surge_injected = reg.counter(
            "traffic_surge_injected_total", labels=self.labels,
            help="extra requests injected by a qps_surge fault")
        self.inflight = reg.gauge(
            "traffic_inflight", labels=self.labels,
            help="requests admitted and not yet finished")
        self.itl = reg.histogram(
            "traffic_itl_seconds", labels=self.labels,
            help="inter-token latency under the traffic run (virtual)")

    def class_ttft(self, cls):
        labels = self._class_labels.get(cls)
        if labels is None:
            labels = dict(self.labels)
            labels["class"] = cls
            _acquire_labels(labels)
            self._class_labels[cls] = labels
        return registry().histogram(
            "traffic_ttft_seconds", labels=labels,
            help="time to first token by deadline class (virtual)")

    def release(self):
        if self._released:
            return
        self._released = True
        for labels in self._class_labels.values():
            _release_labels(labels)
        _release_labels(self.labels)


class _Flight:
    """Driver-side shadow of one offered request."""

    __slots__ = ("treq", "rid", "first_t", "last_t", "tokens",
                 "finished", "reason")

    def __init__(self, treq):
        self.treq = treq
        self.rid = None
        self.first_t = None
        self.last_t = None
        self.tokens = 0
        self.finished = False
        self.reason = None


class TrafficDriver:
    """Replay one :class:`TrafficSpec` against `router` (module
    docstring has the semantics).  The driver OWNS stepping: it calls
    ``router.step()`` once per quantum — don't also run the router's
    background loop, or service time stops being modeled.

    `clock` must be the same :class:`VirtualClock` the router (and
    through it every engine) was built with; `on_tick(driver)` is an
    optional per-quantum hook — the SLO autoscaler's ``observe`` slots
    in here so policy and load share one timeline.
    """

    def __init__(self, router, spec, clock, quantum_s=0.005, name=None,
                 max_ticks=250000, stall_ticks=4096, on_tick=None):
        if not isinstance(spec, TrafficSpec):
            spec = TrafficSpec.from_dict(spec)
        self.router = router
        self.spec = spec
        self.clock = clock
        self.quantum_s = float(quantum_s)
        self.max_ticks = int(max_ticks)
        self.stall_ticks = int(stall_ticks)
        self.on_tick = on_tick
        self.metrics = TrafficMetrics(name or spec.name)
        self._lock = threading.Lock()
        self._flights = {}          # rid -> _Flight
        self._done_log = []         # (flight, ttft, complete)
        self.ticks = 0
        self._surge_fired = 0

    # --------------------------------------------------------- streaming
    def _stream_for(self, fl):
        clock = self.clock
        lock = self._lock
        itl = self.metrics.itl

        def _stream(rid, tok, fin):
            now = clock()
            with lock:
                if tok is not None:
                    fl.tokens += 1
                    if fl.first_t is None:
                        fl.first_t = now
                    elif fl.last_t is not None:
                        itl.observe(now - fl.last_t)
                    fl.last_t = now
                if fin:
                    fl.finished = True

        return _stream

    # --------------------------------------------------------- admission
    def _try_admit(self, fl):
        """One admission attempt; True when placed.  Rejections are
        backpressure, not failures — the flight retries next tick with
        its ORIGINAL arrival time still the TTFT baseline (queueing
        while rejected is latency the SLO must see)."""
        try:
            rid = self.router.add_request(
                fl.treq.prompt, fl.treq.sampling_params(),
                stream=self._stream_for(fl))
        except AdmissionRejected:
            self.metrics.admission_retry.inc()
            return False
        with self._lock:
            fl.rid = rid
            self._flights[rid] = fl
        return True

    def _surge(self, spec_hit):
        n = int(spec_hit.payload.get("requests", 8))
        extra = compile_trace(
            self.spec, count=n,
            start_index=_SURGE_BASE + self._surge_fired * 4096)
        self._surge_fired += 1
        now = self.clock()
        for treq in extra:
            treq.arrive_s = now
        self.metrics.surge_injected.inc(n)
        return [_Flight(t) for t in extra]

    # -------------------------------------------------------------- run
    def run(self):
        """Drive the trace to completion; returns the report dict (and
        leaves the same numbers in the registry instruments)."""
        plan = None
        if self.spec.fault_plan and faultinject.active_plan() is None:
            plan = faultinject.FaultPlan.from_dict(self.spec.fault_plan)
        if plan is not None:
            with faultinject.FaultInjector(plan):
                return self._run()
        return self._run()

    def _run(self):
        trace = compile_trace(self.spec)
        self.metrics.offered.inc(len(trace))
        waiting = [_Flight(t) for t in trace]   # arrival order
        retry = []
        idle = 0
        while waiting or retry or self._flights:
            if self.ticks >= self.max_ticks:
                raise RuntimeError(
                    f"traffic run exceeded max_ticks={self.max_ticks} "
                    f"({len(self._flights)} in flight, "
                    f"{len(waiting) + len(retry)} unadmitted)")
            spec_hit = faultinject.fire("serving.traffic.tick",
                                        tick=self.ticks)
            if spec_hit is not None and spec_hit.kind == "qps_surge":
                surge = self._surge(spec_hit)
                self.metrics.offered.inc(len(surge))
                retry.extend(surge)
            now = self.clock()
            while waiting and waiting[0].treq.arrive_s <= now:
                retry.append(waiting.pop(0))
            still = []
            for fl in retry:
                if not self._try_admit(fl):
                    still.append(fl)
            retry = still
            events = self.router.step()
            self._collect_finished()
            self.metrics.inflight.set(len(self._flights))
            if self.on_tick is not None:
                self.on_tick(self)
            self.clock.advance(self.quantum_s)
            self.ticks += 1
            moved = bool(events) or not self._flights
            idle = 0 if moved else idle + 1
            if idle > self.stall_ticks:
                raise RuntimeError(
                    f"traffic run stalled: {self.stall_ticks} event-free "
                    f"quanta with {len(self._flights)} requests in "
                    f"flight")
        return self._finalize(trace)

    def _collect_finished(self):
        """Close out flights whose fin streamed: the router's finished
        table is authoritative for token counts and finish reason
        (covers deadline finishes and adopted histories)."""
        with self._lock:
            done = [fl for fl in self._flights.values() if fl.finished]
            for fl in done:
                self._flights.pop(fl.rid, None)
        for fl in done:
            res = self.router.finished_results.pop(fl.rid, None)
            if res is not None:
                fl.tokens = len(res.output_token_ids)
                fl.reason = res.finish_reason
            self._account(fl)

    def _account(self, fl):
        t = fl.treq
        ttft = (fl.first_t - t.arrive_s) if fl.first_t is not None \
            else float("inf")
        self.metrics.class_ttft(t.cls).observe(
            min(ttft, 1e6))    # inf-safe: expired-before-first-token
        complete = (fl.reason in ("length", "stop", "eos")
                    and fl.tokens >= t.max_new_tokens)
        if fl.reason == "deadline":
            self.metrics.expired.inc()
        if complete and ttft <= t.ttft_slo_s:
            self.metrics.goodput.inc()
        else:
            self.metrics.slo_violation.inc()
        self._done_log.append((fl, ttft, complete))

    def _finalize(self, trace):
        by_class = {}
        goodput = violations = expired = completed = 0
        tokens_expected = tokens_generated = token_loss = 0
        for fl, ttft, complete in self._done_log:
            t = fl.treq
            by_class.setdefault(t.cls, []).append(ttft)
            if complete:
                completed += 1
            if fl.reason == "deadline":
                expired += 1
            else:
                tokens_expected += t.max_new_tokens
                tokens_generated += fl.tokens
                if fl.tokens != t.max_new_tokens:
                    token_loss += t.max_new_tokens - fl.tokens
            if complete and ttft <= t.ttft_slo_s:
                goodput += 1
            else:
                violations += 1
        offered = sum(len(v) for v in by_class.values())
        duration = self.ticks * self.quantum_s
        all_ttft = sorted(x for v in by_class.values() for x in v
                          if x != float("inf"))

        def _pct(vals, q):
            if not vals:
                return None
            i = min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))
            return round(vals[i] * 1e3, 3)

        return {
            "name": self.spec.name,
            "seed": self.spec.seed,
            "offered": offered,
            "completed": completed,
            "goodput": goodput,
            "violations": violations,
            "expired": expired,
            "goodput_frac": round(goodput / offered, 4) if offered
            else 1.0,
            "tokens_expected": tokens_expected,
            "tokens_generated": tokens_generated,
            "token_loss": token_loss,
            "duration_s": round(duration, 6),
            "offered_qps": round(offered / duration, 3) if duration
            else 0.0,
            "ttft_p50_ms": _pct(all_ttft, 0.50),
            "ttft_p99_ms": _pct(all_ttft, 0.99),
            "ttft_by_class_ms": {
                cls: _pct(sorted(x for x in v if x != float("inf")),
                          0.99)
                for cls, v in sorted(by_class.items())},
            "itl_ms": self.metrics.itl.summary(),
            "surge_injected": self._surge_fired,
            "ticks": self.ticks,
        }

    def release(self):
        """Drop the run's registry instruments (refcounted)."""
        self.metrics.release()
