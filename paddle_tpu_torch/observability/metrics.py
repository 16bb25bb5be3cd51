"""One process-wide metrics registry: Counter / Gauge / Histogram
(counterpart of ``paddle_tpu/observability/metrics.py``).

The single backing store every metric of the port flows through:
``serving.metrics.Histogram`` is the Histogram here, the serving engine
registers its snapshot as a source (:meth:`MetricsRegistry.
register_source`), and the Prometheus/JSONL exporters in
:mod:`paddle_tpu_torch.observability.export` render :meth:`collect`, so
a counter the engine bumps, a span aggregate and a recompile event land
in one report.

Instruments are keyed by ``(name, labels)``: asking for an existing
pair returns the SAME instrument (Prometheus semantics), asking for the
same name with a different kind raises. A counter increment inside a
``to_static`` step follows the spans' rules (``spans.quiet`` /
``spans.held``): it counts as often as the reference's trace-time
increment. Everything here is pure Python.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque

from paddle_tpu_torch.observability.spans import absorbed

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "next_instance_label", "registry",
]


def _label_key(labels):
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    __slots__ = ("name", "help", "labels", "_lock")
    kind = "untyped"

    def __init__(self, name, help="", labels=None):
        self.name = str(name)
        self.help = help
        self.labels = dict(labels or {})
        # Mutation is guarded per instrument: this registry is THE
        # process-wide store and observations arrive from any thread
        # (spans record thread_id; engines/steppers run off-thread), so
        # += on shared state must not lose updates at GIL preemption.
        self._lock = threading.Lock()


class Counter(_Instrument):
    """Monotonically increasing count."""

    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError("Counter can only increase")
        if absorbed(self.inc, n):
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value


class Gauge(_Instrument):
    """A value that can go up and down (queue depth, pages in use)."""

    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, v):
        self._value = float(v)

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        return self._value


class Histogram(_Instrument):
    """Bounded-memory reservoir histogram: keeps the most recent `cap`
    observations (seconds) and summarizes on demand.  `observe` is in
    per-token hot paths, so eviction must be O(1) (deque maxlen).

    The ``summary()`` contract is ``{count, mean, p50, p99}`` scaled
    (default seconds -> ms); ``serving.metrics`` uses this class.
    """

    __slots__ = ("cap", "_vals", "count", "sum")
    kind = "histogram"

    def __init__(self, cap=4096, name="", help="", labels=None):
        super().__init__(name, help, labels)
        self.cap = int(cap)
        self._vals = deque(maxlen=self.cap)
        self.count = 0
        self.sum = 0.0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self._vals.append(v)

    def _sorted_vals(self):
        # copy under the lock: sorting/iterating the live deque races
        # with a concurrent observe() (deque mutation during iteration)
        with self._lock:
            return sorted(self._vals)

    @staticmethod
    def _at(vs, q):
        idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
        return vs[idx]

    def quantiles(self, qs):
        """Reservoir values at each q in `qs` from ONE sort (a scrape
        asking for p50/p90/p99 must not re-sort per quantile); None per
        entry when empty."""
        vs = self._sorted_vals()
        if not vs:
            return [None] * len(qs)
        return [self._at(vs, q) for q in qs]

    def percentile(self, q):
        return self.quantiles((q,))[0]

    def summary(self, scale=1000.0):
        """{count, mean, p50, p99} — scaled (default: seconds -> ms)."""
        vs = self._sorted_vals()
        if not vs:
            return {"count": self.count, "mean": None, "p50": None,
                    "p99": None}
        return {
            "count": self.count,
            "mean": round(sum(vs) / len(vs) * scale, 4),
            "p50": round(self._at(vs, 0.50) * scale, 4),
            "p99": round(self._at(vs, 0.99) * scale, 4),
        }


class MetricsRegistry:
    """Process-wide instrument table + named snapshot sources.

    Sources are the coarse integration surface of long-running
    subsystems (the serving engine): a zero-arg callable returning a
    plain dict.  :meth:`report` collects every source PLUS the
    registry's own instruments under the reserved ``"observability"``
    key, so one call still sees everything.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}          # (name, label_key) -> instrument
        self._kinds = {}            # name -> kind (conflict detection)
        self._sources = {}          # name -> zero-arg callable
        self._builtins = {}         # subset of _sources surviving reset()

    # ------------------------------------------------- instruments
    def _get_or_create(self, cls, name, help, labels, **kw):
        key = (str(name), _label_key(labels))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is not None:
                if inst.kind != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, not {cls.kind}")
                return inst
            if self._kinds.get(key[0], cls.kind) != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._kinds[key[0]]}, not {cls.kind}")
            inst = cls(name=name, help=help, labels=labels, **kw)
            self._metrics[key] = inst
            self._kinds[key[0]] = cls.kind
            return inst

    def counter(self, name, help="", labels=None):
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None):
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None, cap=4096):
        return self._get_or_create(Histogram, name, help, labels, cap=cap)

    def collect(self):
        """All instruments, deterministically ordered (name, labels)."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def drop_labeled(self, labels):
        """Remove every instrument whose labels include all of `labels`
        (a finite-lifetime owner — e.g. one serving engine — releasing
        its instruments so the registry does not grow with dead owners).
        Returns the number of instruments dropped."""
        want = set(_label_key(labels))
        if not want:
            raise ValueError("drop_labeled needs at least one label")
        with self._lock:
            victims = [k for k in self._metrics if want <= set(k[1])]
            for k in victims:
                del self._metrics[k]
            for name in {k[0] for k in victims}:
                if not any(k[0] == name for k in self._metrics):
                    self._kinds.pop(name, None)
            return len(victims)

    def snapshot(self):
        """Plain-dict view: ``name{k=v,...}`` -> value / summary."""
        out = {}
        for m in self.collect():
            label = "" if not m.labels else "{" + ",".join(
                f"{k}={v}" for k, v in sorted(m.labels.items())) + "}"
            out[m.name + label] = (m.summary() if m.kind == "histogram"
                                   else m.value)
        return out

    # ---------------------------------------------------- sources
    def register_source(self, name, snapshot_fn, builtin=False):
        """Register `snapshot_fn` (zero-arg -> dict) under `name`.
        Re-registering a name replaces the previous source.  A
        ``builtin`` source (the package-level span/recompile views,
        registered once at import) survives :meth:`reset`."""
        if not callable(snapshot_fn):
            raise TypeError("snapshot_fn must be callable")
        with self._lock:
            self._sources[name] = snapshot_fn
            if builtin:
                self._builtins[name] = snapshot_fn
        return name

    def unregister_source(self, name, expected=None):
        """Remove the source under `name`.  With `expected`, remove it
        only if the registered callable is that exact object — an owner
        whose name was since re-registered by a newer owner (rolling
        restart with a stable name) must not tear down the successor."""
        with self._lock:
            if (expected is not None
                    and self._sources.get(name) is not expected):
                return
            self._sources.pop(name, None)

    def report(self):
        """{source_name: snapshot_dict} for every registered source,
        plus the registry's own instruments under ``"observability"``;
        a source that raises reports {"error": ...} instead of killing
        the whole report."""
        with self._lock:
            sources = list(self._sources.items())
        out = {}
        for name, fn in sources:
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — must not throw
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        out["observability"] = {"metrics": self.snapshot()}
        return out

    def reset(self):
        """Drop every instrument and non-builtin source (test
        isolation).  Builtin sources are re-installed because the
        package import that registered them runs only once per
        process — dropping them here would silently remove the span /
        recompile views from every later report."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._sources = dict(self._builtins)


_REGISTRY = MetricsRegistry()

# unique default label values for unnamed per-instance metric owners
# (e.g. a bare EngineMetrics() in a test): never reuse another
# instance's instruments by accident
_instance_seq = itertools.count()


def next_instance_label(prefix):
    return f"{prefix}{next(_instance_seq)}"


def registry():
    """THE process-wide registry (module singleton)."""
    return _REGISTRY
