"""Nested trace spans (counterpart of ``paddle_tpu/observability/spans.py``):
an always-on ring buffer, and ``torch.profiler.record_function`` while a
torch profiler is active.

``span("train_step")`` is the one annotation primitive instrumented code
uses. It does two things:

- it ALWAYS records (name, start, duration, nesting depth, thread) into
  a bounded in-process ring buffer (two monotonic clock reads and a
  deque append), exportable as Chrome-trace JSON through
  :mod:`paddle_tpu_torch.observability.export`;
- while a torch profiler runs (``torch.profiler.profile``), it ALSO
  opens ``torch.profiler.record_function(name)``, so the span shows up
  in the profile's table and trace next to the kernels.

A span reads host clocks only: it never synchronizes the device, so a
span around a step that launches work times the launches, not the
kernels.

Spans inside a ``to_static`` step fire as the reference's trace-time
spans do: while a signature is built, as often as the reference traces
it, and never on a replay or a cached call. ``jit/api.py`` does that
with :func:`quiet` (nothing recorded on this thread in the block) and
:func:`held` (records kept back, then kept or dropped), which also
govern the metrics registry's counters.

``set_enabled(False)`` turns span recording into a near-free boolean
check.

Distributed tracing: a :class:`TraceContext` names one end-to-end
request trace. Install one ambiently with :class:`use_context`
(thread-local), or pass it to a single span via ``span(..., ctx=...)``:
every span closed under a context records the trace id, a fresh span
id, and its parent span id, and nested spans parent to it.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import uuid
from collections import deque

import torch

__all__ = [
    "span", "SpanRecord", "SpanRecorder", "recorder",
    "set_enabled", "enabled", "quiet", "held",
    "TraceContext", "use_context", "current_context",
]

_state = [True]                 # list, not bool: mutation without `global`
_span_seq = itertools.count(1)


class _Local(threading.local):
    """This thread's span state; the class attributes are each thread's
    defaults, so a read never takes the missing-attribute path."""

    depth = 0                   # open spans
    ctx = None                  # ambient TraceContext
    quiet = 0                   # open quiet() blocks
    held = None                 # the held() list, if one is open


_tls = _Local()


def _new_span_id():
    # unique across processes (spools merge): pid + local counter
    return f"{os.getpid():x}.{next(_span_seq)}"


class TraceContext:
    """Identity of one distributed trace: ``(trace_id,
    parent_span_id)``. Made once per request (:meth:`new`), carried as
    :meth:`to_dict` and re-installed with :class:`use_context`, so every
    process's spans land under the originating request's trace id."""

    __slots__ = ("trace_id", "parent_span_id")

    def __init__(self, trace_id, parent_span_id=None):
        self.trace_id = str(trace_id)
        self.parent_span_id = (None if parent_span_id is None
                               else str(parent_span_id))

    @classmethod
    def new(cls, hint=None):
        tid = uuid.uuid4().hex[:16]
        return cls(f"{hint}-{tid}" if hint else tid)

    def to_dict(self):
        return {"t": self.trace_id, "s": self.parent_span_id}

    @classmethod
    def from_dict(cls, d):
        if not d:
            return None
        return cls(d["t"], d.get("s"))

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, "
                f"parent={self.parent_span_id!r})")


def current_context():
    """The thread's ambient :class:`TraceContext` (or None)."""
    return _tls.ctx


class use_context:
    """Install ``ctx`` as the thread's ambient trace context for the
    ``with`` scope (``None`` clears it). Spans opened inside record
    under it; the previous context is restored on exit."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx):
        self.ctx = ctx

    def __enter__(self):
        self._prev = _tls.ctx
        _tls.ctx = self.ctx
        return self.ctx

    def __exit__(self, exc_type, exc, tb):
        _tls.ctx = self._prev
        return False


def set_enabled(flag=True):
    """Globally enable/disable span recording; returns previous value."""
    prev = _state[0]
    _state[0] = bool(flag)
    return prev


def enabled():
    return _state[0]


# ------------------------------------------------- quiet / held records
@contextlib.contextmanager
def quiet():
    """No span and no counter increment is recorded on this thread in the
    block."""
    _tls.quiet += 1
    try:
        yield
    finally:
        _tls.quiet -= 1


class _Held(list):
    """The records and increments :func:`held` kept back."""

    def commit(self):
        """Record them now, in order (their own times)."""
        for fn, args in self:
            fn(*args)
        self.clear()


@contextlib.contextmanager
def held():
    """Spans closed and counters increased on this thread in the block
    are kept back; yields them as a list whose ``commit()`` records them
    (dropping the list drops them)."""
    prev = _tls.held
    kept = _Held()
    _tls.held = kept
    try:
        yield kept
    finally:
        _tls.held = prev


def absorbed(fn, *args):
    """True when :func:`quiet` or :func:`held` takes ``fn(*args)`` on this
    thread (dropped, or kept back); the caller then does nothing."""
    if _tls.quiet:
        return True
    kept = _tls.held
    if kept is None:
        return False
    kept.append((fn, args))
    return True


class SpanRecord:
    """One closed span (times in ns, perf_counter_ns clock base).
    ``trace_id``/``span_id``/``parent_id`` are set only for spans
    closed under a :class:`TraceContext`."""

    __slots__ = ("name", "start_ns", "dur_ns", "depth", "thread_id",
                 "attrs", "trace_id", "span_id", "parent_id")

    def __init__(self, name, start_ns, dur_ns, depth, thread_id, attrs,
                 trace_id=None, span_id=None, parent_id=None):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.depth = depth
        self.thread_id = thread_id
        self.attrs = attrs
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    def to_dict(self):
        d = {"name": self.name, "start_ns": self.start_ns,
             "dur_ns": self.dur_ns, "depth": self.depth,
             "thread_id": self.thread_id}
        if self.attrs:
            d["attrs"] = self.attrs
        if self.trace_id is not None:
            d["trace"] = self.trace_id
            d["span"] = self.span_id
            if self.parent_id is not None:
                d["parent"] = self.parent_id
        return d

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, {self.dur_ns / 1e6:.3f} ms, "
                f"depth={self.depth})")


class SpanRecorder:
    """Bounded ring buffer of closed spans + per-name aggregates.

    The buffer holds the most recent ``cap`` spans; aggregates (count,
    total ns) are kept per name, so a report can summarize even spans
    the ring has dropped."""

    def __init__(self, cap=4096):
        self._lock = threading.Lock()
        self._buf = deque(maxlen=int(cap))
        self._agg = {}              # name -> [count, total_ns]
        self._sinks = ()            # immutable tuple: lock-free read
        self.total_recorded = 0

    @property
    def capacity(self):
        return self._buf.maxlen

    def set_capacity(self, cap):
        with self._lock:
            self._buf = deque(self._buf, maxlen=int(cap))

    def add_sink(self, fn):
        """Attach ``fn(SpanRecord)``, called on every record (a telemetry
        spool's tap), outside the recorder's lock."""
        with self._lock:
            self._sinks = self._sinks + (fn,)

    def remove_sink(self, fn):
        with self._lock:
            self._sinks = tuple(s for s in self._sinks if s is not fn)

    def record(self, rec):
        with self._lock:
            self.total_recorded += 1
            self._buf.append(rec)
            agg = self._agg.get(rec.name)
            if agg is None:
                self._agg[rec.name] = [1, rec.dur_ns]
            else:
                agg[0] += 1
                agg[1] += rec.dur_ns
        for s in self._sinks:       # tuple snapshot: safe lock-free
            try:
                s(rec)
            except Exception:
                pass                # a broken spool must not kill serving

    def spans(self):
        """Snapshot list of buffered spans, oldest first."""
        with self._lock:
            return list(self._buf)

    @property
    def dropped(self):
        return self.total_recorded - len(self._buf)

    def aggregates(self):
        """{name: {"count": n, "total_ms": t}} over EVERY recorded span
        (including ones the ring buffer has since evicted)."""
        with self._lock:
            items = [(name, c, ns)
                     for name, (c, ns) in sorted(self._agg.items())]
        return {name: {"count": c, "total_ms": round(ns / 1e6, 3)}
                for name, c, ns in items}

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._agg.clear()
            self.total_recorded = 0


_RECORDER = SpanRecorder()


def recorder():
    """THE process-wide span ring buffer (module singleton)."""
    return _RECORDER


class span:
    """Context manager: ``with span("serving.decode", batch=8): ...``.

    Reentrant (each ``with`` entry uses its own instance); nesting depth
    is tracked per thread. ``ctx`` ties the span to a
    :class:`TraceContext` explicitly; with no ``ctx`` the thread's
    ambient context applies, and with neither the record carries no
    trace identity."""

    __slots__ = ("name", "attrs", "_t0", "_depth", "_ann", "_ctx",
                 "_sid", "_prev")

    def __init__(self, name, ctx=None, **attrs):
        self.name = name
        self.attrs = attrs or None
        self._ctx = ctx

    @property
    def span_id(self):
        """This span's id under its trace (None untraced / unentered)."""
        return getattr(self, "_sid", None)

    def __enter__(self):
        if not _state[0]:
            self._t0 = None
            return self
        depth = _tls.depth
        _tls.depth = depth + 1
        self._depth = depth
        ctx = self._ctx
        if ctx is None:
            ctx = _tls.ctx
        if ctx is not None:
            self._ctx = ctx
            self._sid = _new_span_id()
            # nested spans parent to THIS span for the with scope
            self._prev = _tls.ctx
            _tls.ctx = TraceContext(ctx.trace_id, self._sid)
        else:
            self._sid = None
        self._ann = None
        # under a torch profiler the span also lands in its trace
        if torch._C._autograd._profiler_enabled():
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._t0 is None:
            return False
        dur = time.perf_counter_ns() - self._t0
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        _tls.depth = self._depth
        if self._sid is not None:
            _tls.ctx = self._prev
            ctx = self._ctx
            rec = SpanRecord(
                self.name, self._t0, dur, self._depth,
                threading.get_ident(), self.attrs,
                trace_id=ctx.trace_id, span_id=self._sid,
                parent_id=ctx.parent_span_id)
        else:
            rec = SpanRecord(
                self.name, self._t0, dur, self._depth,
                threading.get_ident(), self.attrs)
        if not absorbed(_RECORDER.record, rec):
            _RECORDER.record(rec)
        return False
