"""Recompile attribution (counterpart of
``paddle_tpu/observability/recompile.py``): WHY did this program build
(again)?

A capture costs a step's discovery calls, a CUDA-graph capture and the
graph's memory, so an unexpected rebuild is worth naming. The port's two
build points both report here:

- ``jit.api.StaticFunction`` on every cache miss calls
  :func:`note_jit_compile`, which diffs the new cache key against the
  NEAREST key built before and records WHICH argument's shape / dtype /
  device / static leaf (or the state registry) changed, plus the
  wall-clock discovery-and-capture time and the first replay's;
- ``serving.LLMEngine._compile`` calls :func:`note_aot_compile` for its
  planned program set, so the serving compile counter and the jit log
  share one timeline (and one registry counter,
  ``obs_recompile_total``).

The port's ``StaticFunction`` key is ``(argument structure, ((shape,
dtype, device), ...) of the tensor arguments, statics, registry
version)``; the reference's is ``(treedef, ((shape, dtype), ...),
statics, registry version)``. :func:`diff_keys` reads either and writes
the reference's ``changes`` and causes, dtypes spelled as the reference
spells them (``"float32"``, ``"bfloat16"``); a device change is its own
kind, ``device``.

Events land in a bounded ring buffer, are summarized into the metrics
registry, and render through the JSONL exporter.
"""
from __future__ import annotations

import threading
import time
from collections import deque

from paddle_tpu_torch.observability import metrics as _metrics

__all__ = [
    "RecompileEvent", "RecompileLog", "recompile_log", "diff_keys",
    "note_jit_compile", "note_aot_compile",
]


class RecompileEvent:
    """One compile event.

    ``changes`` is a list of ``{"arg", "kind", "before", "after"}``
    dicts — `kind` one of shape/dtype/device/static/state/traced —
    empty for a first compile or a planned AOT compile."""

    __slots__ = ("seq", "wall_time", "t_ns", "fn", "kind", "cause",
                 "changes", "trace_ms", "compile_ms", "cache_size",
                 "attrs")

    def __init__(self, seq, fn, kind, cause, changes, trace_ms=None,
                 compile_ms=None, cache_size=None, attrs=None):
        self.seq = seq
        self.wall_time = time.time()
        # monotonic twin of wall_time on the SAME clock the span ring
        # buffer uses — so the Chrome-trace exporter can place compile
        # events on the span timeline (an instant marker at the step
        # where the retrace happened)
        self.t_ns = time.perf_counter_ns()
        self.fn = fn
        self.kind = kind                # "jit" | "serving-aot"
        self.cause = cause
        self.changes = changes
        self.trace_ms = trace_ms
        self.compile_ms = compile_ms
        self.cache_size = cache_size
        self.attrs = attrs or {}

    def changed_args(self):
        return [c["arg"] for c in self.changes]

    def to_dict(self):
        return {
            "seq": self.seq,
            "wall_time": round(self.wall_time, 3),
            "t_ns": self.t_ns,
            "fn": self.fn,
            "kind": self.kind,
            "cause": self.cause,
            "changes": self.changes,
            "trace_ms": self.trace_ms,
            "compile_ms": self.compile_ms,
            "cache_size": self.cache_size,
            "attrs": self.attrs,
        }

    def format(self):
        parts = [f"#{self.seq} [{self.kind}] {self.fn}: {self.cause}"]
        for c in self.changes:
            parts.append(f"    {c['arg']}: {c['kind']} "
                         f"{c['before']} -> {c['after']}")
        timing = []
        if self.trace_ms is not None:
            timing.append(f"trace {self.trace_ms:.1f} ms")
        if self.compile_ms is not None:
            timing.append(f"compile {self.compile_ms:.1f} ms")
        if timing:
            parts.append("    " + ", ".join(timing))
        return "\n".join(parts)


class RecompileLog:
    """Bounded compile-event log + the registry-backed counter."""

    def __init__(self, cap=512):
        # compile events arrive from any thread (a jit cache miss on
        # the training thread can race a serving-engine AOT compile);
        # _seq must stay unique and the counter exact
        self._lock = threading.Lock()
        self._buf = deque(maxlen=int(cap))
        self._sinks = ()            # immutable tuple: lock-free read
        self._seq = 0

    def add_sink(self, fn):
        """Attach ``fn(RecompileEvent)``, called on every record — the
        fleet telemetry spool's tap, so worker-process compile events
        survive the process (fleet-wide warm-boot assertions).  Sinks
        run outside the log lock."""
        with self._lock:
            self._sinks = self._sinks + (fn,)

    def remove_sink(self, fn):
        with self._lock:
            self._sinks = tuple(s for s in self._sinks if s is not fn)

    def record(self, fn, kind, cause, changes, **kw):
        with self._lock:
            self._seq += 1
            ev = RecompileEvent(self._seq, fn, kind, cause, changes,
                                **kw)
            self._buf.append(ev)
        _metrics.registry().counter(
            "obs_recompile_total",
            help="compile events observed (jit cache misses + AOT)").inc()
        for s in self._sinks:
            try:
                s(ev)
            except Exception:
                pass                # a broken spool must not block compiles
        return ev

    def events(self):
        with self._lock:
            return list(self._buf)

    @property
    def count(self):
        return self._seq

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._seq = 0

    def snapshot(self, last=10):
        """Metrics-source view: total count + the most recent events."""
        with self._lock:
            recent = list(self._buf)[-last:]
            count = self._seq
        return {
            "count": count,
            "recent": [e.to_dict() for e in recent],
        }


_LOG = RecompileLog()


def recompile_log():
    """THE process-wide recompile log (module singleton)."""
    return _LOG


# ------------------------------------------------------------ key diff
def _dtype_name(dtype):
    """A dtype as the reference writes it: ``torch.bfloat16`` ->
    ``"bfloat16"``."""
    return str(dtype).replace("torch.", "")


def _leaf_descriptors(key, array_leaf):
    """Per-leaf descriptor list for one jit cache key.

    The key is ``(structure, sig, static, reg_ver)`` where `static`
    holds one entry per flattened leaf (`array_leaf` sentinel at tensor
    positions) and `sig` holds (shape, dtype[, device]) per tensor leaf
    in order."""
    _, sig, static, _ = key
    out, j = [], 0
    for s in static:
        if s is array_leaf:
            out.append(("array", tuple(sig[j])))
            j += 1
        else:
            out.append(("static", s))
    return out


def diff_keys(new_key, old_key, names, array_leaf):
    """Changes between two cache keys with IDENTICAL treedefs.

    `names` is one human-readable name per flattened leaf of the new
    key (same order as the static tuple)."""
    changes = []
    new_d = _leaf_descriptors(new_key, array_leaf)
    old_d = _leaf_descriptors(old_key, array_leaf)
    for i, (nd, od) in enumerate(zip(new_d, old_d)):
        if nd == od:
            continue
        name = names[i] if names and i < len(names) else f"leaf{i}"
        if nd[0] == "array" and od[0] == "array":
            (o_shape, o_dtype), (n_shape, n_dtype) = od[1][:2], nd[1][:2]
            if o_shape != n_shape:
                changes.append({"arg": name, "kind": "shape",
                                "before": list(o_shape),
                                "after": list(n_shape)})
            if o_dtype != n_dtype:
                changes.append({"arg": name, "kind": "dtype",
                                "before": _dtype_name(o_dtype),
                                "after": _dtype_name(n_dtype)})
            if od[1][2:] != nd[1][2:]:
                changes.append({"arg": name, "kind": "device",
                                "before": str(od[1][2]),
                                "after": str(nd[1][2])})
        elif nd[0] != od[0]:
            changes.append({"arg": name, "kind": "traced",
                            "before": od[0], "after": nd[0]})
        else:
            changes.append({"arg": name, "kind": "static",
                            "before": repr(od[1]), "after": repr(nd[1])})
    if new_key[3] != old_key[3]:
        changes.append({"arg": "<state-registry>", "kind": "state",
                        "before": old_key[3], "after": new_key[3]})
    return changes


def _nearest(new_key, prior_keys, array_leaf):
    """The cached key (same treedef) with the fewest differing leaves."""
    new_d = _leaf_descriptors(new_key, array_leaf)

    def distance(k):
        old_d = _leaf_descriptors(k, array_leaf)
        d = sum(1 for a, b in zip(new_d, old_d) if a != b)
        return d + (1 if k[3] != new_key[3] else 0)

    return min(prior_keys, key=distance)


def note_jit_compile(fn_name, key, prior_keys, names, array_leaf,
                     trace_ms=None):
    """Record one StaticFunction cache miss; returns the event so the
    caller can attach the first replay's time afterwards."""
    prior_keys = list(prior_keys)
    if not prior_keys:
        cause, changes = "first compile of this function", []
    else:
        same_tree = [k for k in prior_keys if k[0] == key[0]]
        if not same_tree:
            cause, changes = (
                "new call structure (argument tree changed)", [])
        else:
            changes = diff_keys(key, _nearest(key, same_tree, array_leaf),
                                names, array_leaf)
            if changes:
                kinds = sorted({c["kind"] for c in changes})
                args = ", ".join(dict.fromkeys(c["arg"] for c in changes))
                cause = f"{'/'.join(kinds)} change in {args}"
            else:
                cause = "signature changed (unattributed)"
    return _LOG.record(fn_name, "jit", cause, changes, trace_ms=trace_ms,
                       cache_size=len(prior_keys) + 1)


def note_aot_compile(program, compile_ms=None, cache_size=None,
                     bound=None, engine=None):
    """Record one planned program build of the serving engine."""
    attrs = {}
    if bound is not None:
        attrs["compile_bound"] = bound
    if engine is not None:
        attrs["engine"] = engine
    return _LOG.record(str(program), "serving-aot",
                       "planned AOT compile", [], compile_ms=compile_ms,
                       cache_size=cache_size, attrs=attrs)
