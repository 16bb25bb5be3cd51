"""paddle_tpu_torch.observability: runtime telemetry of the port
(counterpart of ``paddle_tpu.observability``).

- :mod:`spans`: nested trace spans (``with span("train_step"): ...``)
  recorded into a bounded ring buffer, and into a torch profiler's
  trace while one runs; :class:`TraceContext` / :class:`use_context`
  carry a request's trace identity;
- :mod:`metrics`: ONE process-wide registry of Counter / Gauge /
  Histogram, which the serving engine's metrics live in;
- :mod:`recompile`: the build-event log: every ``StaticFunction`` cache
  miss and every serving program build records WHY it built (which
  argument's shape / dtype / static leaf changed) and how long it took;
- :mod:`export`: JSONL, Prometheus text exposition (plus a live scrape
  endpoint, :func:`export.serve_prometheus`), and Chrome-trace
  exporters, in the reference's formats;
- :mod:`fleettrace`: per-process telemetry spools, their merge into
  one Chrome trace and per-request timelines, and the flight recorder;
- :mod:`profile`: the roofline profiler: layer scopes threaded through
  every module call, and one eager call of a program walked into
  per-layer flops and bytes against the card's roofline.

Not ported yet: the spools' cross-process clock handshake (ROADMAP A.4).

Quickstart::

    from paddle_tpu_torch import observability as obs

    with obs.span("train_step", step=i):
        loss = train_step(x, y)

    obs.recompile_log().events()       # why did anything build again?
    obs.registry().snapshot()          # every counter/gauge/histogram
    obs.export.dump_jsonl("obs.jsonl")
"""
from paddle_tpu_torch.observability import export, fleettrace, profile
from paddle_tpu_torch.observability.metrics import (Counter, Gauge, Histogram,
                                                    MetricsRegistry,
                                                    next_instance_label,
                                                    registry)
from paddle_tpu_torch.observability.recompile import (RecompileEvent,
                                                      RecompileLog,
                                                      note_aot_compile,
                                                      note_jit_compile,
                                                      recompile_log)
from paddle_tpu_torch.observability.spans import (SpanRecord, SpanRecorder,
                                                  TraceContext,
                                                  current_context, enabled,
                                                  recorder, set_enabled,
                                                  span, use_context)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RecompileEvent",
    "RecompileLog",
    "SpanRecord",
    "SpanRecorder",
    "TraceContext",
    "current_context",
    "enabled",
    "export",
    "fleettrace",
    "next_instance_label",
    "note_aot_compile",
    "note_jit_compile",
    "profile",
    "recompile_log",
    "recorder",
    "registry",
    "set_enabled",
    "span",
    "use_context",
]

# built-in metrics sources: the span aggregates and the recompile log
# surface in every registry report without extra wiring
registry().register_source(
    "spans", lambda: {"dropped": recorder().dropped,
                      "buffered": len(recorder().spans()),
                      "by_name": recorder().aggregates()},
    builtin=True)
registry().register_source(
    "recompile", lambda: recompile_log().snapshot(), builtin=True)
