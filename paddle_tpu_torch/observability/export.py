"""Exporters: JSONL dump, Prometheus text + scrape endpoint, Chrome trace
(counterpart of ``paddle_tpu/observability/export.py``, in its formats:
the reference's ``load_jsonl`` and ``tools/obs_report.py`` read a dump
the port wrote).

Render targets for the same in-process state (span ring buffer, metrics
registry, recompile log, roofline reports):

- :func:`dump_jsonl` / :func:`load_jsonl` — one self-describing line
  per record (``{"kind": "span" | "recompile" | "metric" | "roofline" |
  "meta"}``), the interchange format ``tools/obs_report.py`` reads;
- :func:`prometheus_text` — the text exposition format (counters,
  gauges, and reservoir histograms as Prometheus `summary` quantiles)
  a scrape endpoint or node textfile collector can serve as-is;
- :func:`serve_prometheus` — a stdlib ``http.server`` on a daemon
  thread serving :func:`prometheus_text` live (``/metrics``);
  owned and shutdown-able (:class:`PrometheusServer`);
- :func:`chrome_trace` / :func:`write_chrome_trace` — the span buffer
  as Chrome ``traceEvents`` JSON (recompile events appear as instant
  markers on the same timeline), loadable in Perfetto /
  chrome://tracing.
"""
from __future__ import annotations

import http.server
import json
import threading
import time

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import recompile as _recompile
from paddle_tpu_torch.observability import spans as _spans

__all__ = [
    "dump_jsonl", "load_jsonl", "prometheus_text", "chrome_trace",
    "write_chrome_trace", "serve_prometheus", "PrometheusServer",
]


# ------------------------------------------------------------------ JSONL
def dump_jsonl(path, spans=None, recompiles=None, registry=None):
    """Write spans + recompile events + metrics as JSON-lines; returns
    `path`.  Defaults to the process-wide recorder/log/registry. (The
    reference also writes roofline and capacity reports, which the port
    does not make yet; :func:`load_jsonl` reads them.)"""
    spans = _spans.recorder().spans() if spans is None else spans
    recompiles = (_recompile.recompile_log().events()
                  if recompiles is None else recompiles)
    registry = _metrics.registry() if registry is None else registry
    # default=str: span attrs / event attrs are arbitrary user kwargs
    # (ndarrays, dtypes, ...) — one odd attr must not abort the dump
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps({
            "kind": "meta", "version": 1,
            "capture_utc": time.strftime("%Y-%m-%d %H:%M:%S UTC",
                                         time.gmtime()),
        }) + "\n")
        for s in spans:
            fh.write(json.dumps({"kind": "span", **s.to_dict()},
                                default=str) + "\n")
        for e in recompiles:
            # the event dict has its own "kind" (jit | serving-aot), so
            # it nests under "event" instead of colliding with the
            # record discriminator
            fh.write(json.dumps({"kind": "recompile",
                                 "event": e.to_dict()},
                                default=str) + "\n")
        for m in registry.collect():
            rec = {"kind": "metric", "name": m.name, "type": m.kind,
                   "labels": m.labels}
            rec["value"] = (m.summary() if m.kind == "histogram"
                            else m.value)
            fh.write(json.dumps(rec, default=str) + "\n")
    return path


def load_jsonl(path):
    """Parse a :func:`dump_jsonl` file back into plain dict lists:
    ``{"meta": dict|None, "spans": [...], "recompiles": [...],
    "metrics": [...], "rooflines": [...], "capacities": [...]}``."""
    out = {"meta": None, "spans": [], "recompiles": [], "metrics": [],
           "rooflines": [], "capacities": []}
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.pop("kind", None)
            if kind == "meta":
                out["meta"] = rec
            elif kind == "span":
                out["spans"].append(rec)
            elif kind == "recompile":
                # loaded entries match live RecompileEvent.to_dict()
                # shape (their "kind" is jit | serving-aot)
                out["recompiles"].append(rec.get("event", rec))
            elif kind == "metric":
                out["metrics"].append(rec)
            elif kind == "roofline":
                out["rooflines"].append(rec.get("report", rec))
            elif kind == "capacity":
                out["capacities"].append(rec.get("report", rec))
    return out


# ------------------------------------------------------------- Prometheus
def _escape_label(v):
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt_labels(labels, extra=None):
    items = sorted((labels or {}).items())
    if extra:
        items = items + list(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"' for k, v in items) \
        + "}"


def _fmt_value(v):
    if v is None:
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(registry=None):
    """The registry in Prometheus text exposition format.

    Counters keep their registered name (callers choose `_total`
    suffixes), histograms render as `summary` quantiles over the
    bounded reservoir plus exact `_sum` / `_count`."""
    registry = _metrics.registry() if registry is None else registry
    lines = []
    seen_header = set()
    for m in registry.collect():
        if m.name not in seen_header:
            seen_header.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            kind = "summary" if m.kind == "histogram" else m.kind
            lines.append(f"# TYPE {m.name} {kind}")
        if m.kind == "histogram":
            qs = (0.5, 0.9, 0.99)
            for q, v in zip(qs, m.quantiles(qs)):
                lines.append(
                    f"{m.name}{_fmt_labels(m.labels, [('quantile', q)])} "
                    f"{_fmt_value(v)}")
            lines.append(f"{m.name}_sum{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.sum)}")
            lines.append(f"{m.name}_count{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.count)}")
        else:
            lines.append(f"{m.name}{_fmt_labels(m.labels)} "
                         f"{_fmt_value(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


# ----------------------------------------------------------- Chrome trace
def chrome_trace(spans=None, recompiles=None):
    """Span buffer + compile events as a Chrome/Perfetto
    ``traceEvents`` document.

    Recompile events become global instant markers (``ph: "i"``) at
    their monotonic timestamp — the same clock base the span records
    use — so a mid-run retrace is VISIBLE at the step where it
    happened instead of only counted in the log.  Events from an old
    dump that predates ``t_ns`` are skipped (no clock to place them
    on).

    With an explicit `spans` list (a loaded dump), `recompiles`
    defaults EMPTY rather than to the live log — another process's
    perf_counter epoch has no relation to this one's, so mixing them
    would scatter markers at meaningless timestamps."""
    if spans is None:
        spans = _spans.recorder().spans()
        if recompiles is None:
            recompiles = _recompile.recompile_log().events()
    recompiles = recompiles if recompiles is not None else ()
    tids = {}
    events = []
    for s in spans:
        d = s.to_dict() if isinstance(s, _spans.SpanRecord) else dict(s)
        tid = tids.setdefault(d["thread_id"], len(tids))
        ev = {
            "name": d["name"], "ph": "X", "pid": 0, "tid": tid,
            "ts": d["start_ns"] / 1e3,      # us
            "dur": d["dur_ns"] / 1e3,
        }
        args = dict(d.get("attrs") or {})
        if d.get("trace") is not None:
            # distributed-trace identity (fleettrace): clickable in
            # Perfetto's args pane next to the span's own attrs
            args["trace"] = d["trace"]
            args["span"] = d.get("span")
            if d.get("parent") is not None:
                args["parent"] = d["parent"]
        if args:
            ev["args"] = args
        events.append(ev)
    for e in recompiles:
        d = e.to_dict() if isinstance(e, _recompile.RecompileEvent) \
            else dict(e)
        if d.get("t_ns") is None:
            continue
        args = {"cause": d.get("cause", ""), "seq": d.get("seq")}
        for c in d.get("changes", ()) or ():
            args[c.get("arg", "?")] = (f"{c.get('kind')} "
                                       f"{c.get('before')} -> "
                                       f"{c.get('after')}")
        events.append({
            "name": f"recompile {d.get('fn', '?')} [{d.get('kind')}]",
            "ph": "i", "s": "g", "pid": 0, "tid": 0,
            "ts": d["t_ns"] / 1e3,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path, spans=None, recompiles=None):
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(chrome_trace(spans, recompiles), fh, default=str)
    return path


# -------------------------------------------------------- scrape endpoint
class _ScrapeHandler(http.server.BaseHTTPRequestHandler):
    """GET /metrics (or /) -> live Prometheus text exposition."""

    registry = None             # bound by serve_prometheus per server

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path.split("?", 1)[0] not in ("/", "/metrics"):
            self.send_error(404, "scrape at /metrics")
            return
        body = prometheus_text(self.registry).encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, format, *args):  # noqa: A002 — http.server API
        pass                    # scrapes must not spam stderr


class PrometheusServer:
    """Owned handle for one live scrape endpoint.

    The serving thread is a daemon AND joined by :meth:`shutdown`
    (idempotent; also a context manager): the process can always exit,
    and an owner that shuts down gets a fully-stopped server back, not
    a leak."""

    def __init__(self, server, thread):
        self._server = server
        self._thread = thread
        self._closed = False

    @property
    def port(self):
        return self._server.server_address[1]

    @property
    def url(self):
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def shutdown(self, timeout=5.0):
        if self._closed:
            return
        self._closed = True
        self._server.shutdown()
        self._thread.join(timeout)
        self._server.server_close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown()
        return False


def serve_prometheus(port=0, addr="127.0.0.1", registry=None):
    """Serve the live registry at ``http://{addr}:{port}/metrics`` from
    a daemon thread; ``port=0`` picks a free port.  Returns a
    :class:`PrometheusServer` (read ``.port`` / ``.url``, call
    ``.shutdown()``): the engines' TTFT / ITL / queue-depth /
    page-occupancy series, scraped live."""
    handler = type("_BoundScrapeHandler", (_ScrapeHandler,),
                   {"registry": registry})
    server = http.server.ThreadingHTTPServer((addr, int(port)), handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-prometheus-scrape", daemon=True)
    thread.start()
    return PrometheusServer(server, thread)
