"""Telemetry spools, their aggregation and the crash flight recorder
(counterpart of ``paddle_tpu/observability/fleettrace.py``).

The per-process observability plane (spans ring, metrics registry,
recompile log) dies with its process. This module makes it durable:

- :class:`TelemetrySpool`: an append-mode, per-line-flushed JSONL file
  per process under ``PTPU_OBS_SPOOL_DIR`` (a crash loses at most the
  line in flight, and readers skip torn tails). Arming taps the span
  recorder and the recompile log through their sinks and snapshots the
  metrics registry periodically, so spans, compile events and metric
  snapshots stream to disk as they happen.
- **Clock-offset handshake**: each rank publishes a simultaneous
  ``(perf_counter_ns, wall_ns)`` anchor pair through the fleet's
  coordination store at arm time and reads the reference rank's
  (:func:`clock_handshake`), recording the offset that maps its
  ``perf_counter`` onto the reference rank's timeline;
  :func:`merge_spools` aligns every process by it.
- :func:`merge_spools`: every spool of a directory in one
  :class:`FleetTelemetry`: a Chrome trace with one track per process, a
  rank-labeled merged metrics exposition, and per-request timelines
  that decompose TTFT into queue-wait / prefill / decode stages.
- :func:`flight_record`: a process's last N spans, last metric
  snapshot, and in-flight request ids, recovered from its spool.

The spool format is the reference's, so its ``merge_spools`` reads the
port's spools. Disarm contract: ``set_enabled(False)`` stops every
spool write, and ``PTPU_OBS_SPOOL=0`` / ``false`` / ``off`` / ``no``
make :func:`arm_from_env` a no-op.
"""
from __future__ import annotations

import json
import os
import threading
import time

from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.observability import recompile as _recompile
from paddle_tpu_torch.observability import spans as _spans

__all__ = [
    "TelemetrySpool", "FleetTelemetry", "ProcessSpool",
    "arm_spool", "arm_from_env", "disarm", "active_spool",
    "clock_handshake", "merge_spools", "read_spool",
    "request_timeline", "flight_record",
    "SPOOL_ENV", "SUPPRESS_ENV", "SUPPRESS_SPELLINGS",
]

SPOOL_ENV = "PTPU_OBS_SPOOL_DIR"
SUPPRESS_ENV = "PTPU_OBS_SPOOL"
METRICS_INTERVAL_ENV = "PTPU_OBS_SPOOL_METRICS_S"
# the spellings that all read as "off" — tested in the flagged/clean
# disarm pair so a deployment's chosen spelling actually disarms
SUPPRESS_SPELLINGS = ("0", "false", "off", "no")
CLOCK_SITE = "obs.clock"

# span names that start / finish a request on an engine — the
# flight recorder's in-flight bookkeeping
_REQ_START_SPANS = ("serving.prefill", "serving.adopt",
                    "serving.page_import")
_REQ_FINISH_SPANS = ("serving.finish",)

_active = [None]                # list, not var: mutation without `global`


def active_spool():
    """The process's armed :class:`TelemetrySpool` (or None)."""
    return _active[0]


def _clock_key(namespace, rank):
    return f"{namespace}/obs/clock/r{int(rank)}"


class TelemetrySpool:
    """One process's durable telemetry stream: append-mode JSONL,
    flushed per line (kill-safe — a SIGKILL loses at most the line in
    flight).  Event kinds: ``meta`` (first line), ``clock`` (anchor /
    handshake), ``span``, ``recompile``, ``metrics``."""

    def __init__(self, spool_dir, rank=None, tag=""):
        os.makedirs(spool_dir, exist_ok=True)
        self.rank = None if rank is None else int(rank)
        self.pid = os.getpid()
        r = "x" if self.rank is None else str(self.rank)
        suffix = f"-{tag}" if tag else ""
        self.path = os.path.join(
            spool_dir, f"spool-r{r}-p{self.pid}{suffix}.jsonl")
        self._fh = open(self.path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self.events_written = 0
        self.bytes_written = 0
        self._write({"kind": "meta", "version": 1, "rank": self.rank,
                     "pid": self.pid, "wall_time": time.time()})

    def _write(self, ev):
        # hot path (every span): compact separators, no key sorting —
        # the encode happens outside the lock, only write+flush inside
        line = json.dumps(ev, separators=(",", ":"), default=str)
        with self._lock:
            try:
                self._fh.write(line + "\n")
                self._fh.flush()
            except ValueError:      # closed mid-disarm race: drop
                return
            self.events_written += 1
            self.bytes_written += len(line) + 1

    # ------------------------------------------------------- taps
    # every tap is gated on the span-recording flag: set_enabled(False)
    # must fully disarm spooling, not just the span stream
    def note_span(self, rec):
        """SpanRecorder sink: one closed span."""
        if not _spans.enabled():
            return
        ev = rec.to_dict()
        ev["kind"] = "span"
        self._write(ev)

    def note_recompile(self, ev):
        """RecompileLog sink: one compile event."""
        if not _spans.enabled():
            return
        self._write({"kind": "recompile", "event": ev.to_dict()})

    def snapshot_metrics(self, registry=None):
        """Append one full metrics-registry snapshot (the merged
        rank-labeled exposition reads each spool's LAST snapshot)."""
        if not _spans.enabled():
            return
        reg = registry if registry is not None else _metrics.registry()
        self._write({"kind": "metrics", "t_ns": time.perf_counter_ns(),
                     "wall_time": time.time(),
                     "metrics": reg.snapshot()})

    def note_clock(self, clock_ev):
        self._write(dict(clock_ev, kind="clock"))

    def close(self):
        try:
            self._fh.close()
        except Exception:
            pass


class _MetricsPump(threading.Thread):
    """Daemon thread appending periodic metric snapshots to the spool
    — SIGKILL-compatible by construction (each snapshot is already on
    disk when the next interval starts)."""

    def __init__(self, spool, interval_s):
        super().__init__(name="obs-spool-metrics", daemon=True)
        self._spool = spool
        self._interval = float(interval_s)
        self._stop = threading.Event()

    def run(self):
        while not self._stop.wait(self._interval):
            try:
                self._spool.snapshot_metrics()
            except Exception:
                pass

    def stop(self):
        self._stop.set()


# -------------------------------------------------- clock handshake
def clock_handshake(client, rank, *, namespace=None, ref_rank=0,
                    timeout_s=10.0, config=None):
    """Coordination-KV clock-offset handshake: publish this process's
    simultaneous ``(perf_counter_ns, wall_ns)`` anchor under the fleet
    namespace, read the reference rank's, and return a clock event whose
    ``offset_ns`` maps this process's ``perf_counter`` readings onto the
    reference rank's timeline (``t_ref = t_local + offset_ns``). Wall
    clocks bridge the unrelated ``perf_counter`` epochs (exact on one
    host); ``rtt_ms`` is the read's round trip. A missing reference
    anchor leaves the event anchor-only, and :func:`merge_spools` aligns
    it by wall clock."""
    from paddle_tpu_torch.resilience import fleet as _fleet
    ns = namespace if namespace is not None else _fleet.coord_namespace()
    rank = int(rank)
    anchor_perf = time.perf_counter_ns()
    anchor_wall = time.time_ns()
    ev = {"rank": rank, "ref_rank": int(ref_rank),
          "anchor_perf_ns": anchor_perf, "anchor_wall_ns": anchor_wall,
          "offset_ns": None, "rtt_ms": None}
    _fleet.kv_set_bytes(client, _clock_key(ns, rank),
                        json.dumps(ev, sort_keys=True).encode())
    if rank == int(ref_rank):
        ev["offset_ns"] = 0
        ev["rtt_ms"] = 0.0
        return ev
    t0 = time.perf_counter()
    try:
        raw = _fleet.kv_get_bytes(
            client, _clock_key(ns, ref_rank), timeout_s,
            site=CLOCK_SITE, missing_rank=int(ref_rank), config=config)
        ref = json.loads(bytes(raw).decode())
    except Exception:
        return ev                   # anchor-only: merge aligns by wall
    rtt_ms = (time.perf_counter() - t0) * 1e3
    ev["offset_ns"] = ((anchor_wall - ref["anchor_wall_ns"])
                       + (ref["anchor_perf_ns"] - anchor_perf))
    ev["rtt_ms"] = round(rtt_ms, 3)
    return ev


# ------------------------------------------------------------ arming
def arm_spool(spool_dir, rank=None, *, tag="", client=None,
              namespace=None, ref_rank=0, metrics_interval_s=None,
              handshake_timeout_s=10.0, config=None):
    """Arm continuous spooling for this process: open the spool, record
    the clock anchor (the KV handshake when ``client`` and ``rank`` are
    given), tap the span recorder and recompile log, and start the
    periodic metrics pump when ``metrics_interval_s`` is set. Re-arming
    while armed returns the existing spool."""
    if _active[0] is not None:
        return _active[0]
    spool = TelemetrySpool(spool_dir, rank=rank, tag=tag)
    if client is not None and rank is not None:
        ev = clock_handshake(client, rank, namespace=namespace,
                             ref_rank=ref_rank,
                             timeout_s=handshake_timeout_s, config=config)
    else:
        # solo anchor: merge_spools aligns by wall clock if this spool
        # ever meets others
        ev = {"rank": spool.rank, "ref_rank": None,
              "anchor_perf_ns": time.perf_counter_ns(),
              "anchor_wall_ns": time.time_ns(),
              "offset_ns": None, "rtt_ms": None}
    spool.note_clock(ev)
    _spans.recorder().add_sink(spool.note_span)
    _recompile.recompile_log().add_sink(spool.note_recompile)
    spool._pump = None
    if metrics_interval_s:
        spool._pump = _MetricsPump(spool, metrics_interval_s)
        spool._pump.start()
    _active[0] = spool
    return spool


def arm_from_env(rank=None, client=None, **kw):
    """Worker-process arming: when
    ``PTPU_OBS_SPOOL_DIR`` is set — and no suppression spelling
    (``PTPU_OBS_SPOOL=0/false/off/no``) vetoes it — arm spooling into
    that directory.  No-op (returns None) otherwise, so entry points
    call this unconditionally."""
    if os.environ.get(SUPPRESS_ENV, "").strip().lower() \
            in SUPPRESS_SPELLINGS:
        return None
    spool_dir = os.environ.get(SPOOL_ENV)
    if not spool_dir:
        return None
    interval = kw.pop("metrics_interval_s", None)
    if interval is None:
        interval = float(os.environ.get(METRICS_INTERVAL_ENV, "0.5"))
    return arm_spool(spool_dir, rank=rank, client=client,
                     metrics_interval_s=interval, **kw)


def disarm(final_snapshot=True):
    """Detach the taps, stop the pump, append one final metrics
    snapshot, and close the spool (no-op when not armed)."""
    spool = _active[0]
    if spool is None:
        return None
    _spans.recorder().remove_sink(spool.note_span)
    _recompile.recompile_log().remove_sink(spool.note_recompile)
    pump = getattr(spool, "_pump", None)
    if pump is not None:
        pump.stop()
    if final_snapshot:
        try:
            spool.snapshot_metrics()
        except Exception:
            pass
    spool.close()
    _active[0] = None
    return spool


# ----------------------------------------------------------- reading
def read_spool(path):
    """Parse one spool file, skipping torn lines (the SIGKILL tail):
    returns ``{"meta", "clock", "spans", "recompiles", "metrics",
    "torn_lines"}``."""
    out = {"meta": None, "clock": None, "spans": [], "recompiles": [],
           "metrics": [], "torn_lines": 0}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                out["torn_lines"] += 1
                continue
            kind = ev.get("kind")
            if kind == "meta" and out["meta"] is None:
                out["meta"] = ev
            elif kind == "clock" and out["clock"] is None:
                out["clock"] = ev
            elif kind == "span":
                out["spans"].append(ev)
            elif kind == "recompile":
                out["recompiles"].append(ev)
            elif kind == "metrics":
                out["metrics"].append(ev)
    return out


class ProcessSpool:
    """One process's parsed spool + its clock offset onto the merged
    (reference-rank) timeline."""

    __slots__ = ("path", "rank", "pid", "meta", "clock", "spans",
                 "recompiles", "metrics", "torn_lines", "offset_ns")

    def __init__(self, path, parsed):
        self.path = path
        self.meta = parsed["meta"] or {}
        self.clock = parsed["clock"]
        self.spans = parsed["spans"]
        self.recompiles = parsed["recompiles"]
        self.metrics = parsed["metrics"]
        self.torn_lines = parsed["torn_lines"]
        self.rank = self.meta.get("rank")
        self.pid = self.meta.get("pid")
        self.offset_ns = 0

    @property
    def label(self):
        r = "?" if self.rank is None else self.rank
        return f"rank {r} (pid {self.pid})"


def _align(processes):
    """Compute each process's ``offset_ns`` onto the reference
    timeline: the recorded handshake offset when present, else the
    wall-anchor bridge against the reference process's anchor."""
    ref = None
    for p in processes:             # prefer the handshake's ref rank
        c = p.clock or {}
        if c.get("offset_ns") == 0 or (c.get("ref_rank") is not None
                                       and p.rank == c.get("ref_rank")):
            ref = p
            break
    if ref is None and processes:
        ref = min(processes,
                  key=lambda p: (p.rank is None, p.rank or 0, p.pid or 0))
    for p in processes:
        c = p.clock or {}
        if p is ref:
            p.offset_ns = 0
        elif c.get("offset_ns") is not None:
            p.offset_ns = int(c["offset_ns"])
        elif (c.get("anchor_perf_ns") is not None and ref is not None
              and (ref.clock or {}).get("anchor_perf_ns") is not None):
            rc = ref.clock
            p.offset_ns = ((c["anchor_wall_ns"] - rc["anchor_wall_ns"])
                           + (rc["anchor_perf_ns"] - c["anchor_perf_ns"]))
        else:
            p.offset_ns = 0
    return ref


class FleetTelemetry:
    """Every rank spool in one merged, clock-aligned view."""

    def __init__(self, processes):
        self.processes = sorted(
            processes,
            key=lambda p: (p.rank is None, p.rank or 0, p.pid or 0))
        self.ref = _align(self.processes)

    # ------------------------------------------------------ summary
    def summary(self):
        skews = [p.clock.get("rtt_ms") for p in self.processes
                 if p.clock and p.clock.get("rtt_ms")]
        return {
            "processes": len(self.processes),
            "ranks": [p.rank for p in self.processes],
            "spans": sum(len(p.spans) for p in self.processes),
            "recompiles": sum(len(p.recompiles)
                              for p in self.processes),
            "metric_snapshots": sum(len(p.metrics)
                                    for p in self.processes),
            "torn_lines": sum(p.torn_lines for p in self.processes),
            "traces": len(self.traces()),
            "ref_rank": None if self.ref is None else self.ref.rank,
            "clock_skew_ms": round(max(skews) / 2.0, 3) if skews
            else 0.0,
        }

    # ------------------------------------------------- chrome trace
    def chrome_trace(self):
        """One Chrome ``traceEvents`` dict: one pid track per process
        (aligned clocks), spans as ``ph:"X"``, compile events as
        instant markers."""
        ranks = [p.rank for p in self.processes]
        unique = (None not in ranks and len(set(ranks)) == len(ranks))
        events = []
        for i, p in enumerate(self.processes):
            pid = p.rank if unique else (p.pid or i)
            events.append({"name": "process_name", "ph": "M",
                           "pid": pid, "tid": 0,
                           "args": {"name": p.label}})
            for s in p.spans:
                ev = {"name": s["name"], "cat": "span", "ph": "X",
                      "pid": pid, "tid": s.get("thread_id", 0),
                      "ts": round((s["start_ns"] + p.offset_ns) / 1e3,
                                  3),
                      "dur": round(s["dur_ns"] / 1e3, 3)}
                args = dict(s.get("attrs") or {})
                if "trace" in s:
                    args["trace"] = s["trace"]
                    args["span"] = s.get("span")
                    if s.get("parent") is not None:
                        args["parent"] = s["parent"]
                if args:
                    ev["args"] = args
                events.append(ev)
            for r in p.recompiles:
                e = r.get("event", {})
                if e.get("t_ns") is None:
                    continue
                events.append({
                    "name": f"recompile:{e.get('fn')}",
                    "cat": "recompile", "ph": "i", "s": "g",
                    "pid": pid, "tid": 0,
                    "ts": round((e["t_ns"] + p.offset_ns) / 1e3, 3),
                    "args": {"kind": e.get("kind"),
                             "cause": e.get("cause")}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path):
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_trace(), fh)
        return path

    # ---------------------------------------------- merged metrics
    def merged_metrics(self):
        """{rank: last metrics snapshot} across the fleet."""
        out = {}
        for p in self.processes:
            if p.metrics:
                key = "?" if p.rank is None else p.rank
                out[key] = p.metrics[-1]["metrics"]
        return out

    def prometheus_text(self):
        """Rank-labeled merged exposition: scalars as-is, histogram
        summaries flattened to ``_count`` / ``_p50_ms`` / ``_p99_ms``
        (summary exposition, not full buckets — the per-process scrape
        endpoint remains the high-fidelity path)."""
        lines = []
        for rank, snap in sorted(self.merged_metrics().items(),
                                 key=lambda kv: str(kv[0])):
            for key in sorted(snap):
                val = snap[key]
                name, brace, rest = key.partition("{")
                labels = f'rank="{rank}"'
                if brace:
                    inner = rest[:-1]
                    inner = ",".join(
                        f'{kv.split("=", 1)[0]}="{kv.split("=", 1)[1]}"'
                        for kv in inner.split(",") if "=" in kv)
                    labels = f"{inner},{labels}" if inner else labels
                if isinstance(val, dict):    # histogram summary
                    for k, suffix in (("count", "_count"),
                                      ("p50", "_p50_ms"),
                                      ("p99", "_p99_ms")):
                        v = val.get(k)
                        if v is not None:
                            lines.append(
                                f"{name}{suffix}{{{labels}}} {v}")
                elif isinstance(val, (int, float)):
                    lines.append(f"{name}{{{labels}}} {val}")
        return "\n".join(lines) + "\n"

    # -------------------------------------------- recompile ledger
    def recompiles_by_rank(self):
        """{rank: [recompile event dicts]} — the fleet-wide warm-boot
        zero-recompile assertion reads this (satellite: worker-process
        compile events used to vanish with the process)."""
        out = {}
        for p in self.processes:
            key = "?" if p.rank is None else p.rank
            out.setdefault(key, []).extend(
                r.get("event", {}) for r in p.recompiles)
        return out

    # ----------------------------------------------------- traces
    def _spans_with_process(self):
        for p in self.processes:
            for s in p.spans:
                yield p, s

    def traces(self):
        """{trace_id: [(process, span_dict), ...]} for every traced
        span, each list sorted by aligned start time."""
        out = {}
        for p, s in self._spans_with_process():
            t = s.get("trace")
            if t is not None:
                out.setdefault(t, []).append((p, s))
        for lst in out.values():
            lst.sort(key=lambda ps: ps[1]["start_ns"] + ps[0].offset_ns)
        return out

    def find_trace(self, request_or_trace):
        """Resolve a trace id, router rid (``rr-N``), or engine rid
        (``req-N``) to its trace id (None when unknown)."""
        want = str(request_or_trace)
        traces = self.traces()
        if want in traces:
            return want
        for tid, lst in sorted(traces.items()):
            for _p, s in lst:
                if str((s.get("attrs") or {}).get("request")) == want:
                    return tid
        return None

    def timeline(self, request_or_trace):
        """Per-request end-to-end timeline: the trace's spans across
        every process on the aligned clock, plus the TTFT stage
        decomposition (the router, adoption and handoff stages appear
        only in spools of processes that have those spans)."""
        tid = self.find_trace(request_or_trace)
        if tid is None:
            return None
        entries = []
        for p, s in self.traces()[tid]:
            entries.append({
                "name": s["name"], "rank": p.rank, "pid": p.pid,
                "start_ns": s["start_ns"] + p.offset_ns,
                "dur_ns": s["dur_ns"],
                "span": s.get("span"), "parent": s.get("parent"),
                "attrs": s.get("attrs") or {}})

        def named(*names):
            return [e for e in entries if e["name"] in names]

        admits = named("serving.router.admit")
        prefills = named("serving.prefill")
        adopts = named("serving.adopt")
        handoffs = named("serving.page_export", "serving.page_import")
        finishes = named("serving.finish")
        stages = {}
        if admits and prefills:
            stages["queue_wait_s"] = max(
                0.0, (prefills[0]["start_ns"] - admits[0]["start_ns"])
                / 1e9)
        if prefills:
            stages["prefill_s"] = sum(e["dur_ns"]
                                      for e in prefills) / 1e9
        if handoffs:
            stages["handoff_s"] = sum(e["dur_ns"]
                                      for e in handoffs) / 1e9
        if adopts:
            stages["adoption_s"] = sum(e["dur_ns"]
                                       for e in adopts) / 1e9
        if finishes and prefills:
            last_work = max(e["start_ns"] + e["dur_ns"]
                            for e in prefills + adopts + handoffs)
            stages["decode_s"] = max(
                0.0, (finishes[0]["start_ns"] - last_work) / 1e9)
        if admits and finishes:
            stages["total_s"] = max(
                0.0, (finishes[0]["start_ns"] + finishes[0]["dur_ns"]
                      - admits[0]["start_ns"]) / 1e9)
        # the ROUTER rid names the request fleet-wide; engine rids
        # (req-N, one per hosting engine) are the fallback
        request = None
        for e in admits or (prefills + finishes):
            request = request or e["attrs"].get("request")
        return {
            "trace": tid,
            "request": request,
            "complete": bool(admits) and bool(finishes),
            "admissions": len(admits),
            "finishes": len(finishes),
            "migrations": len(adopts),
            "handoffs": len(handoffs),
            "processes": sorted({e["rank"] for e in entries
                                 if e["rank"] is not None}),
            "stages": stages,
            "spans": entries,
        }

    # ---------------------------------------------- flight recorder
    def flight_record(self, rank, last_n=50):
        """Post-mortem for `rank` from its spool: last `last_n` spans,
        last metric snapshot, and the request ids in flight on that
        engine at death (started by prefill/adopt/import, no finish
        span)."""
        procs = [p for p in self.processes if p.rank == int(rank)]
        if not procs:
            return None
        p = max(procs,
                key=lambda q: (q.meta or {}).get("wall_time", 0.0))
        started, finished = {}, set()
        for s in p.spans:
            rid = (s.get("attrs") or {}).get("request")
            if rid is None:
                continue
            if s["name"] in _REQ_START_SPANS:
                started[str(rid)] = s.get("trace")
            elif s["name"] in _REQ_FINISH_SPANS:
                finished.add(str(rid))
        in_flight = sorted(r for r in started if r not in finished)
        return {
            "rank": p.rank,
            "pid": p.pid,
            "spool": p.path,
            "torn_lines": p.torn_lines,
            "spans_total": len(p.spans),
            "last_spans": [dict(s) for s in p.spans[-int(last_n):]],
            "last_metrics": (p.metrics[-1]["metrics"] if p.metrics
                             else None),
            "in_flight_requests": in_flight,
            "in_flight_traces": {r: started[r] for r in in_flight},
            "recompiles": len(p.recompiles),
        }


def merge_spools(spool_dir):
    """Load every ``spool-*.jsonl`` under `spool_dir` (torn SIGKILL
    tails skipped) into one :class:`FleetTelemetry`."""
    procs = []
    for name in sorted(os.listdir(spool_dir)):
        if not (name.startswith("spool-") and name.endswith(".jsonl")):
            continue
        path = os.path.join(spool_dir, name)
        procs.append(ProcessSpool(path, read_spool(path)))
    return FleetTelemetry(procs)


def request_timeline(spool_dir, request_or_trace):
    """Convenience: :func:`merge_spools` + :meth:`timeline`."""
    return merge_spools(spool_dir).timeline(request_or_trace)


def flight_record(spool_dir, rank, last_n=50, write=True):
    """The controller's DEAD-verdict hook: build rank's post-mortem
    from its spool and (with `write`) persist it as
    ``postmortem-r<rank>.json`` next to the spools."""
    report = merge_spools(spool_dir).flight_record(rank, last_n=last_n)
    if report is not None and write:
        path = os.path.join(spool_dir, f"postmortem-r{int(rank)}.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=1, sort_keys=True,
                      default=str)
        report["path"] = path
    return report
