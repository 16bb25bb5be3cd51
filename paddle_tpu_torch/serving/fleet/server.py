"""ReplicaServer: the worker-process side of the serving fleet
(counterpart of ``paddle_tpu/serving/fleet/server.py``).

One per replica rank: after the controller's ``boot`` verb it owns a
real :class:`~paddle_tpu_torch.serving.LLMEngine` and serves the
:mod:`.wire` lane in a single-threaded loop, so every engine call runs
on one thread and the engine needs no extra locking.

The engine has no stream callbacks: delivering streamed tokens is the
controller's job (exactly once, from the seq-numbered step responses,
:mod:`.handle`); each step response carries the step's events and the
finished requests' authoritative tokens and finish reasons.

Heartbeats: the worker installs a
:class:`~paddle_tpu_torch.resilience.fleet.HeartbeatPublisher` with
``payload_fn=server.telemetry``, so every beat carries queue depth,
page occupancy and health; a SIGSTOP freezes the publisher thread with
the serve loop, which is what turns a wedged replica into a DEAD
verdict. In-process tests pass ``inline_beats=True`` and the loop beats
between RPCs itself (a parked loop then goes silent).

Chaos hook ``serving.fleet.step`` fires before every engine step:
``rank_kill`` (SIGKILL) and ``wedge`` (SIGSTOP, or a park) are the two
faults of the fleet's proof.

Verbs: ``ping``, ``boot``, ``shutdown``, ``warmup``, ``add``,
``adopt``, ``step``, ``release_waiting``, ``export_handoff``,
``import_handoff``, ``audit``. ``audit`` reports the engine's builds,
bound and cache loads, its steps and forwards, the LayerNorm kernels'
launches (``ops/cuda/norm.LAUNCHES``, process-wide: one engine a
process) and the handoffs' timings.
"""
from __future__ import annotations

import threading
import time

from paddle_tpu_torch.observability import span, use_context
from paddle_tpu_torch.resilience import fleet as _fleet
from paddle_tpu_torch.resilience.faultinject import fire as _fire
from paddle_tpu_torch.serving.fleet import wire

__all__ = ["ReplicaServer"]


def _ms(t0):
    return round((time.perf_counter() - t0) * 1e3, 3)


class ReplicaServer:
    def __init__(self, client, rank, engine_factory, *, config=None,
                 namespace_fn=None, publisher=None, inline_beats=False):
        self._client = client
        self.rank = int(rank)
        self._factory = engine_factory
        self._config = config or _fleet.get_config()
        self._ns = namespace_fn or _fleet.coord_namespace
        self._publisher = publisher
        self._inline_beats = bool(inline_beats)
        self._lock = threading.Lock()   # guards the engine reference
        self._engine = None
        self._stop = threading.Event()
        self.steps = 0
        self.requests_served = 0
        self.handoffs = []              # per-handoff timings (ms, bytes)

    @property
    def engine(self):
        with self._lock:
            return self._engine

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------ telemetry
    def telemetry(self):
        """Heartbeat payload and step-response rider: the admission
        signals the router scores by."""
        e = self.engine
        if e is None:
            return {"health": 0, "queue_depth": 0, "page_occupancy": 0.0,
                    "num_running": 0, "booted": False}
        return {"health": int(e.health.state),
                "queue_depth": int(e.queue_depth),
                "page_occupancy": round(float(e.page_occupancy), 4),
                "num_running": int(e.num_running),
                "booted": True}

    # ------------------------------------------------------ serve loop
    def serve(self):
        """Blocking request loop; returns after ``shutdown`` or
        :meth:`stop`. The lane's seq starts at 0 and the controller
        owns it, so no request is skipped or served twice."""
        seq = 0
        recv_s = max(0.25, self._config.kv_slice_s * 2.0)
        last_beat = 0.0
        while not self._stop.is_set():
            if self._inline_beats and self._publisher is not None:
                now = time.monotonic()
                if now - last_beat >= self._publisher.interval_s:
                    self._publisher.publish_once()
                    last_beat = now
            try:
                method, payload, ctx = wire.read_request(
                    self._client, self._ns(), self.rank, seq, recv_s,
                    config=self._config)
            except _fleet.CollectiveTimeout:
                continue            # an empty window: poll stop / beat
            try:
                # the envelope's trace becomes ambient, so this
                # process's spans join the originating request's trace
                with use_context(ctx):
                    result = self._dispatch(method, payload or {})
            except Exception as e:
                wire.post_response(self._client, self._ns(), self.rank,
                                   seq, error=e)
            else:
                wire.post_response(self._client, self._ns(), self.rank,
                                   seq, result=result)
            self.requests_served += 1
            seq += 1
            if method == "shutdown":
                break

    # ------------------------------------------------------- handlers
    def _dispatch(self, method, p):
        if method == "ping":
            return {"rank": self.rank}
        if method == "boot":
            with span("serving.fleet.boot", rank=self.rank):
                engine = self._factory(p)
            with self._lock:
                self._engine = engine
            return {"ok": True}
        if method == "shutdown":
            self._stop.set()
            e = self.engine
            if e is not None:
                e.shutdown()
            return {"ok": True}
        engine = self.engine
        if engine is None:
            raise RuntimeError(
                f"replica rank {self.rank} has no engine yet: the "
                f"controller must send 'boot' first")
        if method == "warmup":
            return engine.warmup()
        if method == "add":
            return engine.add_request(p["prompt"],
                                      wire.sp_from_dict(p.get("sp")))
        if method == "adopt":
            age_s = p.get("age_s")
            arrive_t = (None if age_s is None
                        else engine.metrics.clock() - float(age_s))
            return engine.adopt_request(
                p["prompt"], wire.sp_from_dict(p.get("sp")),
                generated_token_ids=p.get("generated", ()),
                streamed=p.get("streamed"), arrive_t=arrive_t,
                arrival_index=p.get("arrival_index"))
        if method == "step":
            _fire("serving.fleet.step", rank=self.rank, step=self.steps)
            evs = engine.step()
            self.steps += 1
            finished = []
            while engine.finished_requests:
                rid, req = engine.finished_requests.popitem(last=False)
                finished.append({
                    "rid": rid,
                    "tokens": [int(t) for t in req.output_token_ids],
                    "finish_reason": req.finish_reason})
            return {"events": [[rid, tok, bool(fin)]
                               for rid, tok, fin in evs],
                    "finished": finished,
                    "telemetry": self.telemetry()}
        if method == "release_waiting":
            return [{"rid": r.request_id,
                     "tokens": [int(t) for t in r.output_token_ids]}
                    for r in engine.release_waiting()]
        if method == "export_handoff":
            t0 = time.perf_counter()
            state = engine.export_page_state(
                p["request_id"], release=p.get("release", True))
            export_ms = _ms(t0)
            t0 = time.perf_counter()
            blob = wire.pack_state(state)
            pack_ms = _ms(t0)
            t0 = time.perf_counter()
            _fleet.kv_set_bytes(self._client,
                                wire.handoff_key(self._ns(), p["hid"]), blob)
            set_ms = _ms(t0)
            first = state["layers"][0]
            return {"hid": p["hid"], "bytes": len(blob),
                    "pages": len(first[next(iter(first))]),
                    "tokens": state["len"], "export_ms": export_ms,
                    "pack_ms": pack_ms, "set_ms": set_ms}
        if method == "import_handoff":
            key = wire.handoff_key(self._ns(), p["hid"])
            t0 = time.perf_counter()
            blob = _fleet.kv_get_bytes(
                self._client, key, self._config.collective_timeout_s,
                site="serving.fleet.handoff", config=self._config)
            get_ms = _ms(t0)
            t0 = time.perf_counter()
            state = wire.unpack_state(blob)
            unpack_ms = _ms(t0)
            t0 = time.perf_counter()
            rid = engine.import_page_state(state)
            import_ms = _ms(t0)
            # consume the blob only after a successful import: a
            # rejected import must stay retryable
            try:
                self._client.key_value_delete(key)
            except Exception:
                pass
            self.handoffs.append({"hid": p["hid"], "bytes": len(blob),
                                  "tokens": state["len"],
                                  "get_ms": get_ms, "unpack_ms": unpack_ms,
                                  "import_ms": import_ms})
            return rid
        if method == "audit":
            from paddle_tpu_torch.ops.cuda import norm
            m = engine.metrics
            # a captured program ran its warm-up calls and one boot
            # replay (no forward on the CPU, where nothing is captured)
            boot = sum(getattr(prog, "warmups", -1) + 1
                       for key, prog in engine._programs.items()
                       if key[0] != "sample")
            return {"compiled": int(m.compile_count),
                    "bound": int(m.compile_bound),
                    "cache_loads": int(m.aot_cache_loads),
                    "steps": self.steps,
                    "prefill_steps": int(m.prefill_steps),
                    "decode_steps": int(m.decode_steps),
                    "boot_forwards": boot,
                    "generated_tokens": int(m.generated_tokens),
                    "ln_launches": {k: int(norm.LAUNCHES[k]) for k in
                                    ("ln_fwd", "ln_res_fwd")},
                    "handoffs": list(self.handoffs)}
        raise ValueError(f"unknown serving-fleet RPC method {method!r}")
