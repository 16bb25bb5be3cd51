"""RemoteEngineClient: a process-replica handle with the engine surface
the port's Router drives (counterpart of
``paddle_tpu/serving/fleet/handle.py``).

The router (``serving/router/router.py``, through its
``engine_factory``) never learns its engine is remote: this proxy has
the slice of the engine API the router uses (``add_request``,
``adopt_request``, ``step``, ``has_unfinished``, ``release_waiting``,
``finished_requests``, ``warmup``, ``shutdown`` and the telemetry
properties ``health``, ``queue_depth``, ``page_occupancy``,
``num_running``) and forwards each over the :mod:`.wire` lane to a
:class:`~paddle_tpu_torch.serving.fleet.server.ReplicaServer` in another
process, so the router's lifecycle, spillover, failover and respawn
work unchanged across the process boundary.

Exactly-once streams: the replica's engine has no stream callbacks;
tokens are delivered here only, from the seq-numbered step response
(each consumed once), so a token is delivered from the one response
that carried it or, if the replica died first, never, and is then
regenerated by the adoption replay on the next replica.

Failure: a crashed (SIGKILL) or wedged (SIGSTOP) replica misses its
response; the watchdog's DEAD verdict aborts the wait with a
``CollectiveTimeout``, which :meth:`step` lets fly into the router's
failover. ``last_timeout`` and ``detect_s`` keep the last one.

Clocks: ``adopt_request``'s ``arrive_t`` is the router's clock reading,
meaningless elsewhere, so the proxy ships ``age_s = now - arrive_t`` and
the server re-anchors it on its engine's clock: a ``deadline_s`` keeps
counting from the first arrival.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

from paddle_tpu_torch.serving.fleet import wire

__all__ = ["RemoteEngineClient", "FinishedRemote"]


class _HealthShim:
    """`ReplicaHandle.telemetry()` reads ``int(engine.health.state)``;
    this carries the replica-reported health int across the wire."""

    def __init__(self, state=0):
        self.state = int(state)


class FinishedRemote:
    """Controller-side stand-in for a finished Request — the two
    fields the router's close-out path reads, mirrored from the step
    response's authoritative finished table."""

    __slots__ = ("request_id", "output_token_ids", "finish_reason")

    def __init__(self, request_id, output_token_ids, finish_reason):
        self.request_id = request_id
        self.output_token_ids = [int(t) for t in output_token_ids]
        self.finish_reason = finish_reason


class RemoteEngineClient:
    """One controller-side handle per replica worker process.

    Thread-safety: the router already serializes every engine call
    under its own RLock, but the proxy keeps its mirrors under a
    private lock anyway — telemetry refreshes may arrive from the
    fleet-monitor thread via :meth:`note_telemetry` while the router
    thread steps.  Stream callbacks fire OUTSIDE the proxy lock.
    """

    def __init__(self, client, rank, *, namespace_fn, config,
                 abort_if=None, clock=time.perf_counter,
                 metrics_name=None, hold_verdict=None,
                 release_verdict=None):
        self._client = client
        self.rank = int(rank)
        self._ns = namespace_fn
        self._config = config
        self._abort_if = abort_if
        # boot-phase verdict guards (the controller wires these to the
        # fleet monitor): warmup compiles/cache-loads silence the
        # replica's inline beats, and a spurious DEAD verdict there is
        # terminal — see FleetMonitor.hold_verdict
        self._hold_verdict = hold_verdict or (lambda for_s: None)
        self._release_verdict = release_verdict or (lambda: None)
        self._clock = clock
        self._metrics_name = metrics_name or f"serving.remote.r{rank}"
        self._lock = threading.Lock()
        self._seq = 0
        self._streams = {}          # erid -> stream callable
        self._unfinished = set()    # erid mirror
        self.finished_requests = OrderedDict()
        self._telemetry = {"health": 0, "queue_depth": 0,
                           "page_occupancy": 0.0, "num_running": 0}
        self.adopted = []           # (prompt, tokens it brought)
        self.last_timeout = None    # CollectiveTimeout.to_dict()
        self.detect_s = None        # verdict latency of the LAST step
        self._dead = False

    # ------------------------------------------------------------ RPC
    def call(self, method, payload=None, timeout_s=None):
        """One ordered RPC round trip (public: the controller uses it
        for boot/handoff/audit verbs the router never sees)."""
        with self._lock:
            seq = self._seq
            self._seq += 1
        ns = self._ns()
        wire.post_request(self._client, ns, self.rank, seq, method,
                          payload)
        t0 = time.monotonic()
        try:
            return wire.await_response(
                self._client, ns, self.rank, seq,
                timeout_s if timeout_s is not None
                else self._config.collective_timeout_s,
                abort_if=self._abort_if, config=self._config)
        except Exception as e:
            to_dict = getattr(e, "to_dict", None)
            if to_dict is not None:
                with self._lock:
                    self.last_timeout = to_dict()
                    self.detect_s = time.monotonic() - t0
                    self._dead = True
            # reap the abandoned request: the
            # controller is about to fail this stream over, but a
            # merely-wedged (SIGSTOP) replica that resumes would still
            # read the request and serve it a second time elsewhere —
            # delete-on-abandon keeps the lane exactly-once.  Best
            # effort: if the replica already consumed it, the delete
            # is a no-op; if the coordinator itself is gone, the
            # namespace reap is the backstop.
            try:
                self._client.key_value_delete(
                    wire.req_key(ns, self.rank, seq))
            except Exception:
                pass
            raise

    # -------------------------------------------- router engine surface
    def _call_admission(self, method, payload):
        """Admission verbs (add/adopt) against a replica that dies
        MID-CALL must read as a refusal — the router then spills to
        the next candidate (the request is still the caller's) instead
        of the whole admission path crashing on one dead target."""
        from paddle_tpu_torch.serving.scheduler import AdmissionRejected
        try:
            return self.call(method, payload)
        except Exception as e:
            if getattr(e, "to_dict", None) is None:
                raise               # typed remote errors pass through
            raise AdmissionRejected(
                "replica_dead",
                f"rank {self.rank} unresponsive during {method} "
                f"({getattr(e, 'verdict', '?')})") from e

    def add_request(self, prompt_token_ids, sampling_params=None,
                    stream=None):
        erid = self._call_admission("add", {
            "prompt": [int(t) for t in prompt_token_ids],
            "sp": wire.sp_to_dict(sampling_params)})
        with self._lock:
            if stream is not None:
                self._streams[erid] = stream
            self._unfinished.add(erid)
            # optimistic bump: an admission BURST lands before the next
            # step/heartbeat telemetry does — without it every score
            # ties at the stale reading and the burst piles onto one
            # replica (the next real telemetry overwrites this)
            self._telemetry["queue_depth"] = (
                int(self._telemetry.get("queue_depth", 0)) + 1)
        return erid

    def adopt_request(self, prompt_token_ids, sampling_params=None,
                      generated_token_ids=(), stream=None,
                      streamed=None, arrive_t=None, arrival_index=None):
        generated = [int(t) for t in generated_token_ids]
        self.adopted.append(([int(t) for t in prompt_token_ids],
                             len(generated)))
        age_s = (max(0.0, self._clock() - float(arrive_t))
                 if arrive_t is not None else None)
        erid = self._call_admission("adopt", {
            "prompt": [int(t) for t in prompt_token_ids],
            "sp": wire.sp_to_dict(sampling_params),
            "generated": generated,
            "streamed": (len(generated) if streamed is None
                         else int(streamed)),
            "age_s": age_s,
            "arrival_index": (None if arrival_index is None
                              else int(arrival_index))})
        with self._lock:
            if stream is not None:
                self._streams[erid] = stream
            self._unfinished.add(erid)
            self._telemetry["queue_depth"] = (
                int(self._telemetry.get("queue_depth", 0)) + 1)
        return erid

    def step(self):
        """One remote engine step.  A missing response (crash, wedge,
        watchdog verdict) raises straight through to the router's
        failover path; a successful response updates every mirror and
        performs the one-and-only stream delivery for its tokens."""
        r = self.call("step")
        events = [(erid, (None if tok is None else int(tok)),
                   bool(fin)) for erid, tok, fin in r["events"]]
        deliveries = []
        with self._lock:
            for f in r.get("finished", ()):
                self.finished_requests[f["rid"]] = FinishedRemote(
                    f["rid"], f["tokens"], f.get("finish_reason"))
            for erid, tok, fin in events:
                s = self._streams.get(erid)
                if s is not None and (tok is not None or fin):
                    deliveries.append((s, tok, fin))
                if fin:
                    self._streams.pop(erid, None)
                    self._unfinished.discard(erid)
            tel = r.get("telemetry")
            if tel:
                self._telemetry.update(tel)
        # exactly-once delivery, outside the proxy lock (the router's
        # wrapper re-enters the router RLock; user streams are user
        # code): this response is consumed exactly once, and these
        # tokens exist in no other response
        for s, tok, fin in deliveries:
            s(None, tok, fin)
        return events

    def has_unfinished(self):
        with self._lock:
            return bool(self._unfinished)

    def release_waiting(self):
        reqs = self.call("release_waiting") or []
        out = []
        with self._lock:
            for f in reqs:
                out.append(FinishedRemote(f["rid"], f["tokens"], None))
                self._streams.pop(f["rid"], None)
                self._unfinished.discard(f["rid"])
        return out

    def warmup(self):
        # warmup is boot-phase work: the replica compiles or loads the
        # AOT cache inside the dispatch, beat-silent the whole time
        self._hold_verdict(self._config.rendezvous_timeout_s)
        try:
            return self.call("warmup",
                             timeout_s=self._config.rendezvous_timeout_s)
        finally:
            self._release_verdict()

    def shutdown(self):
        """Best-effort, short-fuse: the router calls this on DEAD
        replicas too, where nobody is listening."""
        with self._lock:
            dead = self._dead
        if dead:
            return
        try:
            self.call("shutdown",
                      timeout_s=min(2.0,
                                    self._config.collective_timeout_s))
        except Exception:
            pass

    def attach_stream(self, erid, stream):
        """Register a controller-side stream for a request that joined
        the remote engine OUTSIDE add/adopt — e.g. a disaggregated
        ``import_handoff`` (step responses only ever carry a token
        once, so attachment order cannot double-deliver)."""
        with self._lock:
            if stream is not None:
                self._streams[erid] = stream
            self._unfinished.add(erid)

    # -------------------------------------------------- telemetry mirror
    def note_telemetry(self, tel):
        """Heartbeat-borne telemetry (queue depth / page occupancy /
        health) refreshed by the controller's monitor poll — keeps
        routing scores current BETWEEN steps without an RPC."""
        if not tel:
            return
        with self._lock:
            self._telemetry.update(tel)

    @property
    def health(self):
        with self._lock:
            return _HealthShim(self._telemetry.get("health", 0))

    @property
    def queue_depth(self):
        with self._lock:
            return int(self._telemetry.get("queue_depth", 0))

    @property
    def page_occupancy(self):
        with self._lock:
            return float(self._telemetry.get("page_occupancy", 0.0))

    @property
    def num_running(self):
        with self._lock:
            return int(self._telemetry.get("num_running", 0))
