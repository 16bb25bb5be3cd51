"""Router: telemetry-driven admission balancing over N engine replicas
(counterpart of ``paddle_tpu/serving/router/router.py``).

A :class:`Router` fronts N :class:`~paddle_tpu_torch.serving.LLMEngine`
replicas and decides where every request runs from the signals the
engines export (queue depth, page occupancy, the hysteretic health
state). Semantics, as the reference's:

- **Telemetry routing.** Admissions go to the best-scoring admitting
  replica (healthier, then an emptier queue, then lower page occupancy;
  the index breaks ties, so identical traces route identically).
- **Sticky affinity.** A request stays on one replica for its whole
  decode (its pages are there); the router re-homes it only on a drain
  or a failure.
- **Spillover and retry.** An :class:`AdmissionRejected` (queue_full,
  draining) spills the admission to the next-best replica; when every
  replica refuses, :meth:`Router.generate` retries the admission under a
  :class:`~paddle_tpu_torch.resilience.retry.RetryPolicy`, stepping the
  fleet between attempts: in-process, the productive wait is letting
  the engines drain.
- **Failover without data loss.** A replica whose ``step()`` raises is
  marked DEAD and every request it owned is migrated through
  ``engine.adopt_request``: the replay prefill rebuilds the KV cache from
  the prompt and the tokens generated so far, and the (seed, position)
  sampler draws the continuation, so routed output matches the
  sequential single-engine run across a crash (on the CPU exactly; on
  the card a replayed request's tokens can differ after its migration,
  PERF.md).
- **Elastic drain and respawn.** :meth:`Router.drain` takes a replica
  out of rotation (migrating its queued work), and an emptied or dead
  replica is respawned through the engine factory, booting warm from a
  shared AOT program cache (``serving/aot_cache.py``).

Replicas built from one ``model`` share that model object (one set of
weights on the card); each has its own KV pools and programs.

Thread model: one reentrant lock guards all router state; every method
that touches it takes the lock, and the optional :meth:`Router.start`
background loop is one more caller of :meth:`Router.step`. Engines are
touched by the router only. The lock is held across engine steps but
never across replica boots: a failover or drain queues a respawn, and
:meth:`Router.step` runs the engine factory with the lock released.
"""
from __future__ import annotations

import random
import threading
import time
import weakref
from collections import OrderedDict

from paddle_tpu_torch.observability import TraceContext, span, use_context
from paddle_tpu_torch.observability.metrics import (next_instance_label,
                                                    registry)
from paddle_tpu_torch.resilience.retry import RetryPolicy, compute_backoff
from paddle_tpu_torch.serving.router.metrics import RouterMetrics
from paddle_tpu_torch.serving.router.replica import (ReplicaHandle,
                                                     ReplicaState)
from paddle_tpu_torch.serving.scheduler import AdmissionRejected

__all__ = ["Router", "RouterConfig", "RouterResult"]


class RouterConfig:
    """Fleet policy knobs.

    - `spill_policy` / `boot_policy`: :class:`RetryPolicy` objects
      governing, respectively, whole-fleet admission retries in
      :meth:`Router.generate` and replica boot attempts.  Jitter
      defaults to 0 so routed runs replay deterministically; seed the
      policies per host to spread a real fleet.
    - `auto_respawn`: respawn a dead or drained-out replica through the
      engine factory (warm from the AOT cache when one is shared).
    - `warm_boot`: run ``engine.warmup()`` at boot so a replica enters
      rotation with its whole program ladder ready (and the boot time
      measured cold-vs-warm).
    - `stall_rounds`: consecutive event-free step rounds before
      :meth:`Router.generate` declares the fleet wedged instead of
      spinning forever.
    - `sleep`: injectable backoff sleeper (tests pass a no-op).
    """

    def __init__(self, spill_policy=None, boot_policy=None,
                 auto_respawn=True, warm_boot=True, retry_seed=0,
                 finished_retention=1024, stall_rounds=256,
                 sleep=time.sleep):
        self.spill_policy = spill_policy or RetryPolicy(
            max_attempts=6, backoff=0.005, multiplier=2.0, jitter=0.0)
        self.boot_policy = boot_policy or RetryPolicy(
            max_attempts=3, backoff=0.05, multiplier=2.0, jitter=0.0)
        self.auto_respawn = bool(auto_respawn)
        self.warm_boot = bool(warm_boot)
        self.retry_seed = int(retry_seed)
        self.finished_retention = int(finished_retention)
        self.stall_rounds = int(stall_rounds)
        self.sleep = sleep


class RouterResult:
    """What :meth:`Router.generate` returns per prompt."""

    def __init__(self, rec, replica_index):
        self.request_id = rec.rid
        self.prompt_token_ids = list(rec.prompt)
        self.output_token_ids = list(rec.tokens)
        self.finish_reason = rec.finish_reason
        self.migrations = rec.migrations
        self.replica = replica_index

    def __repr__(self):
        return (f"RouterResult({self.request_id}, "
                f"{len(self.output_token_ids)} tokens, "
                f"finish={self.finish_reason}, "
                f"replica={self.replica})")


class _RequestRecord:
    """Router-side shadow of one routed request: everything needed to
    re-home it (prompt, params, tokens so far) without asking the — by
    then possibly dead — owning engine."""

    __slots__ = ("rid", "prompt", "sp", "user_stream", "tokens",
                 "finished", "finish_reason", "replica", "engine_rid",
                 "migrations", "arrive_t", "trace")

    def __init__(self, rid, prompt, sp, user_stream, arrive_t):
        self.rid = rid
        self.prompt = prompt
        self.sp = sp
        self.user_stream = user_stream
        self.tokens = []
        self.finished = False
        self.finish_reason = None
        self.replica = None          # owning ReplicaHandle or None
        self.engine_rid = None
        self.migrations = 0
        self.arrive_t = arrive_t     # router clock; survives migration
        self.trace = None            # TraceContext; survives migration


class Router:
    """N-replica serving router (module docstring has the semantics).

    Construction: either hand it a `model` (+ optional shared
    `engine_config`, `program_cache` and `device`, which defaults to
    CUDA as the engine's does) and let it build ``LLMEngine`` s, or pass
    ``engine_factory(replica_index) -> LLMEngine`` for full control
    (per-replica configs). The factory is kept for respawns.

    Public surface: :meth:`add_request`, :meth:`step`, :meth:`generate`,
    :meth:`drain`, :meth:`start` / :meth:`stop`, :attr:`metrics`,
    :meth:`snapshot`, :meth:`shutdown`.
    """

    def __init__(self, model=None, engine_config=None, num_replicas=2,
                 config=None, engine_factory=None, program_cache=None,
                 metrics_name=None, clock=None, device=None):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self.config = config or RouterConfig()
        # injectable timebase: arrive_t stamps, RouterMetrics uptime,
        # and (through the default factory) every engine's
        # EngineMetrics.clock — the virtual-time traffic driver passes
        # one shared VirtualClock so TTFT/deadline accounting is
        # deterministic; None = wall clock, exactly as before
        self._clock = clock if clock is not None else time.perf_counter
        if engine_factory is None:
            if model is None:
                raise ValueError(
                    "pass a model (with optional engine_config) or an "
                    "engine_factory")
            from paddle_tpu_torch.serving.aot_cache import AOTProgramCache
            from paddle_tpu_torch.serving.engine import LLMEngine
            if isinstance(program_cache, str):
                program_cache = AOTProgramCache(program_cache)

            def engine_factory(index):
                return LLMEngine(model, engine_config, device=device,
                                 program_cache=program_cache,
                                 clock=clock)

        self._factory = engine_factory
        self._lock = threading.RLock()
        self._stop_event = threading.Event()
        self._thread = None
        self._metrics_name = (metrics_name
                              or next_instance_label("serving.router"))
        self.metrics = RouterMetrics(clock=self._clock,
                                     name=self._metrics_name)
        self._records = {}                 # live rid -> _RequestRecord
        self.finished_results = OrderedDict()    # rid -> RouterResult
        self._by_engine = {}     # (replica, generation, engine_rid) -> rid
        self._pending = []       # rids awaiting (re-)placement
        self._respawns = []      # (index, generation) boots step() owes
        self._reserved = set()   # rids generate() has yet to collect
        self._parked = set()     # replica indices held out of respawn
        self._next_id = 0
        replicas = [self._boot(i, generation=0)
                    for i in range(int(num_replicas))]
        with self._lock:
            self._replicas = replicas
            self.metrics.sync_gauges(live=len(replicas), draining=0)

        mref = weakref.ref(self)
        name = self._metrics_name

        def _snapshot():
            r = mref()
            if r is None:
                registry().unregister_source(name, expected=_snapshot)
                return {"error": "router collected"}
            return r.snapshot()

        self._snapshot_fn = _snapshot
        registry().register_source(name, _snapshot)

    # ------------------------------------------------------------- boot
    def _boot(self, index, generation):
        """Boot one replica (engine factory + warmup), retried under
        `boot_policy`; classifies the boot cold/warm from the engine's
        AOT-cache counters and records it in the boot histograms."""
        policy = self.config.boot_policy
        rng = random.Random(self.config.retry_seed + index)
        attempt = 0
        while True:
            t0 = time.perf_counter()
            try:
                engine = self._factory(index)
                boot = engine.warmup() if self.config.warm_boot else {}
                break
            except Exception as e:
                attempt += 1
                if attempt >= policy.max_attempts:
                    raise
                delay = compute_backoff(policy, attempt - 1, rng)
                with span("serving.router.boot_retry", replica=index,
                          attempt=attempt, exc=type(e).__name__):
                    pass
                if delay > 0:
                    self.config.sleep(delay)
        boot_s = time.perf_counter() - t0
        warm = bool(boot) and boot.get("compiled", 1) == 0 \
            and boot.get("cache_loads", 0) > 0
        with self._lock:
            self.metrics.note_boot(boot_s, warm)
        info = dict(boot)
        info.update(boot_ms=round(boot_s * 1e3, 3), warm=warm)
        with span("serving.router.boot", replica=index,
                  generation=generation, warm=warm,
                  boot_ms=info["boot_ms"]):
            pass
        return ReplicaHandle(index, engine, generation, info)

    def _queue_respawn(self, h):
        """Retire `h`'s engine and owe its slot a fresh boot — executed
        by :meth:`step` OUTSIDE the lock, because a boot is the one
        slow, blocking thing the router does (program builds or cache IO
        plus retry backoff) and holding the lock across it would stall every
        admission in the fleet."""
        with self._lock:
            try:
                h.engine.shutdown()
            except Exception:
                pass
            # a PARKED slot is the autoscaler's spare pool: its drain-
            # out must not auto-respawn — unpark() re-queues the boot
            # when the scale-up policy wants the capacity back
            if self.config.auto_respawn and h.index not in self._parked:
                self._respawns.append((h.index, h.generation + 1))

    def _run_respawns(self):
        """Boot every owed replica with the lock RELEASED, then install
        each under the lock and place any still-pending migrations."""
        while True:
            with self._lock:
                if not self._respawns:
                    return
                index, generation = self._respawns.pop(0)
            try:
                handle = self._boot(index, generation)  # lock released
            except Exception as e:
                # a failed boot (factory bug, transient OOM) must not
                # lose the slot forever: requeue and yield — the next
                # step retries, with the boot policy's backoff inside
                # _boot pacing each round
                with span("serving.router.respawn_failed",
                          replica=index, exc=type(e).__name__):
                    pass
                with self._lock:
                    self._respawns.append((index, generation))
                return
            with self._lock:
                self._replicas[index] = handle
                self.metrics.note_respawn()
            with span("serving.router.respawn", replica=index,
                      generation=generation,
                      warm=handle.boot_info.get("warm", False)):
                pass
            self._retry_pending()

    # -------------------------------------------------------- admission
    def _wrap_stream(self, rec):
        """Every routed request gets a wrapper stream — it is the
        router's ONLY exactly-once token tap.  The engine delivers each
        token exactly once (replays and adoptions skip already-streamed
        prefixes), so appending here keeps `rec.tokens` complete even
        for tokens delivered inside a step() that later RAISED — the
        failover migration then replays the true history and the user
        stream never sees a duplicate."""
        user = rec.user_stream
        rid = rec.rid

        def _stream(req, tok, fin):
            with self._lock:
                if tok is not None:
                    rec.tokens.append(int(tok))
                    self.metrics.generated_tokens += 1
                if fin:
                    # record the finish HERE, not only in the event
                    # path: a request that EOS'd inside a step() that
                    # later raised must never be migrated as unfinished
                    # (the replay would generate past its EOS)
                    rec.finished = True
            if user is not None:
                user(rid, tok, fin)

        return _stream

    def _candidates(self):
        with self._lock:
            return sorted((h for h in self._replicas if h.admitting),
                          key=lambda h: h.score())

    def add_request(self, prompt_token_ids, sampling_params=None,
                    stream=None):
        """Route one request to the best-scoring admitting replica;
        spills to the next on :class:`AdmissionRejected`, raises it only
        when EVERY replica refused.  Returns the router request id
        (``rr-N``).  `stream` receives ``(router_request_id, token,
        finished)`` — already-delivered tokens are never re-streamed
        across a migration."""
        arrive_t = self._clock()  # user callback: never under _lock
        with self._lock:
            self.metrics.requests_received += 1
            candidates = self._candidates()
            if not candidates:
                self.metrics.requests_rejected += 1
                raise AdmissionRejected(
                    "no_replica",
                    "every replica is draining, drained, or dead")
            rid = f"rr-{self._next_id}"
            prompt = [int(t) for t in prompt_token_ids]
            rec = _RequestRecord(rid, prompt, sampling_params, stream,
                                 arrive_t=arrive_t)
            # one distributed trace per request, born at admission: the
            # admit span installs it ambiently, so the engine (local
            # call or KV-RPC wire envelope) records under it
            rec.trace = TraceContext.new(hint=rid)
            last = None
            with span("serving.router.admit", ctx=rec.trace,
                      request=rid, prompt_tokens=len(prompt)):
                for h in candidates:
                    try:
                        erid = h.engine.add_request(
                            prompt, sampling_params,
                            stream=self._wrap_stream(rec))
                    except AdmissionRejected as e:
                        last = e
                        self.metrics.note_spillover()
                        with span("serving.router.spillover",
                                  replica=h.index, reason=e.reason):
                            pass
                        continue
                    rec.replica = h
                    rec.engine_rid = erid
                    self._records[rid] = rec
                    self._by_engine[(h.index, h.generation, erid)] = rid
                    self._next_id += 1
                    self.metrics.requests_routed += 1
                    return rid
            self.metrics.requests_rejected += 1
            raise AdmissionRejected(
                "all_replicas",
                f"{len(candidates)} replicas refused "
                f"(last: {getattr(last, 'reason', '?')})")

    # ------------------------------------------------------------ step
    def step(self):
        """One fleet iteration: place pending migrations, step every
        live replica (failing replicas fail over in-line), recycle
        drained-out replicas.  Returns ``[(router_request_id, token,
        finished), ...]`` across the whole fleet."""
        events = []
        with self._lock:
            self._retry_pending()
            for h in list(self._replicas):
                if not h.alive:
                    continue
                if not h.engine.has_unfinished():
                    if h.state is ReplicaState.DRAINING:
                        self._queue_respawn(h)
                        h.state = ReplicaState.DEAD
                    continue
                try:
                    evs = h.engine.step()
                except Exception as e:
                    self._failover(h, e)
                    continue
                self._absorb_events(h, evs, events)
            self.metrics.sync_gauges(
                live=sum(1 for h in self._replicas if h.alive),
                draining=sum(1 for h in self._replicas
                             if h.state is ReplicaState.DRAINING))
        self._run_respawns()               # boots run OUTSIDE the lock
        return events

    def _absorb_events(self, h, evs, out):
        with self._lock:
            for erid, tok, fin in evs:
                rid = self._by_engine.get((h.index, h.generation, erid))
                if rid is None:
                    continue
                rec = self._records.get(rid)
                if rec is None:
                    continue
                out.append((rid, tok, fin))
                if fin:
                    req = h.engine.finished_requests.pop(erid, None)
                    if req is not None:
                        # authoritative: covers deadline finishes (no
                        # token event) and adopted histories in one shot
                        rec.tokens = [int(t)
                                      for t in req.output_token_ids]
                        rec.finish_reason = req.finish_reason
                    rec.finished = True
                    self._by_engine.pop((h.index, h.generation, erid),
                                        None)
                    self._finish(rec, h.index)

    def _finish(self, rec, replica_index):
        with self._lock:
            self._records.pop(rec.rid, None)
            self.metrics.requests_finished += 1
            self.finished_results[rec.rid] = RouterResult(
                rec, replica_index)
            # retention never evicts a result an in-flight generate()
            # still holds a claim on (`_reserved`) — a burst of
            # finishes larger than the cap must not turn into silent
            # result loss for the caller waiting to collect them
            while len(self.finished_results) > \
                    self.config.finished_retention:
                victim = next((k for k in self.finished_results
                               if k not in self._reserved), None)
                if victim is None:
                    break
                self.finished_results.pop(victim)

    # -------------------------------------------------------- failover
    def _failover(self, h, exc):
        """A replica's step raised: mark it DEAD, migrate every request
        it owned (tokens intact — the adopt replay regenerates the
        continuation token-identically), queue a respawn."""
        with self._lock:
            h.state = ReplicaState.DEAD
            self.metrics.note_failover()
            owned = [rec for rec in self._records.values()
                     if rec.replica is h]
            affected = []
            for rec in owned:
                self._by_engine.pop(
                    (h.index, h.generation, rec.engine_rid), None)
                if rec.finished:
                    # finished inside the crashed step (stream saw its
                    # fin) but the step's events were lost: close it
                    # out from the dead engine's finished table instead
                    # of migrating a done request
                    req = h.engine.finished_requests.pop(
                        rec.engine_rid, None)
                    if req is not None:
                        rec.tokens = [int(t)
                                      for t in req.output_token_ids]
                        rec.finish_reason = req.finish_reason
                    self._finish(rec, h.index)
                    continue
                rec.replica = None
                rec.engine_rid = None
                self._pending.append(rec.rid)
                affected.append(rec)
        with span("serving.router.failover", replica=h.index,
                  exc=type(exc).__name__, requests=len(affected)):
            pass
        self._queue_respawn(h)
        self._retry_pending()

    def _retry_pending(self):
        with self._lock:
            pending, self._pending = self._pending, []
            still = []
            for rid in pending:
                rec = self._records.get(rid)
                if rec is None or rec.finished:
                    continue
                if not self._adopt(rec):
                    still.append(rid)
            self._pending.extend(still)

    def _adopt(self, rec):
        from paddle_tpu_torch.serving.request import SamplingParams
        with self._lock:
            sp = rec.sp
            max_new = (sp if sp is not None
                       else SamplingParams()).max_new_tokens
            if len(rec.tokens) >= max_new:
                # crashed between the last token and its finish event —
                # nothing left to generate; close it out as the engine
                # would
                rec.finished = True
                rec.finish_reason = rec.finish_reason or "length"
                self._finish(rec, -1)
                return True
            for h in self._candidates():
                try:
                    # negative arrival index = "older than every native
                    # admission": a migrated request already paid its
                    # queueing dues, so it must not become the target
                    # engine's preferred (latest-arrived) preemption
                    # victim; router submission order breaks ties.
                    # use_context: the adopting engine's spans (local or
                    # across the wire) rejoin the request's birth trace
                    with use_context(rec.trace):
                        erid = h.engine.adopt_request(
                            rec.prompt, sp,
                            generated_token_ids=rec.tokens,
                            stream=self._wrap_stream(rec),
                            arrive_t=rec.arrive_t,
                            arrival_index=int(rec.rid.split("-")[1])
                            - (1 << 30))
                except (AdmissionRejected, ValueError):
                    continue
                rec.replica = h
                rec.engine_rid = erid
                rec.migrations += 1
                self._by_engine[(h.index, h.generation, erid)] = rec.rid
                self.metrics.adoptions += 1
                return True
            return False

    # ----------------------------------------------------- drain/respawn
    def drain(self, index, migrate_waiting=True):
        """Take replica `index` out of rotation: no new admissions, its
        RUNNING requests finish in place (their pages are local), and —
        with `migrate_waiting` — its still-queued requests are migrated
        to admitting replicas immediately.  Once the replica empties,
        the next :meth:`step` recycles it (respawn under
        `auto_respawn`, else retirement)."""
        with self._lock:
            h = self._replicas[int(index)]
            if not h.alive:
                raise ValueError(f"replica {index} is not alive")
            h.state = ReplicaState.DRAINING
            self.metrics.drains += 1
            with span("serving.router.drain", replica=h.index,
                      migrate_waiting=bool(migrate_waiting)):
                pass
            if migrate_waiting:
                for req in h.engine.release_waiting():
                    rid = self._by_engine.pop(
                        (h.index, h.generation, req.request_id), None)
                    rec = self._records.get(rid) if rid else None
                    if rec is None:
                        continue
                    rec.tokens = [int(t) for t in req.output_token_ids]
                    rec.replica = None
                    rec.engine_rid = None
                    self._pending.append(rec.rid)
        if migrate_waiting:
            self._retry_pending()
        return h

    def park(self, index, migrate_waiting=True):
        """Scale-down: drain replica `index` AND hold its emptied slot
        out of auto-respawn — the slot becomes spare capacity (the
        autoscaler's spare pool) until :meth:`unpark` reclaims it.  A
        normal :meth:`drain` in every other respect: running work
        finishes in place, queued work migrates."""
        with self._lock:
            self._parked.add(int(index))
            return self.drain(index, migrate_waiting)

    def unpark(self, index):
        """Scale-up: reclaim a parked slot through the EXISTING respawn
        queue — the next :meth:`step` boots it outside the lock, warm
        from the shared AOT cache, so admissions never stall behind the
        boot.  A slot still draining is simply returned to rotation
        (the drain is cancelled — cheaper than a boot).  Idempotent on
        non-parked live slots."""
        with self._lock:
            index = int(index)
            self._parked.discard(index)
            h = self._replicas[index]
            if h.state is ReplicaState.DRAINING:
                h.state = ReplicaState.ACTIVE
                with span("serving.router.unpark", replica=index,
                          cancelled_drain=True):
                    pass
                return h
            if not h.alive and \
                    (index, h.generation + 1) not in self._respawns:
                self._respawns.append((index, h.generation + 1))
                with span("serving.router.unpark", replica=index,
                          cancelled_drain=False):
                    pass
            return h

    @property
    def parked(self):
        """Indices currently held out of auto-respawn (spare pool)."""
        with self._lock:
            return set(self._parked)

    # ---------------------------------------------------------- facade
    def has_unfinished(self):
        with self._lock:
            if self._records or self._pending:
                return True
            return any(h.alive and h.engine.has_unfinished()
                       for h in self._replicas)

    def _submit_with_retry(self, prompt, sp):
        """Admission with whole-fleet backpressure retry: every replica
        refusing triggers a fleet step (the productive wait — queues
        drain) plus a `spill_policy` backoff before the next attempt."""
        policy = self.config.spill_policy
        rng = random.Random(self.config.retry_seed)
        attempt = 0
        while True:
            try:
                return self.add_request(prompt, sp)
            except AdmissionRejected:
                attempt += 1
                if attempt >= policy.max_attempts:
                    raise
                with span("serving.router.backpressure",
                          attempt=attempt):
                    pass
                self.step()
                delay = compute_backoff(policy, attempt - 1, rng)
                if delay > 0:
                    self.config.sleep(delay)

    def generate(self, prompts, sampling_params=None):
        """Sync facade: route `prompts` (list of token-id lists) across
        the fleet and serve to completion; returns one
        :class:`RouterResult` per prompt in input order — token-
        identical to a sequential single-engine run regardless of
        routing, drains, or failovers."""
        if prompts and isinstance(prompts[0], int):
            raise TypeError("generate expects a LIST of prompts "
                            "(each a list of token ids)")
        if isinstance(sampling_params, (list, tuple)):
            if len(sampling_params) != len(prompts):
                raise ValueError("one SamplingParams per prompt required")
            sps = list(sampling_params)
        else:
            sps = [sampling_params] * len(prompts)
        rids = []
        try:
            for p, sp in zip(prompts, sps):
                rid = self._submit_with_retry(p, sp)
                rids.append(rid)
                with self._lock:
                    # claim the result: batches larger than
                    # finished_retention must not see their earliest
                    # results evicted before this call collects them
                    self._reserved.add(rid)
            idle = 0
            while True:
                with self._lock:
                    done = all(r in self.finished_results
                               for r in rids)
                if done:
                    break
                if not self.has_unfinished():
                    raise RuntimeError(
                        "router lost track of in-flight requests "
                        "(fleet emptied with results missing)")
                events = self.step()
                idle = 0 if events else idle + 1
                if idle > self.config.stall_rounds:
                    raise RuntimeError(
                        f"router stalled: {self.config.stall_rounds} "
                        f"event-free rounds with requests outstanding "
                        f"(all replicas dead or work unplaceable)")
            with self._lock:
                return [self.finished_results.pop(r) for r in rids]
        finally:
            with self._lock:
                self._reserved.difference_update(rids)

    # --------------------------------------------------- background loop
    def start(self, interval_s=0.005):
        """Spawn the background step loop (daemon thread): admissions
        from any thread are then served without the caller driving
        :meth:`step`.  Idempotent; :meth:`stop` joins it."""
        with self._lock:
            if self._thread is not None:
                return self._thread
            self._stop_event.clear()
            t = threading.Thread(
                target=self._serve_loop, args=(float(interval_s),),
                name=f"{self._metrics_name}.loop", daemon=True)
            self._thread = t
        t.start()
        return t

    def _serve_loop(self, interval_s):
        while not self._stop_event.is_set():
            try:
                events = self.step()
            except Exception as e:
                # the daemon loop must survive a bad step (it is the
                # only thing serving background admissions) — record
                # and pace, don't die silently
                with span("serving.router.loop_error",
                          exc=type(e).__name__):
                    pass
                events = []
            if not events:
                # nothing moved: park on the event (not time.sleep) so
                # stop() wakes the loop immediately
                self._stop_event.wait(interval_s)

    def stop(self):
        """Stop and join the background loop (no-op when not running)."""
        self._stop_event.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    # ------------------------------------------------------ observability
    def snapshot(self):
        """Fleet snapshot: router counters + per-replica lifecycle and
        the live telemetry each routing decision reads."""
        with self._lock:
            snap = self.metrics.snapshot()
            snap["replica_detail"] = [h.describe()
                                      for h in self._replicas]
            snap["pending_migrations"] = len(self._pending)
            snap["parked"] = sorted(self._parked)
            return snap

    @property
    def replicas(self):
        with self._lock:
            return list(self._replicas)

    def shutdown(self):
        """Stop the loop, shut every replica down, release the router's
        registry instruments and metrics source."""
        self.stop()
        with self._lock:
            for h in self._replicas:
                try:
                    h.engine.shutdown()
                except Exception:
                    pass
            registry().unregister_source(self._metrics_name,
                                         expected=self._snapshot_fn)
            self.metrics.release()
