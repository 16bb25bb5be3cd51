"""ServingFleet: the controller that fronts remote replica workers with
the port's stock Router (counterpart of
``paddle_tpu/serving/fleet/controller.py``).

The controller process owns the Router, the fleet watchdog
(:class:`~paddle_tpu_torch.resilience.fleet.FleetMonitor`) and one
:class:`~paddle_tpu_torch.serving.fleet.handle.RemoteEngineClient` per
live replica; each replica process runs a
:class:`~paddle_tpu_torch.serving.fleet.server.ReplicaServer` around a
real engine. The router's ``engine_factory`` is where elasticity lives:

- the first boot of replica slot ``i`` claims ``worker_ranks[i]``;
- a RESPAWN of slot ``i`` (its rank is dead: SIGKILL, a SIGSTOP
  verdict, or drained out) claims the next idle SPARE rank instead,
  whose ``boot`` builds an engine over the shared AOT program cache
  (``serving/aot_cache.py``), so the router's ``warmup()`` classifies
  the boot warm (no build, every program loaded);
- the rank's verdicts are held through the boot (a booting replica may
  be silent), and a failed boot rolls the claim back;
- an empty spare pool raises, which the router answers by requeueing
  the respawn: capacity degrades instead of the fleet dying.

The watchdog aborts every pending RPC of a DEAD rank (``abort_if``),
and its heartbeat-borne telemetry refreshes each proxy's routing score
between steps. A DEAD verdict also finalizes the dead rank's telemetry
spool into a post-mortem (``fleettrace.flight_record``) when spooling
is armed (``PTPU_OBS_SPOOL_DIR``).
"""
from __future__ import annotations

import threading
import time

from paddle_tpu_torch.observability import span
from paddle_tpu_torch.resilience import fleet as _fleet
from paddle_tpu_torch.serving.fleet.handle import RemoteEngineClient

__all__ = ["ServingFleet", "FleetServingConfig"]


class FleetServingConfig:
    """Controller wiring: which coordination ranks serve, which are
    spares, and what the replica ``boot`` verb should build.

    - `worker_ranks`: the initially-ACTIVE replica ranks, one router
      replica slot each.
    - `spare_ranks`: prespawned idle workers, claimed in order by
      respawns (respawn-elsewhere).
    - `boot_payload`: opaque dict handed to the worker's engine
      factory (model/engine config, AOT cache dir, seed — the worker
      entrypoint decides its meaning).
    - `rpc_timeout_s`: per-RPC deadline (defaults to the fleet
      config's ``collective_timeout_s``).
    """

    def __init__(self, worker_ranks, spare_ranks=(), boot_payload=None,
                 fleet_config=None, rpc_timeout_s=None):
        self.worker_ranks = [int(r) for r in worker_ranks]
        self.spare_ranks = [int(r) for r in spare_ranks]
        if not self.worker_ranks:
            raise ValueError("at least one worker rank is required")
        overlap = set(self.worker_ranks) & set(self.spare_ranks)
        if overlap:
            raise ValueError(f"ranks {sorted(overlap)} are both "
                             f"active and spare")
        self.boot_payload = dict(boot_payload or {})
        self.fleet_config = fleet_config or _fleet.get_config()
        if rpc_timeout_s is not None:
            # narrow ONLY the RPC deadline, not the shared fleet config
            import copy
            fc = copy.copy(self.fleet_config)
            fc.collective_timeout_s = float(rpc_timeout_s)
            self.fleet_config = fc


class ServingFleet:
    def __init__(self, client, config, *, router_config=None,
                 monitor=None, namespace_fn=None, start_monitor=True):
        self.client = client
        self.config = config
        self._ns = namespace_fn or _fleet.coord_namespace
        self._lock = threading.Lock()
        self._spares = list(config.spare_ranks)
        self._assigned = {}       # replica index -> current rank
        self._retired = []        # (index, rank) of replaced workers
        self.proxies = {}         # rank -> RemoteEngineClient
        self.respawn_ms = []      # boot wall time of each respawn
        self.postmortems = {}     # rank -> flight-record dict
        self.monitor = monitor
        if self.monitor is None:
            self.monitor = _fleet.FleetMonitor(
                client=client, config=config.fleet_config)
        # crash flight recorder: a DEAD verdict finalizes the dead
        # rank's telemetry spool into a post-mortem (last spans, last
        # metric snapshot, in-flight request ids).  Chained IN FRONT of
        # any hook an externally-provided monitor already has.
        prev_on_dead = self.monitor.on_dead

        def _on_dead(ranks, _prev=prev_on_dead):
            self._flight_record(ranks)
            if _prev is not None:
                _prev(ranks)

        self.monitor.on_dead = _on_dead
        if start_monitor:
            self.monitor.start()
        # import here so a fleet-less serving install stays light
        from paddle_tpu_torch.serving.router.router import (Router,
                                                        RouterConfig)
        self.router = Router(
            engine_factory=self._factory,
            num_replicas=len(config.worker_ranks),
            config=router_config or RouterConfig())

    # ---------------------------------------------------- elasticity
    def _factory(self, index):
        """Router boot hook: claim a rank for replica slot `index` —
        the slot's initial rank on first boot, the next SPARE on a
        respawn — and drive the worker's ``boot`` verb."""
        t0 = time.perf_counter()
        with self._lock:
            respawn = index in self._assigned
            prev_rank = self._assigned.get(index)
            if respawn:
                if not self._spares:
                    # leave _assigned/_retired untouched: the router
                    # requeues this respawn and retries next step
                    raise RuntimeError(
                        f"replica slot {index} needs a respawn but the "
                        f"spare pool is empty — retrying next step")
                self._retired.append((index, prev_rank))
                rank = self._spares.pop(0)
            else:
                rank = self.config.worker_ranks[index]
            self._assigned[index] = rank
        proxy = RemoteEngineClient(
            self.client, rank, namespace_fn=self._ns,
            config=self.config.fleet_config,
            abort_if=lambda r=rank: self.monitor.is_dead(r),
            hold_verdict=lambda s, r=rank:
                self.monitor.hold_verdict(r, s),
            release_verdict=lambda r=rank:
                self.monitor.release_verdict_hold(r))
        payload = dict(self.config.boot_payload)
        payload.update(replica_index=int(index), rank=int(rank),
                       respawn=bool(respawn))
        # verdicts held for the boot window: the worker goes silent
        # while it builds its engine, and a spurious terminal DEAD
        # mid-boot would wedge the rank forever (the rendezvous
        # deadline below still bounds a boot that never completes)
        self.monitor.hold_verdict(
            rank, self.config.fleet_config.rendezvous_timeout_s)
        try:
            proxy.call("boot", payload,
                       timeout_s=self.config.fleet_config
                       .rendezvous_timeout_s)
        except Exception:
            # un-claim on boot failure: a transient boot abort must
            # not leak the claim — the spare goes back in the pool
            # (same one is retried next attempt) and the slot's
            # previous owner is restored, or every failed first boot
            # would burn a spare until the pool reads empty
            with self._lock:
                if respawn:
                    self._spares.insert(0, rank)
                    self._retired.pop()
                    self._assigned[index] = prev_rank
                else:
                    self._assigned.pop(index, None)
            raise
        finally:
            self.monitor.release_verdict_hold(rank)
        with self._lock:
            self.proxies[rank] = proxy
        if respawn:
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            with self._lock:
                self.respawn_ms.append(ms)
            with span("serving.fleet.respawn", replica=index,
                      rank=rank, boot_ms=ms):
                pass
        return proxy

    # ----------------------------------------------- flight recorder
    def _flight_record(self, ranks):
        """Watchdog ``on_dead`` hook (monitor thread, outside its
        lock): recover each dead rank's post-mortem from its telemetry
        spool.  A no-op when spooling is not armed fleet-wide."""
        import os
        from paddle_tpu_torch.observability import fleettrace
        spool_dir = os.environ.get(fleettrace.SPOOL_ENV)
        if not spool_dir or not os.path.isdir(spool_dir):
            return
        for rank in ranks:
            if rank in self.postmortems:
                continue
            try:
                report = fleettrace.flight_record(spool_dir, rank)
            except Exception:
                continue        # a torn spool must not break failover
            if report is None:
                continue
            self.postmortems[int(rank)] = report
            # the failover span's post-mortem rider: WHAT the rank was
            # doing when it died, on the controller's own timeline
            with span("serving.fleet.postmortem", rank=int(rank),
                      in_flight=len(report["in_flight_requests"]),
                      spans=report["spans_total"],
                      path=report.get("path")):
                pass

    # ------------------------------------------------------- serving
    def step(self):
        """One fleet iteration: refresh heartbeat-borne telemetry into
        the proxies (keeps routing scores live between steps), then
        one router step."""
        self.refresh_telemetry()
        return self.router.step()

    def refresh_telemetry(self):
        with self._lock:
            items = list(self.proxies.items())
        for rank, proxy in items:
            tel = self.monitor.telemetry(rank)
            if tel is not None:
                proxy.note_telemetry(tel)

    def rank_of(self, index):
        with self._lock:
            return self._assigned.get(int(index))

    def proxy_for_rank(self, rank):
        with self._lock:
            return self.proxies.get(int(rank))

    def detections(self):
        """Every watchdog-driven RPC abort the proxies saw:
        ``[{rank, verdict, waited_s, detect_s, ...}]`` — the failover-
        detection evidence the chaos proof and bench lane report."""
        out = []
        with self._lock:
            proxies = list(self.proxies.values())
        for p in proxies:
            if p.last_timeout is not None:
                d = dict(p.last_timeout)
                d["rank"] = p.rank
                d["detect_s"] = p.detect_s
                out.append(d)
        return out

    def shutdown(self, stop_monitor=True):
        """Best-effort fleet teardown: shut the router down (which
        short-fuse ``shutdown``s each live proxy), then every worker
        that never joined the router (unused spares), then the
        watchdog."""
        try:
            self.router.shutdown()
        except Exception:
            pass
        with self._lock:
            booted = set(self.proxies)
            idle = [r for r in self._spares if r not in booted]
        for rank in idle:
            proxy = RemoteEngineClient(
                self.client, rank, namespace_fn=self._ns,
                config=self.config.fleet_config)
            try:
                proxy.call("shutdown", timeout_s=2.0)
            except Exception:
                pass
        if stop_monitor:
            try:
                self.monitor.stop()
            except Exception:
                pass
