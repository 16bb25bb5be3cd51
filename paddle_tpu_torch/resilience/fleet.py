"""Fleet-grade fault tolerance: timeout-bounded coordination, rank
heartbeats with a fleet watchdog, sharded distributed checkpoints, and
elastic reconfigure-and-resume (counterpart of
``paddle_tpu/resilience/fleet.py``).

Every multi-process path of the port rides one coordination key-value
store: the launcher's :class:`~paddle_tpu_torch.distributed.launch.
StoreKVClient` over ``torch.distributed.TCPStore`` (rank 0 hosts it),
or an in-process :class:`LocalKVClient` for rank-per-thread worlds.
Both have the surface of the reference's coordination-service client.
The fleet layer turns "one rank died" into a bounded, observable,
recoverable protocol:

1. **Timeout-bounded KV gets**: :func:`kv_get_bytes` slices a blocking
   get into short store round trips with seeded-backoff retries under
   one deadline, raising a machine-readable :class:`CollectiveTimeout`
   naming the missing rank instead of hanging; ``abort_if`` bails out
   within one slice once the watchdog holds the awaited peer DEAD.
2. **Rank heartbeats and a fleet watchdog**: every rank runs a
   :class:`HeartbeatPublisher` (a monotonic sequence and a progress
   counter through the store; ``elastic.notify_progress()`` feeds the
   progress counter); a :class:`FleetMonitor` classifies peers HEALTHY
   → SUSPECT → DEAD with hysteresis, drives the ``fleet_rank_state
   {rank=}`` / ``fleet_last_heartbeat_age_s{rank=}`` gauges and records
   ``resilience.fleet.*`` spans in :mod:`paddle_tpu_torch.observability`.
3. **Sharded distributed checkpoints**: :class:`DistributedCheckpointer`
   writes one shard per rank through ``framework.io.write_atomic``;
   rank 0 commits a quorum MANIFEST (sha256 per shard) only after every
   shard digest is durable, and ``load()`` reshards the dp-stacked
   leaves to another world size, skipping torn entries.
4. **Elastic reconfigure**: :func:`reconfigure` re-rendezvouses the
   survivors under a fresh key namespace at the shrunk world size.

The world is the one the launcher pinned (:func:`_set_world`), else a
world of one: the port never asks a backend how many processes run.
Rank 0 hosts the store, so rank 0's death is unrecoverable in-process
(the launcher's exit code restarts the job); every other rank's death
is recoverable here.

:func:`kv_set_bytes` pads every payload to at least 2 bytes, as the
reference does (its store client failed on one-byte values); readers
tolerate a trailing pad byte on sub-2-byte payloads.
"""
from __future__ import annotations

import json
import os
import pickle
import random
import threading
import time
import uuid
import zlib
from enum import IntEnum

import numpy as np

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.resilience import faultinject
from paddle_tpu_torch.resilience.checkpoint import (_MANIFEST,
                                                    CheckpointCorruption,
                                                    digest_bytes,
                                                    read_manifest,
                                                    write_manifest)
from paddle_tpu_torch.resilience.retry import RetryPolicy, compute_backoff

__all__ = [
    "CollectiveTimeout",
    "DistributedCheckpointer",
    "FleetConfig",
    "FleetMonitor",
    "HeartbeatPublisher",
    "LocalKVClient",
    "RankState",
    "WorldView",
    "configure",
    "coord_namespace",
    "coord_shutdown",
    "finalize",
    "get_client",
    "get_config",
    "get_monitor",
    "get_publisher",
    "install_client",
    "install_monitor",
    "install_publisher",
    "kv_get_bytes",
    "kv_set_bytes",
    "notify_fleet_progress",
    "reconfigure",
    "world",
]


# --------------------------------------------------------------- config
def _env_float(name, default):
    v = os.environ.get(name)
    try:
        return float(v) if v else float(default)
    except ValueError:
        return float(default)


class FleetConfig:
    """Timeout budgets for the coordination path, each with an env
    override (the reference's knobs and defaults):

    - ``collective_timeout_s`` (``PTPU_FLEET_TIMEOUT_S``, 60): total
      wait for one peer before :class:`CollectiveTimeout`;
    - ``kv_slice_s`` (``PTPU_FLEET_KV_SLICE_S``, 1): one blocking-get
      round trip, the granularity at which ``abort_if`` is polled;
    - ``heartbeat_interval_s`` (``PTPU_FLEET_HB_INTERVAL_S``, 5) and the
      SUSPECT / DEAD ages (``PTPU_FLEET_SUSPECT_AFTER_S`` /
      ``PTPU_FLEET_DEAD_AFTER_S``, 3x / 6x the interval);
    - ``rendezvous_timeout_s`` (``PTPU_FLEET_RENDEZVOUS_TIMEOUT_S``,
      the collective timeout): reconfigure's join and a replica's boot;
    - ``progress_timeout_s`` (``PTPU_FLEET_PROGRESS_TIMEOUT_S``, unset =
      off): frozen progress → SUSPECT.
    """

    def __init__(self, collective_timeout_s=None, kv_slice_s=None,
                 heartbeat_interval_s=None, suspect_after_s=None,
                 dead_after_s=None, rendezvous_timeout_s=None,
                 progress_timeout_s=None, retry=None):
        self.collective_timeout_s = (
            collective_timeout_s if collective_timeout_s is not None
            else _env_float("PTPU_FLEET_TIMEOUT_S", 60.0))
        self.kv_slice_s = (kv_slice_s if kv_slice_s is not None
                           else _env_float("PTPU_FLEET_KV_SLICE_S", 1.0))
        self.heartbeat_interval_s = (
            heartbeat_interval_s if heartbeat_interval_s is not None
            else _env_float("PTPU_FLEET_HB_INTERVAL_S", 5.0))
        self.suspect_after_s = (
            suspect_after_s if suspect_after_s is not None
            else _env_float("PTPU_FLEET_SUSPECT_AFTER_S",
                            3.0 * self.heartbeat_interval_s))
        self.dead_after_s = (
            dead_after_s if dead_after_s is not None
            else _env_float("PTPU_FLEET_DEAD_AFTER_S",
                            6.0 * self.heartbeat_interval_s))
        self.rendezvous_timeout_s = (
            rendezvous_timeout_s if rendezvous_timeout_s is not None
            else _env_float("PTPU_FLEET_RENDEZVOUS_TIMEOUT_S",
                            self.collective_timeout_s))
        if progress_timeout_s is None:
            progress_timeout_s = _env_float(
                "PTPU_FLEET_PROGRESS_TIMEOUT_S", 0.0) or None
        self.progress_timeout_s = progress_timeout_s
        if not (0 < self.suspect_after_s < self.dead_after_s):
            raise ValueError(
                "need 0 < suspect_after_s < dead_after_s, got "
                f"{self.suspect_after_s}/{self.dead_after_s}")
        # short max_backoff: the slice-get itself blocks server-side,
        # backoff only spaces the store round trips
        self.retry = retry or RetryPolicy(
            max_attempts=1_000_000, backoff=0.02, multiplier=2.0,
            max_backoff=0.5, jitter=0.5)


_config = FleetConfig()
_config_lock = threading.Lock()


def get_config():
    return _config


def configure(**overrides):
    """Replace the process-wide :class:`FleetConfig`; returns it."""
    global _config
    with _config_lock:
        _config = FleetConfig(**overrides)
        return _config


# --------------------------------------------------------------- errors
class CollectiveTimeout(RuntimeError):
    """A coordination wait exceeded its deadline (or the watchdog held
    the awaited peer DEAD). Machine-readable: ``site`` / ``key`` /
    ``missing_rank`` / ``waited_s`` / ``timeout_s`` / ``namespace`` /
    ``verdict`` ("deadline" or "dead-verdict")."""

    def __init__(self, site, key=None, missing_rank=None, waited_s=0.0,
                 timeout_s=0.0, namespace=None, verdict=None):
        self.site = str(site)
        self.key = key
        self.missing_rank = missing_rank
        self.waited_s = float(waited_s)
        self.timeout_s = float(timeout_s)
        self.namespace = namespace
        self.verdict = verdict
        who = (f"rank {missing_rank}" if missing_rank is not None
               else f"key {key!r}")
        super().__init__(
            f"collective timeout at {self.site!r}: {who} missing after "
            f"{self.waited_s:.2f}s (budget {self.timeout_s:.2f}s, "
            f"verdict={self.verdict or 'deadline'})")

    def to_dict(self):
        return {"site": self.site, "key": self.key,
                "missing_rank": self.missing_rank,
                "waited_s": round(self.waited_s, 3),
                "timeout_s": self.timeout_s,
                "namespace": self.namespace,
                "verdict": self.verdict or "deadline"}


# ---------------------------------------------------------------- world
class WorldView:
    """The fleet's membership: the GLOBAL ranks (launch-time process
    ids, stable across reconfigurations) that are members, this
    process's global rank, and the contiguous fleet rank (its index in
    the member list). Generation 0 is the launch world; every
    :func:`reconfigure` bumps it and shrinks ``members``."""

    def __init__(self, members, global_rank, generation=0,
                 launch_id="local"):
        self.members = tuple(int(m) for m in members)
        self.global_rank = int(global_rank)
        if self.global_rank not in self.members:
            raise ValueError(
                f"global rank {self.global_rank} not in members "
                f"{self.members}")
        self.generation = int(generation)
        self.launch_id = str(launch_id)

    @property
    def rank(self):
        return self.members.index(self.global_rank)

    @property
    def size(self):
        return len(self.members)

    @property
    def namespace(self):
        return f"ptpu/{self.launch_id}/g{self.generation}"

    def to_dict(self):
        return {"members": list(self.members),
                "global_rank": self.global_rank, "rank": self.rank,
                "size": self.size, "generation": self.generation,
                "launch_id": self.launch_id}

    def __repr__(self):
        return (f"WorldView(members={self.members}, "
                f"global_rank={self.global_rank}, "
                f"generation={self.generation})")


_world = None
_world_lock = threading.Lock()
_launch_id = [None]
_installed_client = [None]


def install_client(client):
    """Make ``client`` this process's coordination client (the launcher
    installs its store client; None uninstalls)."""
    with _world_lock:
        _installed_client[0] = client
    return client


def get_client():
    """The installed coordination client, or None (single process)."""
    return _installed_client[0]



def _ensure_launch_id(client=None):
    """The per-run id namespacing every coordination key. Agreement
    order: ``PADDLE_LAUNCH_ID`` wins; else fleet rank 0 publishes a
    fresh uuid through the store and peers read it; else ``local``.
    Runs outside the world lock (it blocks on the store)."""
    if _launch_id[0] is not None:
        return _launch_id[0]
    lid = os.environ.get("PADDLE_LAUNCH_ID")
    if not lid:
        client = client if client is not None else get_client()
        if client is not None:
            key = "ptpu/launch/current"
            if world().global_rank == 0:
                lid = uuid.uuid4().hex[:8]
                client.key_value_set(key, lid, allow_overwrite=True)
            else:
                lid = kv_get_bytes(
                    client, key, get_config().rendezvous_timeout_s,
                    site="fleet.kv_get", missing_rank=0).decode()
        else:
            lid = "local"
    with _world_lock:
        if _launch_id[0] is None:
            _launch_id[0] = str(lid)
        return _launch_id[0]


def world():
    """The pinned :class:`WorldView` (the launcher's, or a
    reconfigure's), else a world of one."""
    wv = _world
    if wv is not None:
        return wv
    return WorldView((0,), 0, generation=0,
                     launch_id=_launch_id[0] or "local")


def _set_world(wv):
    global _world
    with _world_lock:
        _world = wv
    return wv


def coord_namespace():
    """Key namespace of the current world generation: every
    coordination key lives under it, so one ``key_value_delete`` of the
    namespace reaps a generation."""
    wv = _world
    if wv is not None:
        return wv.namespace
    return f"ptpu/{_launch_id[0] or 'local'}/g0"


def coord_shutdown(client=None):
    """Clean-exit reap: fleet rank 0 deletes the current generation's
    namespace."""
    client = client if client is not None else get_client()
    if client is None:
        return
    if world().rank != 0:
        return
    try:
        client.key_value_delete(coord_namespace())
    except Exception:
        pass


_finalized = [False]


def finalize(timeout_s=30.0, client=None):
    """Fleet check-out barrier: every member publishes a done marker;
    global rank 0 (the store's host, the one rank that may not leave
    early) lingers until every member checked out, under ONE shared
    deadline, then reaps the namespace. Registered at exit by the
    launcher; idempotent."""
    if _finalized[0]:
        return
    _finalized[0] = True
    client = client if client is not None else get_client()
    if client is None:
        return
    wv = world()
    try:
        kv_set_bytes(client, f"{wv.namespace}/fleet/done/{wv.global_rank}",
                     b"ok")
    except Exception:
        return
    if wv.global_rank != 0:
        return
    deadline = time.monotonic() + float(timeout_s)
    for m in wv.members:
        if m == wv.global_rank:
            continue
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        try:
            kv_get_bytes(client, f"{wv.namespace}/fleet/done/{m}",
                         remaining, site="fleet.kv_get", missing_rank=m)
        except Exception:
            pass          # best effort: a wedged peer must not trap rank 0
    coord_shutdown(client)
    # one beat of grace so peers' in-flight round trips drain before
    # the store goes away with this process
    time.sleep(0.2)


# ----------------------------------------------------------- KV helpers
def kv_set_bytes(client, key, data):
    """Store bytes, overwriting, padded to >= 2 bytes."""
    if len(data) < 2:
        data = bytes(data) + b"\x00" * (2 - len(data))
    client.key_value_set_bytes(key, bytes(data), allow_overwrite=True)


def kv_get_bytes(client, key, timeout_s=None, *, site="fleet.kv_get",
                 missing_rank=None, abort_if=None, config=None,
                 seed=None):
    """Deadline-bounded blocking get: store round trips of
    ``config.kv_slice_s`` under one deadline, seeded backoff between
    them (seed from the key's crc32, so a chaos run replays), and an
    ``abort_if()`` poll after each missed slice, never before the first
    try: data a peer published before dying is still returned. Raises
    :class:`CollectiveTimeout` naming ``missing_rank`` (or the key).

    Fault site ``fleet.kv_get``: ``exception`` raises before the first
    round trip, ``slow`` delays it."""
    config = config or get_config()
    timeout_s = (float(timeout_s) if timeout_s is not None
                 else config.collective_timeout_s)
    faultinject.fire(site, key=key, missing_rank=missing_rank)
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    rng = random.Random(seed if seed is not None
                        else zlib.crc32(key.encode()) & 0xffff)
    attempt = 0
    last_exc = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            exc = CollectiveTimeout(
                site, key=key, missing_rank=missing_rank,
                waited_s=time.monotonic() - t0, timeout_s=timeout_s,
                namespace=coord_namespace(), verdict="deadline")
            _record_timeout(exc)
            raise exc from last_exc
        slice_ms = max(1, int(min(remaining, config.kv_slice_s) * 1000))
        try:
            return client.blocking_key_value_get_bytes(key, slice_ms)
        except Exception as e:
            if abort_if is not None and abort_if():
                exc = CollectiveTimeout(
                    site, key=key, missing_rank=missing_rank,
                    waited_s=time.monotonic() - t0,
                    timeout_s=timeout_s, namespace=coord_namespace(),
                    verdict="dead-verdict")
                _record_timeout(exc)
                raise exc from e
            last_exc = e
            delay = min(compute_backoff(config.retry, min(attempt, 32),
                                        rng),
                        max(0.0, deadline - time.monotonic()))
            attempt += 1
            if delay > 0:
                time.sleep(delay)


def _record_timeout(exc):
    with obs.span("resilience.fleet.timeout", **exc.to_dict()):
        pass
    obs.registry().counter(
        "fleet_collective_timeouts_total", labels={"site": exc.site},
        help="coordination waits that exceeded their deadline").inc()


class LocalKVClient:
    """In-process stand-in for the coordination store (the same method
    subset and blocking semantics as the launcher's store client), so
    the fleet runs in rank-per-thread worlds with no server."""

    def __init__(self):
        self._data = {}
        self._cond = threading.Condition()

    def key_value_set(self, key, value, allow_overwrite=False):
        with self._cond:
            if key in self._data and not allow_overwrite:
                raise ValueError(f"key {key!r} already set")
            self._data[key] = str(value)
            self._cond.notify_all()

    def key_value_set_bytes(self, key, value, allow_overwrite=False):
        with self._cond:
            if key in self._data and not allow_overwrite:
                raise ValueError(f"key {key!r} already set")
            self._data[key] = bytes(value)
            self._cond.notify_all()

    def _blocking_get(self, key, timeout_in_ms):
        deadline = time.monotonic() + timeout_in_ms / 1000.0
        with self._cond:
            while key not in self._data:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._cond.wait(remaining):
                    if key not in self._data:
                        raise TimeoutError(
                            f"DEADLINE_EXCEEDED waiting for {key!r}")
            return self._data[key]

    def blocking_key_value_get(self, key, timeout_in_ms):
        return str(self._blocking_get(key, timeout_in_ms))

    def blocking_key_value_get_bytes(self, key, timeout_in_ms):
        v = self._blocking_get(key, timeout_in_ms)
        return v if isinstance(v, bytes) else str(v).encode()

    def key_value_dir_get(self, prefix):
        with self._cond:
            return sorted((k, str(v)) for k, v in self._data.items()
                          if k.startswith(prefix))

    def key_value_dir_get_bytes(self, prefix):
        with self._cond:
            return sorted(
                (k, v if isinstance(v, bytes) else str(v).encode())
                for k, v in self._data.items() if k.startswith(prefix))

    def key_value_delete(self, key):
        """Deletes ``key`` and every ``key/...`` below it."""
        with self._cond:
            for k in [k for k in self._data
                      if k == key or k.startswith(key.rstrip("/") + "/")]:
                del self._data[k]


# ----------------------------------------------------- heartbeat plane
class RankState(IntEnum):
    HEALTHY = 0
    SUSPECT = 1
    DEAD = 2


class HeartbeatPublisher:
    """One per rank: a daemon thread publishes
    ``<ns>/fleet/hb/<global_rank>`` every ``interval_s`` as JSON
    ``{"seq", "t", "progress"}`` (plus ``"telemetry"`` from
    ``payload_fn``, called outside the publisher lock; a failing
    ``payload_fn`` never suppresses the beat). The watchdog measures
    staleness by its own clock since it last saw ``seq`` advance, so
    clock skew cannot fake liveness. :meth:`beat` bumps ``progress``
    without waking the thread. The namespace is re-read every beat, so
    a reconfigure redirects beats.

    Fault site ``fleet.heartbeat``: an injected ``exception`` skips the
    beat (``missed_beats``); the thread survives."""

    def __init__(self, client=None, rank=None, interval_s=None,
                 world_fn=None, time_fn=time.time, payload_fn=None):
        self._client = client if client is not None else get_client()
        self._world_fn = world_fn or world
        self._rank = (int(rank) if rank is not None
                      else self._world_fn().global_rank)
        self._interval = (float(interval_s) if interval_s is not None
                          else get_config().heartbeat_interval_s)
        self._time = time_fn
        self._payload_fn = payload_fn
        self._lock = threading.Lock()
        self._seq = 0
        self._progress = 0
        self.missed_beats = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = None

    @property
    def rank(self):
        return self._rank

    @property
    def interval_s(self):
        return self._interval

    @property
    def seq(self):
        with self._lock:
            return self._seq

    @property
    def progress(self):
        with self._lock:
            return self._progress

    def start(self):
        if self._thread is None and self._client is not None:
            self._stop.clear()
            self._wake.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"paddle_tpu_torch-fleet-hb-{self._rank}")
            self._thread.start()
        return self

    def beat(self):
        """Record forward progress (``elastic.notify_progress()``)."""
        with self._lock:
            self._progress += 1

    def publish_once(self):
        """One beat, synchronously; returns whether it went out."""
        try:
            faultinject.fire("fleet.heartbeat", rank=self._rank)
        except faultinject.WorkerFault:
            with self._lock:
                self.missed_beats += 1
            return False
        now = self._time()
        telemetry = None
        if self._payload_fn is not None:
            try:
                telemetry = self._payload_fn()
            except Exception:
                telemetry = None    # liveness must not hinge on telemetry
        with self._lock:
            self._seq += 1
            payload = {"seq": self._seq, "t": now,
                       "progress": self._progress}
            if telemetry is not None:
                payload["telemetry"] = telemetry
        key = f"{coord_namespace()}/fleet/hb/{self._rank}"
        try:
            kv_set_bytes(self._client, key, json.dumps(payload).encode())
            return True
        except Exception:
            with self._lock:
                self.missed_beats += 1
            return False

    def _run(self):
        while not self._stop.is_set():
            self.publish_once()
            self._wake.wait(self._interval)
            self._wake.clear()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_publisher = None
_monitor = None


def install_publisher(pub):
    global _publisher
    with _world_lock:
        _publisher = pub
    return pub


def get_publisher():
    return _publisher


def notify_fleet_progress():
    """``distributed.elastic.notify_progress()`` forwards here."""
    pub = _publisher
    if pub is not None:
        pub.beat()


def install_monitor(mon):
    global _monitor
    with _world_lock:
        _monitor = mon
    return mon


def get_monitor():
    return _monitor


class FleetMonitor:
    """The fleet watchdog: reads every member's heartbeat key and
    classifies peers by the age (this monitor's clock) since their
    ``seq`` last advanced:

    - HEALTHY → SUSPECT past ``suspect_after_s``;
    - SUSPECT → DEAD past ``dead_after_s``;
    - SUSPECT → HEALTHY the moment a fresh ``seq`` lands;
    - DEAD is terminal for the generation.

    With ``progress_timeout_s``, beats whose ``progress`` is frozen that
    long demote a peer to SUSPECT. A failed store read changes no
    verdict (no evidence). :meth:`hold_verdict` caps a booting rank at
    SUSPECT; :meth:`mark_suspect` quarantines a rank on outside
    evidence (the digest vote). Every poll refreshes the
    ``fleet_rank_state{rank=}`` / ``fleet_last_heartbeat_age_s{rank=}``
    gauges; every transition records a ``resilience.fleet.transition``
    span; ``on_dead(ranks)`` fires outside the lock once per newly DEAD
    set."""

    def __init__(self, client=None, config=None, world_fn=None,
                 on_dead=None, time_fn=time.monotonic,
                 poll_interval_s=None):
        self._client = client if client is not None else get_client()
        self._config = config or get_config()
        self._world_fn = world_fn or world
        self.on_dead = on_dead
        self._time = time_fn
        self._poll_interval = (
            float(poll_interval_s) if poll_interval_s is not None
            else self._config.heartbeat_interval_s / 2.0)
        self._lock = threading.Lock()
        self._seen = {}      # rank -> (seq, progress, first_seen,
        #                               seq_local, progress_local)
        self._payloads = {}  # rank -> latest beat payload
        self._states = {}    # rank -> RankState
        self._quarantined = {}   # rank -> reason (sticky SUSPECT)
        self._holds = {}     # rank -> hold deadline (boot)
        self._dead_at = {}   # rank -> local time of the DEAD verdict
        self.transitions = []  # [(rank, old, new, age_s)]
        self._stop = threading.Event()
        self._thread = None

    # ---- classification ----
    def poll(self):
        """One watchdog pass; returns ``{global_rank: RankState}`` for
        the current world's members."""
        wv = self._world_fn()
        now = self._time()
        beats = {}
        try:
            pairs = self._client.key_value_dir_get_bytes(
                f"{coord_namespace()}/fleet/hb/")
        except Exception:
            with self._lock:
                return {r: self._states.get(r, RankState.HEALTHY)
                        for r in wv.members}
        for key, raw in pairs:
            try:
                r = int(key.rsplit("/", 1)[-1])
                beats[r] = json.loads(bytes(raw).decode())
            except (ValueError, json.JSONDecodeError):
                continue
        newly_dead = []
        events = []
        gauge_updates = []
        with self._lock:
            for r in wv.members:
                old = self._states.get(r, RankState.HEALTHY)
                seen = self._seen.get(r)
                b = beats.get(r)
                if b is not None:
                    self._payloads[r] = b
                    if seen is None or b["seq"] > seen[0]:
                        prog_local = (now if seen is None
                                      or b.get("progress", 0) > seen[1]
                                      else seen[4])
                        seen = (b["seq"], b.get("progress", 0),
                                seen[2] if seen else now, now, prog_local)
                    elif b.get("progress", 0) > seen[1]:
                        seen = (seen[0], b.get("progress", 0), seen[2],
                                seen[3], now)
                    self._seen[r] = seen
                elif seen is None:
                    seen = (0, 0, now, now, now)   # grace from first look
                    self._seen[r] = seen
                age = now - seen[3]
                new = self._classify(old, age, now - seen[4])
                hold = self._holds.get(r)
                if hold is not None:
                    if now >= hold:
                        self._holds.pop(r, None)
                    elif new is RankState.DEAD:
                        new = RankState.SUSPECT
                if r in self._quarantined and new is not RankState.DEAD:
                    new = RankState.SUSPECT
                if new is not old:
                    self._states[r] = new
                    self.transitions.append((r, old, new, age))
                    events.append((r, old, new, age))
                    if new is RankState.DEAD:
                        newly_dead.append(r)
                        self._dead_at[r] = now
                elif r not in self._states:
                    self._states[r] = new
                gauge_updates.append((r, self._states[r], age))
            states = {r: self._states[r] for r in wv.members}
        for upd in gauge_updates:
            self._set_gauges(*upd)
        for evt in events:
            self._record(*evt)
        if newly_dead and self.on_dead is not None:
            try:
                self.on_dead(sorted(newly_dead))
            except Exception:
                pass
        return states

    def _classify(self, old, age, progress_age):
        if old is RankState.DEAD:
            return old
        if age > self._config.dead_after_s and old is RankState.SUSPECT:
            return RankState.DEAD
        if age > self._config.suspect_after_s:
            return RankState.SUSPECT
        pt = self._config.progress_timeout_s
        if pt is not None and progress_age > pt:
            return RankState.SUSPECT
        return RankState.HEALTHY

    def states(self):
        with self._lock:
            return dict(self._states)

    def dead_ranks(self):
        with self._lock:
            return sorted(r for r, s in self._states.items()
                          if s is RankState.DEAD)

    def dead_at(self, rank):
        """This monitor's clock reading when ``rank`` was held DEAD, or
        None."""
        with self._lock:
            return self._dead_at.get(int(rank))

    def last_seq_at(self, rank):
        """This monitor's clock reading when it last saw ``rank``'s
        ``seq`` advance, or None."""
        with self._lock:
            seen = self._seen.get(int(rank))
        return None if seen is None else seen[3]

    def is_dead(self, rank):
        with self._lock:
            return self._states.get(rank) is RankState.DEAD

    def telemetry(self, rank):
        """The latest beat's ``telemetry`` dict for ``rank``, or None."""
        with self._lock:
            b = self._payloads.get(int(rank))
        if b is None:
            return None
        t = b.get("telemetry")
        return dict(t) if isinstance(t, dict) else None

    # ---- external quarantine (digest vote) ----
    def mark_suspect(self, rank, reason=None):
        """Quarantine ``rank`` at SUSPECT on outside evidence; sticky
        until :meth:`clear_suspect` (DEAD still supersedes)."""
        rank = int(rank)
        evt = None
        with self._lock:
            self._quarantined[rank] = str(reason or "quarantined")
            old = self._states.get(rank, RankState.HEALTHY)
            if old not in (RankState.SUSPECT, RankState.DEAD):
                self._states[rank] = RankState.SUSPECT
                evt = (rank, old, RankState.SUSPECT, 0.0)
                self.transitions.append(evt)
        if evt is not None:
            self._set_gauges(rank, RankState.SUSPECT, 0.0)
            self._record(*evt)
        return RankState.SUSPECT

    def clear_suspect(self, rank):
        with self._lock:
            self._quarantined.pop(int(rank), None)

    def hold_verdict(self, rank, for_s):
        """Cap ``rank`` at SUSPECT for ``for_s`` seconds (a boot's
        silence is sanctioned; DEAD is terminal)."""
        deadline = self._time() + float(for_s)
        with self._lock:
            self._holds[int(rank)] = deadline

    def release_verdict_hold(self, rank):
        """End a hold and restart the rank's staleness clock."""
        rank = int(rank)
        now = self._time()
        with self._lock:
            self._holds.pop(rank, None)
            seen = self._seen.get(rank)
            if seen is not None:
                self._seen[rank] = (seen[0], seen[1], seen[2], now, now)

    def suspect_ranks(self):
        with self._lock:
            return sorted(r for r, s in self._states.items()
                          if s is RankState.SUSPECT)

    def quarantined_ranks(self):
        with self._lock:
            return sorted(self._quarantined)

    # ---- telemetry ----
    def _set_gauges(self, rank, state, age):
        reg = obs.registry()
        reg.gauge("fleet_rank_state", labels={"rank": str(rank)},
                  help="fleet watchdog verdict per rank "
                       "(0=HEALTHY 1=SUSPECT 2=DEAD)").set(int(state))
        reg.gauge("fleet_last_heartbeat_age_s", labels={"rank": str(rank)},
                  help="seconds since this rank's heartbeat seq "
                       "last advanced").set(round(max(0.0, age), 3))

    def _record(self, rank, old, new, age):
        with obs.span("resilience.fleet.transition", rank=rank,
                      from_state=old.name, to_state=new.name,
                      age_s=round(age, 3)):
            pass
        obs.registry().counter(
            "fleet_rank_transitions_total", labels={"to": new.name},
            help="fleet watchdog state transitions").inc()

    # ---- optional thread ----
    def start(self):
        if self._thread is None and self._client is not None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="paddle_tpu_torch-fleet-watchdog")
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self._poll_interval):
            try:
                self.poll()
            except Exception:
                pass       # outlive transient store errors

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ------------------------------------------- distributed checkpointing
_FLEET_FORMAT = "fleet-1"


def _tree_map(fn, *trees):
    """``fn`` over the leaves of structurally equal dict / list / tuple
    trees (dicts by key, in the first tree's order)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *leaves)
                           for leaves in zip(*trees))
    return fn(*trees)


class DistributedCheckpointer:
    """Sharded, quorum-committed, reshardable checkpoints.

    ``save(step, sharded=..., replicated=...)`` is collective: every
    fleet rank writes its own shard (``step-<step>/shard-<rank>-of-
    <size>.pkl``, a pickle of numpy leaves, through
    ``framework.io.write_atomic``: the ``io.save`` fault site) and
    publishes its sha256 through the store; fleet rank 0 gathers every
    digest under one deadline (a DEAD verdict aborts it) and commits the
    MANIFEST entry; the others wait for the commit marker, so a returned
    ``save()`` is durable fleet-wide. ``sharded`` leaves are arrays
    whose axis 0 is the dp axis; ``load(world_size=W)`` stacks every
    verified shard and re-splits it in W parts. ``replicated`` state is
    stored once, in rank 0's shard. An entry restores only if every
    shard verifies; a torn shard fails the entry and ``load()`` falls
    back to the previous one. Shard bytes, digests and manifest keys
    are the reference's for the same numpy inputs."""

    def __init__(self, directory, keep=3, client=None, world=None,
                 timeout_s=None, mesh_spec=None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep)
        self._client = client if client is not None else get_client()
        self._world = world
        self._timeout_s = timeout_s
        self.mesh_spec = mesh_spec
        self._lock = threading.Lock()
        # per-instance save round: the same round id names the same
        # collective save fleet-wide and versions its keys
        self._save_round = 0

    def _wv(self):
        return self._world if self._world is not None else world()

    def _timeout(self):
        return (self._timeout_s if self._timeout_s is not None
                else get_config().collective_timeout_s)

    def _shard_file(self, step, rank, size):
        return os.path.join(f"step-{int(step):08d}",
                            f"shard-{rank:05d}-of-{size:05d}.pkl")

    def save(self, step, sharded=None, replicated=None):
        """Collective checkpoint at ``step``; returns the manifest path
        once the entry is committed fleet-wide."""
        from paddle_tpu_torch.framework import io as fio
        wv = self._wv()
        t0 = time.perf_counter()
        payload = {"rank": wv.rank, "world_size": wv.size,
                   "sharded": fio.to_numpy(sharded)}
        if wv.rank == 0:
            payload["replicated"] = fio.to_numpy(replicated)
        data = pickle.dumps(payload, protocol=4)
        rel = self._shard_file(step, wv.rank, wv.size)
        path = os.path.join(self.directory, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fio.write_atomic(path, data)
        entry = {"rank": wv.rank, "file": rel, "bytes": len(data),
                 "sha256": digest_bytes(data)}
        if wv.size == 1:
            self._commit(step, wv, [entry])
        elif self._client is None:
            raise RuntimeError(
                "distributed save at world size > 1 needs a coordination "
                "client (the launcher's store or a shared LocalKVClient)")
        else:
            self._save_round += 1
            base = (f"{coord_namespace()}/fleet/ckpt/"
                    f"r{self._save_round}/{int(step)}")
            kv_set_bytes(self._client, f"{base}/{wv.rank}",
                         json.dumps(entry).encode())
            if wv.rank == 0:
                shards = [entry]
                mon = get_monitor()
                gather_deadline = time.monotonic() + self._timeout()
                for peer in range(1, wv.size):
                    g = wv.members[peer]
                    raw = kv_get_bytes(
                        self._client, f"{base}/{peer}",
                        max(0.001, gather_deadline - time.monotonic()),
                        site="fleet.kv_get", missing_rank=g,
                        abort_if=(None if mon is None
                                  else lambda g=g: mon.is_dead(g)))
                    shards.append(json.loads(raw.decode()))
                # every peer published round r only after it read round
                # r-1's commit marker: round r-1's keys are consumed
                if self._save_round > 1:
                    try:
                        self._client.key_value_delete(
                            f"{coord_namespace()}/fleet/ckpt/"
                            f"r{self._save_round - 1}")
                    except Exception:
                        pass
                self._commit(step, wv, shards)
                kv_set_bytes(self._client, f"{base}/committed", b"ok")
            else:
                kv_get_bytes(self._client, f"{base}/committed",
                             self._timeout(), site="fleet.kv_get",
                             missing_rank=wv.members[0])
        obs.registry().counter(
            "fleet_checkpoint_saves_total",
            help="distributed checkpoint save() calls").inc()
        with obs.span("resilience.fleet.ckpt.save", step=int(step),
                      rank=wv.rank, world_size=wv.size, bytes=len(data),
                      save_ms=round((time.perf_counter() - t0) * 1e3, 3)):
            pass
        return os.path.join(self.directory, _MANIFEST)

    def _commit(self, step, wv, shards):
        """Rank 0 only: the quorum entry and retention, one atomic
        manifest rewrite; pruned payload directories deleted after."""
        with self._lock:
            manifest = read_manifest(self.directory, fmt=_FLEET_FORMAT)
            ckpts = [c for c in manifest.get("checkpoints", ())
                     if c["step"] != int(step)]
            ckpts.append({
                "step": int(step),
                "world_size": wv.size,
                "members": list(wv.members),
                "generation": wv.generation,
                "mesh": self.mesh_spec,
                "shards": sorted(shards, key=lambda s: s["rank"]),
                "time_utc": time.strftime("%Y-%m-%d %H:%M:%S UTC",
                                          time.gmtime()),
            })
            ckpts.sort(key=lambda c: c["step"])
            drop, ckpts = ckpts[:-self.keep], ckpts[-self.keep:]
            write_manifest(self.directory, {"format": _FLEET_FORMAT,
                                            "checkpoints": ckpts})
            for c in drop:
                d = os.path.join(self.directory,
                                 f"step-{int(c['step']):08d}")
                for s in c.get("shards", ()):
                    try:
                        os.remove(os.path.join(self.directory, s["file"]))
                    except OSError:
                        pass
                try:
                    os.rmdir(d)
                except OSError:
                    pass

    def steps(self):
        man = read_manifest(self.directory, fmt=_FLEET_FORMAT)
        return [c["step"] for c in man["checkpoints"]]

    def _verify_entry(self, entry):
        """All or nothing: ``{rank: payload bytes}`` when the shard list
        covers every rank of the recorded world and every shard has its
        manifested size and digest, else None."""
        shards = entry.get("shards")
        world_size = entry.get("world_size")
        if not isinstance(shards, list) or world_size is None:
            return None
        out = {}
        try:
            if sorted(s["rank"] for s in shards) != list(range(world_size)):
                return None
            for s in shards:
                path = os.path.join(self.directory, s["file"])
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    return None
                if (len(data) != s["bytes"]
                        or digest_bytes(data) != s["sha256"]):
                    return None
                out[s["rank"]] = data
        except (KeyError, TypeError):
            return None
        return out

    def load(self, step=None, world_size=None, rank=None, strict=False):
        """The newest fully verified entry (or exactly ``step``),
        resharded for ``world_size`` (default the current world):
        ``(step, {"sharded", "replicated", "world_size": saved})`` or
        None. Skipped torn entries are recorded as a recovery."""
        wv = self._wv()
        world_size = int(world_size) if world_size is not None \
            else wv.size
        rank = int(rank) if rank is not None else wv.rank
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world {world_size}")
        entries = read_manifest(self.directory,
                                fmt=_FLEET_FORMAT)["checkpoints"]
        if step is not None:
            entries = [c for c in entries if c["step"] == int(step)]
        skipped = 0
        for entry in reversed(entries):
            blobs = self._verify_entry(entry)
            if blobs is None:
                skipped += 1
                obs.registry().counter(
                    "fleet_checkpoint_corrupt_total",
                    help="distributed checkpoint entries that failed "
                         "shard digest verification").inc()
                continue
            if skipped:
                faultinject.note_recovery(
                    "io.save", "torn_write", fallback_step=entry["step"],
                    skipped=skipped, distributed=True)
            payloads = {r: pickle.loads(b) for r, b in blobs.items()}
            sharded = self._reshard(entry, payloads, world_size, rank)
            state = {"sharded": sharded,
                     "replicated": payloads[0].get("replicated"),
                     "world_size": entry["world_size"]}
            with obs.span("resilience.fleet.ckpt.load",
                          step=entry["step"], skipped=skipped,
                          saved_world=entry["world_size"],
                          world_size=world_size):
                return entry["step"], state
        if strict and entries:
            raise CheckpointCorruption(
                f"all {len(entries)} distributed manifest entries under "
                f"{self.directory} failed verification")
        return None

    @staticmethod
    def _reshard(entry, payloads, world_size, rank):
        """Stack every saved shard's leaves along axis 0 (saved rank
        order) and slice the new rank's equal part."""
        shards = [payloads[r]["sharded"]
                  for r in range(entry["world_size"])]
        if shards[0] is None:
            return None

        def merge(*leaves):
            if not all(isinstance(v, np.ndarray) for v in leaves):
                if len(set(map(repr, leaves))) == 1:
                    return leaves[0]
                raise TypeError(
                    "sharded checkpoint leaves must be arrays (dp axis "
                    f"0); got {[type(v).__name__ for v in leaves]}")
            total = np.concatenate(leaves, axis=0)
            if total.shape[0] % world_size:
                raise ValueError(
                    f"cannot reshard axis-0 length {total.shape[0]} "
                    f"into {world_size} equal parts")
            per = total.shape[0] // world_size
            return total[rank * per:(rank + 1) * per]

        return _tree_map(merge, *shards)


# --------------------------------------------- elastic reconfiguration
def reconfigure(dead_ranks, client=None, config=None, world_view=None,
                install=True, reap=None):
    """Re-form the fleet without ``dead_ranks``: bump the generation,
    re-rendezvous the survivors under the fresh namespace (one shared
    join deadline; each join marker carries its proposed member list,
    and a mismatch raises rather than installing two worlds), reap the
    old generation's keys (``reap``, default ``install``) and install
    the shrunk :class:`WorldView`. Returns the new view.
    ``world_view`` / ``install=False`` serve rank-per-thread worlds."""
    config = config or get_config()
    client = client if client is not None else get_client()
    old = world_view if world_view is not None else world()
    dead = {int(r) for r in dead_ranks}
    if old.global_rank in dead:
        raise ValueError(
            f"this rank ({old.global_rank}) is in the dead set {dead}")
    survivors = [m for m in old.members if m not in dead]
    if not dead & set(old.members):
        raise ValueError(f"dead ranks {sorted(dead)} not in world "
                         f"{old.members}")
    t0 = time.perf_counter()
    new = WorldView(survivors, old.global_rank,
                    generation=old.generation + 1,
                    launch_id=old.launch_id)
    ns = new.namespace
    if client is not None and new.size > 1:
        proposal = json.dumps(list(new.members)).encode()
        kv_set_bytes(client, f"{ns}/fleet/join/{old.global_rank}", proposal)
        mon = get_monitor()
        join_deadline = time.monotonic() + config.rendezvous_timeout_s
        for peer in survivors:
            if peer == old.global_rank:
                continue
            raw = kv_get_bytes(client, f"{ns}/fleet/join/{peer}",
                               max(0.001, join_deadline - time.monotonic()),
                               site="fleet.kv_get", missing_rank=peer,
                               abort_if=(None if mon is None
                                         else (lambda p=peer:
                                               mon.is_dead(p))),
                               config=config)
            theirs = json.loads(raw.decode())
            if tuple(theirs) != new.members:
                raise RuntimeError(
                    f"fleet reconfigure split-brain: rank "
                    f"{old.global_rank} proposes members "
                    f"{list(new.members)} but rank {peer} proposes "
                    f"{theirs} (divergent DEAD verdicts); refusing to "
                    f"install generation {new.generation}: restart the "
                    f"job")
    if install:
        _set_world(new)
        # a fresh namespace: fresh round counters for the eager
        # store collectives
        from paddle_tpu_torch.distributed import collective
        collective.reset_coord_rounds()
    reap = install if reap is None else reap
    if reap and client is not None and new.rank == 0:
        try:
            client.key_value_delete(old.namespace)
        except Exception:
            pass
    elapsed_ms = round((time.perf_counter() - t0) * 1e3, 3)
    reg = obs.registry()
    reg.gauge("fleet_world_size", help="current fleet world size").set(
        new.size)
    reg.gauge("fleet_generation",
              help="fleet reconfiguration generation").set(new.generation)
    reg.counter("fleet_reconfigures_total",
                help="elastic fleet reconfigurations").inc()
    with obs.span("resilience.fleet.reconfigure", dead=sorted(dead),
                  world_size=new.size, generation=new.generation,
                  reconfigure_ms=elapsed_ms):
        pass
    return new


def _reset_for_tests():
    """Drop the installed world, client, publisher, monitor and launch
    id."""
    global _world, _publisher, _monitor
    with _world_lock:
        _world = None
        _publisher = None
        _monitor = None
        _launch_id[0] = None
        _installed_client[0] = None
        _finalized[0] = False
