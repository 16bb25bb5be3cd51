"""Deterministic fault injection (counterpart of
``paddle_tpu/resilience/faultinject.py``): seeded fault plans over named
hook sites.

A fault plan is data (a JSON-able list of :class:`FaultSpec`), and
execution is deterministic: faults match on the per-site occurrence
counter, never on the wall clock or a free-running generator.

Hook sites of the port:

=====================  ====================================================
site                   where / kinds
=====================  ====================================================
``optimizer.step``     ``Optimizer.step``: ``exception``
``optimizer.grads``    ``Optimizer.step``'s gradient intake: ``bitflip``
                       flips one bit of one gradient element, ``nan_grad``
                       makes one element NaN; both through
                       :func:`corrupt_array`, deterministic on (plan
                       seed, spec), aimed at ``payload["param"]`` by
                       name (default: the first parameter with a
                       gradient)
``io.save``            ``framework/io.py:write_atomic``: ``torn_write``
                       (truncate the payload, or skip the rename),
                       ``exception``
``io.manifest``        checkpoint manifest rewrites (same writer, its own
                       occurrence counter)
``serving.traffic.``   the traffic driver's every tick
``tick``               (``serving/traffic/driver.py``): ``qps_surge``
                       injects ``payload["requests"]`` extra arrivals
``fleet.heartbeat``    ``resilience/fleet.py``'s heartbeat publisher beat:
                       ``exception`` (the beat is skipped, counted in
                       ``missed_beats``; the thread survives), ``slow``
``fleet.kv_get``       every timeout-bounded coordination get
                       (``fleet.kv_get_bytes``): ``exception``, ``slow``
``fleet.rank_kill``    a worker's per-step hook: ``rank_kill`` sends a real
                       SIGKILL to the calling process
``serving.fleet.step`` a serving replica's step (``serving/fleet/
                       server.py``): ``rank_kill`` (a dead host),
                       ``wedge`` (a real SIGSTOP of the whole process:
                       alive to the OS, silent to the fleet;
                       ``payload["park_s"]`` parks only the calling
                       thread that long), ``exception``, ``slow``
=====================  ====================================================

Under ``to_static`` the hooks fire as the reference's trace-time hooks
do: only while a signature is built, as often as the reference traces
it (twice when its first call registers state, such as lazy
accumulators or the RNG key, else once), and never on a cached call or
a replay. ``jit/api.py`` silences the other calls with :func:`quiet`
and takes a discovery call's firings back with :func:`mark` and
:func:`rewind`. ``dygraph_function`` fires once a call.

Generic kinds execute in :func:`fire` itself, as the reference's do:
``exception`` raises :class:`WorkerFault`, ``slow`` sleeps
``payload["sleep_s"]`` (default 0.01) and ``preempt`` calls
:func:`~paddle_tpu_torch.resilience.preemption.request_preemption` on
the installed handler, ``rank_kill`` flushes stdout and stderr and
sends the process a real SIGKILL, and ``wedge`` a real SIGSTOP (or,
with ``payload["park_s"]``, sleeps the calling thread that long).

Every injection records a ``resilience.fault`` span and bumps
``resilience_faults_injected_total{site,kind}``; every recovery
(:func:`note_recovery`) a ``resilience.recovery`` span and
``resilience_recoveries_total{site,kind}``, in
:mod:`paddle_tpu_torch.observability`. An injector also keeps its own
log (``injected``, ``recovered``).

Usage::

    plan = FaultPlan([FaultSpec("optimizer.grads", "nan_grad", at=6)],
                     seed=0)
    with FaultInjector(plan):
        train()
"""
from __future__ import annotations

import contextlib
import os
import random
import signal
import sys
import threading
import time

import torch

from paddle_tpu_torch import observability as obs

__all__ = [
    "FaultInjector", "FaultPlan", "FaultSpec", "WorkerFault",
    "active_plan", "corrupt_array", "fire", "install", "mark",
    "note_recovery", "quiet", "rewind", "uninstall",
]

KINDS = ("torn_write", "exception", "preempt", "pool_exhaust", "slow",
         "rank_kill", "wedge", "bitflip", "nan_grad", "qps_surge")


class WorkerFault(RuntimeError):
    """The exception an ``exception``-kind fault raises, with the site
    and the spec's payload."""

    def __init__(self, site, spec, **ctx):
        self.site = site
        self.spec = spec
        self.ctx = dict(ctx)
        super().__init__(
            f"injected fault at {site!r} (kind={spec.kind}, "
            f"occurrence={spec.at})")


class FaultSpec:
    """One fault: WHERE (site), WHAT (kind), WHEN (occurrence index).

    - ``at``: 0-based occurrence index at the site; the fault fires on
      occurrences ``[at, at + times)``;
    - ``payload``: kind-specific knobs (``bitflip``/``nan_grad``:
      ``param``, ``index``, ``bit``; ``torn_write``: ``keep_fraction``).
    """

    def __init__(self, site, kind, at=0, times=1, payload=None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; one of {KINDS}")
        if at < 0 or times < 1:
            raise ValueError("at must be >= 0 and times >= 1")
        self.site = str(site)
        self.kind = str(kind)
        self.at = int(at)
        self.times = int(times)
        self.payload = dict(payload) if payload else {}

    def matches(self, occurrence):
        return self.at <= occurrence < self.at + self.times

    def to_dict(self):
        return {"site": self.site, "kind": self.kind, "at": self.at,
                "times": self.times, "payload": dict(self.payload)}

    @classmethod
    def from_dict(cls, d):
        return cls(d["site"], d["kind"], d.get("at", 0),
                   d.get("times", 1), d.get("payload"))

    def __repr__(self):
        return (f"FaultSpec({self.site!r}, {self.kind!r}, at={self.at}, "
                f"times={self.times})")


class FaultPlan:
    """An ordered, seeded collection of faults (specs, or their dicts).
    The seed anchors :func:`corrupt_array`'s choice of element and bit."""

    def __init__(self, faults=(), seed=0, name="fault-plan"):
        self.faults = [f if isinstance(f, FaultSpec)
                       else FaultSpec.from_dict(f) for f in faults]
        self.seed = int(seed)
        self.name = str(name)

    def faults_for(self, site):
        return [f for f in self.faults if f.site == site]

    def to_dict(self):
        """The plan as data (the reference's schema): what a traffic
        spec's ``fault_plan`` holds."""
        return {"name": self.name, "seed": self.seed,
                "faults": [f.to_dict() for f in self.faults]}

    @classmethod
    def from_dict(cls, d):
        return cls(d.get("faults", ()), d.get("seed", 0),
                   d.get("name", "fault-plan"))

    def __repr__(self):
        return (f"FaultPlan({self.name!r}, seed={self.seed}, "
                f"{len(self.faults)} faults)")


class FaultInjector:
    """Installs a :class:`FaultPlan` for the duration of a ``with``
    block. Keeps per-site occurrence counters, a log of every injection
    (``injected``: ``(site, spec, occurrence)``) and of every recovery
    (``recovered``: ``(site, kind, attrs)``)."""

    def __init__(self, plan):
        self.plan = plan
        self._counts = {}
        self._lock = threading.Lock()
        self.injected = []
        self.recovered = []

    def poll(self, site):
        """Advance the site's occurrence counter; return the matching
        FaultSpec (logged and recorded) or None."""
        hit = None
        with self._lock:
            occ = self._counts.get(site, 0)
            self._counts[site] = occ + 1
            for spec in self.plan.faults_for(site):
                if spec.matches(occ):
                    self.injected.append((site, spec, occ))
                    hit = spec
                    break
        if hit is not None:
            # telemetry outside the lock: spans and counters take their
            # own locks
            _record_injection(self.plan, site, hit, occ)
        return hit

    def occurrences(self, site):
        """How often ``site``'s hook has fired under this injector."""
        with self._lock:
            return self._counts.get(site, 0)

    def __enter__(self):
        install(self)
        return self

    def __exit__(self, *exc):
        uninstall(self)
        return False


_active = None
_active_lock = threading.Lock()
_quiet = threading.local()


@contextlib.contextmanager
def quiet():
    """No hook fires, or counts, on this thread in the block."""
    _quiet.depth = getattr(_quiet, "depth", 0) + 1
    try:
        yield
    finally:
        _quiet.depth -= 1


def mark():
    """Where the installed injector's counters and log stand (None
    without one), for :func:`rewind`."""
    inj = _active
    if inj is None:
        return None
    with inj._lock:
        return inj, dict(inj._counts), len(inj.injected)


def rewind(where):
    """Take back every firing since :func:`mark` gave ``where``: the
    counters and the log go back to it."""
    if where is None:
        return
    inj, counts, logged = where
    with inj._lock:
        inj._counts = counts
        del inj.injected[logged:]


def install(injector):
    global _active
    with _active_lock:
        if _active is not None:
            raise RuntimeError("a FaultInjector is already installed "
                               "(nesting fault plans is not supported)")
        _active = injector
    return injector


def uninstall(injector=None):
    global _active
    with _active_lock:
        if injector is not None and _active is not injector:
            return
        _active = None


def active_plan():
    inj = _active
    return inj.plan if inj is not None else None


def fire(site, **ctx):
    """The one-line hook of a call site. Returns None when no plan is
    installed or no fault is due at this occurrence; raises
    :class:`WorkerFault` for an ``exception`` fault; sleeps for ``slow``
    and requests a preemption for ``preempt`` (returning the spec);
    SIGKILLs the process for ``rank_kill``; SIGSTOPs it, or parks the
    calling thread ``payload["park_s"]``, for ``wedge``; returns the spec
    of a site-specific kind (``bitflip``, ``nan_grad``, ``torn_write``,
    ...) for the caller to apply."""
    inj = _active
    if inj is None or getattr(_quiet, "depth", 0):
        return None
    spec = inj.poll(site)
    if spec is None:
        return None
    if spec.kind == "exception":
        raise WorkerFault(site, spec, **ctx)
    if spec.kind == "slow":
        time.sleep(float(spec.payload.get("sleep_s", 0.01)))
    elif spec.kind == "preempt":
        from paddle_tpu_torch.resilience import preemption
        preemption.request_preemption(reason=f"injected at {site}")
    elif spec.kind == "rank_kill":
        # the dead-host fault: an unhandleable SIGKILL, no atexit, no
        # drain; the flushed output is the process's last testimony
        sys.stderr.flush()
        sys.stdout.flush()
        os.kill(os.getpid(), signal.SIGKILL)
    elif spec.kind == "wedge":
        # the wedged-host fault: alive to the OS, silent to the fleet
        # (every thread stops, the heartbeat publisher's too), so only
        # the watchdog's DEAD verdict unblocks the fleet
        park_s = spec.payload.get("park_s")
        if park_s is not None:
            time.sleep(float(park_s))
        else:
            sys.stderr.flush()
            sys.stdout.flush()
            os.kill(os.getpid(), signal.SIGSTOP)
    return spec


def corrupt_array(spec, value, seed=0, occurrence=0):
    """Apply a ``bitflip`` / ``nan_grad`` spec to one element of the
    tensor ``value``; returns a copy in its own float type (f32 or f64;
    other types corrupt through f32), every other element bit-identical.

    The element and the bit are the reference's, bit for bit:
    ``payload["index"]`` / ``payload["bit"]`` when given, else from
    ``random.Random(seed * 1000003 + spec.at * 101 + occurrence)``; a
    bitflip defaults to the high exponent bit (30 for f32, 62 for f64).
    """
    if spec.kind not in ("bitflip", "nan_grad"):
        raise ValueError(f"corrupt_array cannot apply kind {spec.kind!r}")
    value = torch.as_tensor(value)
    dtype = value.dtype if value.dtype in (torch.float32, torch.float64) \
        else torch.float32
    out = value.detach().to(dtype=dtype, copy=True)
    flat = out.reshape(-1)
    if flat.numel() == 0:
        return out
    rng = random.Random(int(seed) * 1000003
                        + int(spec.at) * 101 + int(occurrence))
    idx = int(spec.payload.get("index", rng.randrange(flat.numel())))
    idx %= flat.numel()
    if spec.kind == "nan_grad":
        flat[idx] = float("nan")
    else:
        width = 32 if dtype == torch.float32 else 64
        words = flat.view(torch.int32 if width == 32 else torch.int64)
        bit = int(spec.payload.get("bit", width - 2)) % width
        mask = 1 << bit
        if bit == width - 1:
            mask -= 1 << width               # the sign bit, as a signed word
        words[idx] ^= mask
    return out


def _record_injection(plan, site, spec, occurrence):
    try:
        with obs.span("resilience.fault", site=site, kind=spec.kind,
                      occurrence=occurrence, plan=plan.name,
                      seed=plan.seed):
            pass
        obs.registry().counter(
            "resilience_faults_injected_total",
            labels={"site": site, "kind": spec.kind},
            help="faults injected by the chaos harness").inc()
    except Exception:
        # fault injection must never be broken by telemetry teardown
        # ordering (e.g. interpreter shutdown)
        pass


def note_recovery(site, kind, **attrs):
    """Record a recovery from a (possibly injected) fault: a
    ``resilience.recovery`` span, ``resilience_recoveries_total
    {site,kind}``, and the active injector's ``recovered`` log."""
    inj = _active
    if inj is not None:
        with inj._lock:
            inj.recovered.append((site, kind, dict(attrs)))
    try:
        with obs.span("resilience.recovery", site=site, kind=kind,
                      **attrs):
            pass
        obs.registry().counter(
            "resilience_recoveries_total",
            labels={"site": site, "kind": kind},
            help="successful recoveries from faults").inc()
    except Exception:
        pass
