"""Training sentinel (counterpart of ``paddle_tpu/resilience/sentinel.py``):
the anomaly record, the guard probe's summary and the skip/rollback
policy machine.

``to_static(guard=True)`` and ``Optimizer(guard=True)`` compute a
per-step probe on the device: the loss with its finite flag, the global
gradient sum of squares and the count of gradient regions that were not
finite (whose update the optimizer did not commit). The
:class:`TrainingSentinel` turns the probe stream into actions: an
anomaly is an :class:`AnomalyDetected` record and a SKIP; ``skip_limit``
anomalies in a row roll the model and the optimizer back to the last
good checkpoint with an LR cooldown.

Localization: :class:`BatchLineage` records each step's (seed, batch)
lineage, and :func:`replay_bisect` / :func:`localize_poison` binary-
search a deterministic replay from the last good checkpoint to name the
poison step in ``O(log n)`` replays.

Digests: :func:`tree_digest` is the reference's sha256 over a tree of
tensors and arrays, byte for byte (a bf16 leaf is spelled ``bfloat16``
with its 2-byte payload, as numpy's bf16 extension type writes it), so
ranks of both packages can compare digests. :func:`digest_vote` votes
across the fleet's ranks through its coordination store and names a
dissenting rank SDC-suspect.

Telemetry (:mod:`paddle_tpu_torch.observability`), as the reference's:
``sentinel_anomaly_total{kind,site}`` and the
``resilience.sentinel.anomaly`` span for every anomaly any detector
notes, ``sentinel_skips_total``, ``sentinel_rollbacks_total`` and the
``resilience.sentinel.rollback`` span, the ``sentinel_last_good_step``
gauge, and the vote's span and counters.
"""
from __future__ import annotations

import enum
import hashlib
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from paddle_tpu_torch import observability as obs

__all__ = ["AnomalyDetected", "BatchLineage", "DigestVote", "GuardSummary",
           "SentinelAction", "TrainingSentinel", "current", "digest_vote",
           "install", "localize_poison", "note_anomaly", "replay_bisect",
           "tree_digest", "uninstall"]

class AnomalyDetected(RuntimeError):
    """A machine-readable anomaly: WHEN (step), WHAT (kind), WHERE
    (site), with kind-specific context. Recorded on
    ``TrainingSentinel.anomalies``; raised only where a caller opts in."""

    def __init__(self, step, kind, site="train", **ctx):
        self.step = int(step) if step is not None else None
        self.kind = str(kind)
        self.site = str(site)
        self.ctx = dict(ctx)
        super().__init__(
            f"anomaly at step {self.step}: kind={self.kind} "
            f"site={self.site}"
            + (f" {self.ctx}" if self.ctx else ""))

    def to_dict(self):
        return {"step": self.step, "kind": self.kind, "site": self.site,
                **self.ctx}


def note_anomaly(kind, site, step=None, **ctx):
    """The one place every detector records an anomaly through (so
    ``sentinel_anomaly_total{kind,site}`` and the
    ``resilience.sentinel.anomaly`` spans are complete); returns the
    :class:`AnomalyDetected` record."""
    evt = AnomalyDetected(step, kind, site, **ctx)
    try:
        with obs.span("resilience.sentinel.anomaly", step=evt.step,
                      kind=evt.kind, site=evt.site):
            pass
        obs.registry().counter(
            "sentinel_anomaly_total",
            labels={"kind": evt.kind, "site": evt.site},
            help="anomalies detected by the training sentinel").inc()
    except Exception:
        pass
    return evt


class GuardSummary:
    """A guarded step's probe, ``[good, grad_sumsq, bad_regions,
    regions]``: ``good`` is the global verdict (every gradient region
    finite), ``grad_sumsq`` the f32 global sum of squared gradients (its
    sqrt the grad norm), ``bad_regions``/``regions`` the gated regions
    (whole parameters on the unfused path, kernel row blocks on the
    fused one) that committed no update, and all of them."""

    __slots__ = ("good", "grad_sumsq", "bad_regions", "regions")

    def __init__(self, good, grad_sumsq, bad_regions, regions):
        self.good = bool(good)
        self.grad_sumsq = float(grad_sumsq)
        self.bad_regions = int(bad_regions)
        self.regions = int(regions)

    @classmethod
    def from_array(cls, arr):
        a = np.asarray(arr, np.float64).reshape(-1)
        if a.size < 4:
            raise ValueError(f"guard summary needs 4 slots, got {a.size}")
        return cls(a[0] >= 0.5, a[1], int(a[2]), int(a[3]))

    @property
    def grad_norm(self):
        return float(np.sqrt(self.grad_sumsq)) \
            if np.isfinite(self.grad_sumsq) and self.grad_sumsq >= 0 \
            else float(self.grad_sumsq)

    def __repr__(self):
        return (f"GuardSummary(good={self.good}, "
                f"grad_sumsq={self.grad_sumsq:.6g}, "
                f"bad_regions={self.bad_regions}/{self.regions})")


class SentinelAction(enum.IntEnum):
    OK = 0
    SKIP = 1
    ROLLBACK = 2


class TrainingSentinel:
    """The skip/rollback policy machine over the probe stream.

    ``observe(step, loss=..., summary=...)`` classifies the step:

    - summary verdict bad (gated regions)  → ``nan_grad``
    - non-finite loss                      → ``nan_loss``
    - ``grad_norm_limit`` exceeded         → ``grad_norm``
    - finite loss > ``spike_factor`` × the median of the last
      ``spike_window`` clean losses        → ``loss_spike``

    Any anomaly returns :attr:`SentinelAction.SKIP` (the optimizer's
    gate already committed no update for non-finite gradients);
    ``skip_limit`` anomalies in a row trigger :meth:`rollback` and
    return :attr:`SentinelAction.ROLLBACK`: the caller resumes from
    :attr:`resume_step`. ``note_checkpoint(step)`` marks a checkpoint of
    a clean step as the rollback anchor.
    """

    def __init__(self, checkpointer=None, model=None, optimizer=None,
                 skip_limit=3, lr_cooldown=0.5, spike_factor=None,
                 spike_window=8, grad_norm_limit=None, on_anomaly=None,
                 auto_rollback=True):
        if skip_limit < 1:
            raise ValueError("skip_limit must be >= 1")
        self.checkpointer = checkpointer
        self.model = model
        self.optimizer = optimizer
        self.skip_limit = int(skip_limit)
        self.lr_cooldown = float(lr_cooldown)
        self.spike_factor = (float(spike_factor)
                             if spike_factor is not None else None)
        self.spike_window = int(spike_window)
        self.grad_norm_limit = (float(grad_norm_limit)
                                if grad_norm_limit is not None else None)
        self.on_anomaly = on_anomaly
        self.auto_rollback = bool(auto_rollback)
        self._lock = threading.Lock()
        self.anomalies = []          # [AnomalyDetected]
        self.skip_streak = 0
        self.skips_total = 0
        self.rollbacks = 0
        self.last_good_step = None   # newest clean-step checkpoint
        self.resume_step = None      # set by rollback()
        self._recent = deque(maxlen=max(1, self.spike_window))
        self.last_probe = None
        self._gauge("sentinel_last_good_step", -1)

    @staticmethod
    def _gauge(name, value):
        try:
            obs.registry().gauge(
                name, help="training-sentinel state").set(value)
        except Exception:
            pass

    def _classify(self, step, loss, summary):
        """(kind, ctx) of the worst anomaly of this step, or (None, {})."""
        if summary is not None and not summary.good:
            return "nan_grad", {"bad_regions": summary.bad_regions,
                                "regions": summary.regions}
        if loss is not None and not np.isfinite(loss):
            return "nan_loss", {"loss": float(loss)}
        if summary is not None and self.grad_norm_limit is not None \
                and summary.grad_norm > self.grad_norm_limit:
            return "grad_norm", {"grad_norm": summary.grad_norm,
                                 "limit": self.grad_norm_limit}
        if loss is not None and self.spike_factor is not None \
                and len(self._recent) >= self._recent.maxlen:
            med = float(np.median(self._recent))
            if med > 0 and loss > self.spike_factor * med:
                return "loss_spike", {"loss": float(loss),
                                      "median": med,
                                      "factor": self.spike_factor}
        return None, {}

    def observe(self, step, loss=None, summary=None, site="train"):
        """Feed one step's probes; returns the action taken. ``loss`` is
        a Python float (NaN allowed); ``summary`` a
        :class:`GuardSummary`, a raw (4,) array, or None."""
        if summary is not None and not isinstance(summary, GuardSummary):
            summary = GuardSummary.from_array(summary)
        loss = float(loss) if loss is not None else None
        with self._lock:
            kind, ctx = self._classify(step, loss, summary)
            if kind is None:
                self.skip_streak = 0
                if loss is not None:
                    self._recent.append(loss)
                return SentinelAction.OK
            self.skip_streak += 1
            self.skips_total += 1
            streak = self.skip_streak
            do_rollback = (streak >= self.skip_limit
                           and self.auto_rollback
                           and self.checkpointer is not None)
            if do_rollback:
                self.skip_streak = 0
        # callback and restore outside the lock: a callback that feeds
        # back into observe() must not deadlock
        evt = note_anomaly(kind, site, step=step, streak=streak, **ctx)
        self.anomalies.append(evt)
        try:
            obs.registry().counter(
                "sentinel_skips_total",
                help="training steps skipped by the sentinel").inc()
        except Exception:
            pass
        if self.on_anomaly is not None:
            try:
                self.on_anomaly(evt)
            except Exception:
                pass
        if do_rollback and self.rollback(reason=evt) is not None:
            return SentinelAction.ROLLBACK
        # no restorable checkpoint: the step is still only skipped
        return SentinelAction.SKIP

    def note_probe(self, fn_name, probe):
        """Hook fed by ``to_static(guard=True)`` when this sentinel is the
        ambient one (:func:`install`): keeps the latest probe."""
        with self._lock:
            self.last_probe = dict(probe, fn=str(fn_name))

    def note_checkpoint(self, step):
        """A checkpoint landed for a step the caller believes clean: it
        becomes the rollback anchor, unless an anomaly streak is open."""
        with self._lock:
            if self.skip_streak == 0:
                self.last_good_step = int(step)
        if self.last_good_step == int(step):
            self._gauge("sentinel_last_good_step", int(step))

    def rollback(self, reason=None):
        """Restore the model and the optimizer from the
        ``last_good_step`` anchor (the newest good entry when the anchor
        is unset or gone), apply the LR cooldown, and return the step to
        resume from (also :attr:`resume_step`); None, counting nothing,
        without a restorable checkpoint."""
        if self.checkpointer is None:
            return None
        from paddle_tpu_torch.resilience.checkpoint import auto_resume
        from paddle_tpu_torch.resilience.faultinject import note_recovery
        t0 = time.perf_counter()
        start = 0
        if self.last_good_step is not None:
            start, _extra = auto_resume(self.checkpointer, self.model,
                                        self.optimizer,
                                        step=self.last_good_step)
        if start == 0:
            start, _extra = auto_resume(self.checkpointer, self.model,
                                        self.optimizer)
        if start == 0:
            with self._lock:
                self.resume_step = None
            return None
        if self.optimizer is not None and self.lr_cooldown != 1.0:
            try:
                # in place, so a captured step's next replay reads it
                self.optimizer.set_lr(
                    self.optimizer.get_lr() * self.lr_cooldown)
            except RuntimeError:
                # an LRScheduler owns the lr: the cooldown is its job,
                # and the rollback still restores
                pass
        with self._lock:
            self.rollbacks += 1
            self.resume_step = start
            self._recent.clear()
        try:
            with obs.span("resilience.sentinel.rollback",
                          resume_step=self.resume_step,
                          kind=getattr(reason, "kind", None),
                          restore_ms=round(
                              (time.perf_counter() - t0) * 1e3, 3)):
                pass
            obs.registry().counter(
                "sentinel_rollbacks_total",
                help="sentinel-triggered checkpoint rollbacks").inc()
        except Exception:
            pass
        note_recovery("optimizer.grads", "rollback",
                      resume_step=self.resume_step,
                      anomaly=getattr(reason, "kind", None))
        return self.resume_step


# ---------------------------------------------------- ambient sentinel
_current = None
_current_lock = threading.Lock()


def install(sentinel):
    """Install the process-ambient sentinel that ``to_static(guard=True)``
    hands its probes to (informational: the policy runs through
    explicit ``observe()`` calls)."""
    global _current
    with _current_lock:
        _current = sentinel
    return sentinel


def uninstall(sentinel=None):
    global _current
    with _current_lock:
        if sentinel is not None and _current is not sentinel:
            return
        _current = None


def current():
    return _current


# ------------------------------------------------- lineage + bisection
class BatchLineage:
    """Bounded (step -> microbatch identity) recorder for deterministic
    replay: ``record(step, seed=..., batch=...)`` at every step, and
    after an anomaly the localizer replays the entries between the last
    good checkpoint and the flagged step. ``batch`` may be the batch
    itself (kept by reference) or any identity (ids, a digest); other
    keywords (a step's fault plan, say) ride along."""

    def __init__(self, capacity=256):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._entries = OrderedDict()    # step -> dict

    def record(self, step, seed=None, batch=None, **meta):
        e = {"step": int(step), "seed": seed, "batch": batch, **meta}
        with self._lock:
            self._entries[int(step)] = e
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)
        return e

    def get(self, step):
        with self._lock:
            return self._entries.get(int(step))

    def steps(self):
        with self._lock:
            return list(self._entries)

    def __len__(self):
        with self._lock:
            return len(self._entries)


def replay_bisect(predicate, lo, hi):
    """Minimal step ``k`` in ``[lo, hi]`` with ``predicate(k)`` true;
    ``predicate(k)`` must mean "replaying steps lo..k from the last good
    state trips the guard", which is monotone in ``k``. None when even
    ``predicate(hi)`` is clean (the anomaly does not reproduce: a
    transient, not a data fault). ``O(log(hi - lo))`` predicate calls."""
    lo, hi = int(lo), int(hi)
    if lo > hi:
        raise ValueError(f"need lo <= hi, got {lo} > {hi}")
    if not predicate(hi):
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if predicate(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo


def localize_poison(replay, last_good_step, bad_step):
    """Name the poison step: ``replay(upto)`` restores the last good
    checkpoint and re-runs steps ``last_good_step+1 .. upto`` with the
    guard armed, returning True iff any step tripped. The poison step is
    strictly after the last good checkpoint."""
    return replay_bisect(replay, int(last_good_step) + 1, int(bad_step))


# ------------------------------------------------------------- digests
def _leaf_bytes(v):
    """``(header, payload)`` of one leaf as the reference hashes it:
    numpy's ``f"{shape}:{dtype}|"`` and the raw bytes. A tensor whose
    dtype numpy lacks (bf16, fp8) is read as an integer of its width
    and spelled by torch's name, which is the reference's spelling."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        try:
            a = t.numpy()
        except TypeError:
            ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                    8: torch.int64}[t.element_size()]
            name = str(t.dtype).replace("torch.", "")
            return (f"{tuple(t.shape)}:{name}|",
                    t.view(ints).numpy().tobytes())
    else:
        a = np.asarray(v)
    return f"{a.shape}:{a.dtype}|", a.tobytes()


def tree_digest(tree):
    """Deterministic sha256 hex over a tree (dicts, lists, tuples) of
    tensors and arrays, equal to the reference's for the same values.
    Vote only values that are replicated across ranks (post-sync
    gradients, updated parameter replicas). Dict leaves hash under their
    sorted keys; every leaf contributes its shape/dtype header plus its
    raw bytes (a host copy: size the tree accordingly)."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            h.update(path.encode())
            header, payload = _leaf_bytes(node)
            h.update(header.encode())
            h.update(payload)

    walk(tree, "")
    return h.hexdigest()


class DigestVote:
    """One vote round's outcome: per-rank digests, the majority digest
    (strict majority), and the dissenting SUSPECT ranks. Without a
    strict majority the vote is inconclusive (``majority`` None, no
    suspects)."""

    def __init__(self, step, site, digests, majority, suspects, mine):
        self.step = int(step)
        self.site = str(site)
        self.digests = dict(digests)      # global rank -> digest
        self.majority = majority          # None when inconclusive
        self.suspects = tuple(suspects)   # global ranks, sorted
        self.mine = mine

    @property
    def conclusive(self):
        return self.majority is not None

    @property
    def agree(self):
        return self.conclusive and not self.suspects

    @property
    def self_suspect(self):
        return self.conclusive and self.mine != self.majority

    def to_dict(self):
        return {"step": self.step, "site": self.site,
                "majority": self.majority,
                "conclusive": self.conclusive,
                "suspects": list(self.suspects),
                "self_suspect": self.self_suspect,
                "digests": dict(self.digests)}

    def __repr__(self):
        return (f"DigestVote(step={self.step}, site={self.site!r}, "
                f"conclusive={self.conclusive}, "
                f"suspects={list(self.suspects)})")


# own-key reap bookkeeping: votes are collective and lockstep, so when
# this rank starts round r it has finished gathering its previous round,
# which proves every rank finished every round before that one; the
# keys of those rounds are deleted (each rank its own), bounding the
# store to two live rounds per (namespace, site)
_vote_rounds = {}
_vote_lock = threading.Lock()


def digest_vote(value, *, step, site="grads", client=None,
                world_view=None, timeout_s=None, monitor=None):
    """One cross-rank digest vote round (collective: every member calls
    it with the same ``step`` and ``site``). ``value`` is a tree
    (digested by :func:`tree_digest`) or a digest string. In a world of
    one (``world_view``, default ``fleet.world()``) the vote is this
    rank's digest, agreed. Across ranks the digests travel through the
    fleet's coordination store (``client``, default the launcher's)
    under one shared deadline, a DEAD verdict of ``monitor`` aborting
    the wait as :class:`~paddle_tpu_torch.resilience.fleet.
    CollectiveTimeout`. A strict majority names the dissenting ranks
    SUSPECT (``monitor.mark_suspect`` quarantines them); anything less
    is inconclusive. Each rank deletes its keys of rounds every rank
    has provably finished."""
    from paddle_tpu_torch.resilience import fleet

    mine = value if isinstance(value, str) else tree_digest(value)
    wv = world_view if world_view is not None else fleet.world()
    if wv.size <= 1:
        return DigestVote(step, site, {wv.global_rank: mine}, mine, (),
                          mine)
    cl = client if client is not None else fleet.get_client()
    if cl is None:
        raise RuntimeError(
            "digest_vote in a multi-rank world needs the coordination "
            "store (the launcher's client) or an explicit client=")
    cfg = fleet.get_config()
    timeout_s = (float(timeout_s) if timeout_s is not None
                 else cfg.collective_timeout_s)
    ns = wv.namespace
    rnd = int(step)

    def key_for(fleet_rank, r=rnd):
        return f"{ns}/sentinel/vote/{site}/s{r}/r{fleet_rank}"

    hist_key = (ns, str(site), wv.rank)
    with _vote_lock:
        prior = _vote_rounds.get(hist_key, [])
        reap = prior[:-1]                   # all but my previous round
        _vote_rounds[hist_key] = prior[-1:] + [rnd]
    for r in reap:
        try:
            cl.key_value_delete(key_for(wv.rank, r))
        except Exception:
            pass

    fleet.kv_set_bytes(cl, key_for(wv.rank), mine.encode())
    abort_if = None
    if monitor is not None:
        members = wv.members

        def abort_if():   # noqa: F811
            return any(monitor.is_dead(m) for m in members)

    digests = {wv.global_rank: mine}
    deadline = time.monotonic() + timeout_s
    for i, grank in enumerate(wv.members):
        if i == wv.rank:
            continue
        remaining = max(0.05, deadline - time.monotonic())
        raw = fleet.kv_get_bytes(cl, key_for(i), remaining,
                                 site="sentinel.vote", missing_rank=grank,
                                 abort_if=abort_if, config=cfg)
        digests[grank] = bytes(raw).decode().rstrip("\x00")

    counts = {}
    for d in digests.values():
        counts[d] = counts.get(d, 0) + 1
    top = max(counts.values())
    if top * 2 > len(digests):
        # strict majority only: it is unique, so every rank names the
        # same suspects; a tie or a split is inconclusive
        majority = next(d for d, c in counts.items() if c == top)
        suspects = tuple(sorted(r for r, d in digests.items()
                                if d != majority))
    else:
        majority, suspects = None, ()
    vote = DigestVote(step, site, digests, majority, suspects, mine)
    with obs.span("resilience.sentinel.vote", step=vote.step,
                  site=vote.site, suspects=list(suspects)):
        pass
    reg = obs.registry()
    reg.counter("sentinel_digest_votes_total",
                help="cross-rank digest vote rounds").inc()
    if not vote.conclusive:
        reg.counter("sentinel_vote_inconclusive_total",
                    help="digest votes with no strict majority").inc()
    if suspects:
        reg.counter("sentinel_sdc_suspects_total",
                    help="ranks named SDC-suspect by a digest vote").inc(
                        len(suspects))
    for s in suspects:
        note_anomaly("sdc_suspect", f"sentinel.vote.{site}", step=step,
                     rank=s)
        if monitor is not None:
            monitor.mark_suspect(s, reason=f"digest vote {site}@{step}")
    return vote
