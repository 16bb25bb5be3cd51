"""paddle_tpu_torch.resilience's remainders against paddle_tpu.resilience,
on the CPU at tiny sizes: ``tree_digest`` hex over f32, bf16 and int
leaves, ``digest_vote`` in a world of one, ``retry``'s backoff sequence
for a seed, ``BatchLineage`` / ``replay_bisect`` / ``localize_poison``
naming the same poison step, the preemption drain (requested, by a real
SIGTERM, and by a ``preempt`` fault) with a resume equal to the
uninterrupted run, the ``slow`` fault, and the sentinel's, checkpoint's
and fault injector's counters and spans after the same guarded run.

The registry and span recorder are process-wide: the tests read deltas.
"""
import importlib
import math
import random
import signal
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu.nn as pnn
from paddle_tpu import observability as robs
from paddle_tpu import resilience as R

import paddle_tpu_torch as T
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import resilience as TR
from paddle_tpu_torch.framework.io import (load_numpy_state_dict,
                                           numpy_state_dict)
from paddle_tpu_torch.resilience import faultinject, preemption

# the packages' ``retry`` names the decorator; the modules by name
ref_retry = importlib.import_module("paddle_tpu.resilience.retry")
port_retry = importlib.import_module("paddle_tpu_torch.resilience.retry")

CKPT_STEP, FAULT_STEP, TOTAL, SKIPS = 4, 7, 10, 2


def _numbers(mod):
    """Every scalar of the registry's snapshot, and every span count."""
    snap = {k: v for k, v in mod.registry().snapshot().items()
            if isinstance(v, (int, float))}
    snap.update({f"span:{k}": v["count"]
                 for k, v in mod.recorder().aggregates().items()})
    return snap


def _moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


# -------------------------------------------------------------- digests
def _leaves(kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    if kind == "f32":
        return torch.tensor(x), jnp.asarray(x)
    if kind == "bf16":
        return torch.tensor(x).to(torch.bfloat16), \
            jnp.asarray(x).astype(jnp.bfloat16)
    if kind == "int":
        i = rng.integers(-9, 9, (4, 2)).astype(np.int32)
        return torch.tensor(i), jnp.asarray(i)
    if kind == "tree":
        i64 = np.arange(6, dtype=np.int64).reshape(2, 3)
        port = {"w": torch.tensor(x), "b": [torch.tensor(x[0]).to(
            torch.bfloat16), (1.5, i64)], "flag": torch.tensor([True])}
        ref = {"w": jnp.asarray(x), "b": [jnp.asarray(x[0]).astype(
            jnp.bfloat16), (1.5, i64)], "flag": jnp.asarray([True])}
        return port, ref
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int", "tree"])
def test_tree_digest_matches_reference(kind):
    port, ref = _leaves(kind)
    got = TR.tree_digest(port)
    assert got == R.tree_digest(ref)
    assert len(got) == 64
    assert TR.tree_digest({"a": port, "b": 0}) == \
        TR.tree_digest({"b": 0, "a": port})


def test_tree_digest_is_sensitive_and_votes_alone():
    x = torch.zeros(4)
    assert TR.tree_digest(x) != TR.tree_digest(x.double())
    assert TR.tree_digest(x) != TR.tree_digest(x.reshape(2, 2))
    assert TR.tree_digest(x) != TR.tree_digest(x.to(torch.bfloat16))
    vote = TR.digest_vote({"w": x}, step=3)
    assert vote.agree and vote.conclusive and not vote.self_suspect
    assert vote.to_dict()["digests"] == {0: TR.tree_digest({"w": x})}
    assert TR.digest_vote("abc", step=1).majority == "abc"

    # a vote across ranks goes through the fleet's coordination store,
    # which a process outside a launched fleet does not have
    from paddle_tpu_torch.resilience.fleet import WorldView
    with pytest.raises(RuntimeError, match="client"):
        TR.digest_vote(x, step=1, world_view=WorldView([0, 1], 1))


# ---------------------------------------------------------------- retry
def _flaky(pkg_retry, fails, **kw):
    seen = []

    @pkg_retry.retry(sleep=lambda s: None,
                     on_retry=lambda e, a, d: seen.append((a, d)), **kw)
    def flaky():
        flaky.calls += 1
        if flaky.calls <= fails:
            raise OSError(f"flake {flaky.calls}")
        return flaky.calls

    flaky.calls = 0
    return flaky, seen


@pytest.mark.parametrize("seed", [0, 7])
def test_retry_backoff_matches_reference(seed):
    kw = dict(max_attempts=6, backoff=0.1, multiplier=3.0, max_backoff=2.0,
              jitter=0.5, seed=seed)
    before, ref_before = _numbers(obs), _numbers(robs)
    fn, seen = _flaky(port_retry, 4, **kw)
    ref_fn, ref_seen = _flaky(ref_retry, 4, **kw)
    assert fn() == ref_fn() == 5
    assert seen == ref_seen and len(seen) == 4
    assert [a for a, _ in seen] == [1, 2, 3, 4]
    moved, ref_moved = _moved(before, _numbers(obs)), \
        _moved(ref_before, _numbers(robs))
    assert moved == ref_moved
    assert moved["span:resilience.retry"] == 4
    pol = TR.RetryPolicy(5, 0.2, 2.0, 1.0, 0.3)
    rng, ref_rng = random.Random(seed), random.Random(seed)
    assert [port_retry.compute_backoff(pol, k, rng) for k in range(6)] == \
        [ref_retry.compute_backoff(R.RetryPolicy(5, 0.2, 2.0, 1.0, 0.3), k,
                                   ref_rng) for k in range(6)]


def test_retry_exhaustion_and_policies():
    fn, _ = _flaky(port_retry, 10, max_attempts=3)
    with pytest.raises(TR.RetryExhausted) as err:
        fn()
    assert err.value.attempts == 3 and fn.calls == 3
    assert isinstance(err.value.__cause__, OSError)
    fn, seen = _flaky(port_retry, 2, max_attempts=1, retry_on=(),
                      policies={OSError: TR.RetryPolicy(max_attempts=4)})
    assert fn() == 3 and len(seen) == 2

    @TR.retry(sleep=lambda s: None, retry_on=(OSError,))
    def strict():
        raise KeyError("not retryable")

    with pytest.raises(KeyError):
        strict()
    with pytest.raises(ValueError):
        TR.RetryPolicy(max_attempts=0)


# ---------------------------------------------------- lineage + bisect
def test_lineage_and_bisect_match_reference():
    lin, ref_lin = TR.BatchLineage(capacity=3), R.BatchLineage(capacity=3)
    for s in range(5):
        assert lin.record(s, seed=s * 10, batch=f"b{s}", tag=s) == \
            ref_lin.record(s, seed=s * 10, batch=f"b{s}", tag=s)
    assert lin.steps() == ref_lin.steps() == [2, 3, 4]
    assert lin.get(3) == ref_lin.get(3) and lin.get(0) is None
    assert len(lin) == 3
    with pytest.raises(ValueError):
        TR.BatchLineage(capacity=0)
    for bad in (1, 5, 7, 12, None):
        calls = []

        def pred(k):
            calls.append(k)
            return bad is not None and k >= bad

        ref_calls = []

        def ref_pred(k):
            ref_calls.append(k)
            return bad is not None and k >= bad

        assert TR.replay_bisect(pred, 1, 12) == \
            R.sentinel.replay_bisect(ref_pred, 1, 12) == \
            (None if bad is None else bad)
        assert calls == ref_calls
        assert len(calls) <= 1 + math.ceil(math.log2(12))
    with pytest.raises(ValueError):
        TR.replay_bisect(pred, 5, 4)


@pytest.fixture(scope="module")
def init():
    """The reference's seeded nn.Linear(6, 3) weights."""
    P.seed(0)
    model = pnn.Linear(6, 3)
    return {k: np.asarray(t._value) for k, t in model.state_dict().items()}


def _value(loss):
    """A loss of either package as a Python float."""
    if isinstance(loss, torch.Tensor):
        return loss.item()
    return float(loss.numpy())


def _batch(step, n=8):
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((n, 6)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


class _Run:
    """A guarded AdamW Linear(6, 3) of either package, stepped eagerly
    with a step's fault plan, and checkpointed."""

    def __init__(self, pkg, init, ckpt_dir):
        self.pkg = pkg
        if pkg == "ref":
            self.R = R
            self.model = pnn.Linear(6, 3)
            self.model.set_state_dict(
                {k: P.to_tensor(v) for k, v in init.items()})
            self.opt = P.optimizer.AdamW(
                learning_rate=0.05, parameters=self.model.parameters(),
                guard=True)
        else:
            self.R = TR
            self.model = T.nn.Linear(6, 3, device="cpu")
            load_numpy_state_dict(self.model, init)
            self.opt = T.optimizer.AdamW(
                learning_rate=0.05,
                parameters=self.model.named_parameters(), guard=True)
        self.ck = self.R.Checkpointer(str(ckpt_dir), keep=2)

    def step(self, step, faults=()):
        """One eager step on ``_batch(step)`` under ``faults`` ((site,
        kind, at) triples); (loss, guard summary)."""
        conv = P.to_tensor if self.pkg == "ref" else torch.tensor
        X, y = (conv(a) for a in _batch(step))
        plan = self.R.FaultPlan([self.R.FaultSpec(*f) for f in faults],
                                seed=3)
        with self.R.FaultInjector(plan):
            self.opt.clear_grad()
            loss = ((self.model(X) - y) ** 2).mean()
            loss.backward()
            self.opt.step()
        return _value(loss), self.opt.guard_summary()

    def weight(self):
        w = self.model.weight
        return np.asarray(w._value) if self.pkg == "ref" \
            else w.detach().numpy()


# ---------------------------------------------------------- localization
POISON, LAST_GOOD, LOCALIZE_TOTAL = 7, 4, 10


def _localize(pkg, init, tmp_path):
    """The reference's TestLocalization drive with a planted nan_grad:
    steps 1-10 with a checkpoint at 4 and the fault planted at 7 (the
    lineage keeps each step's batch seed and fault plan), then a replay
    bisection from the checkpoint. (flagged step, found step, replays)."""
    run = _Run(pkg, init, tmp_path / pkg)
    lineage = run.R.BatchLineage()
    flagged = None
    for step in range(1, LOCALIZE_TOTAL + 1):
        faults = [("optimizer.grads", "nan_grad", 0)] \
            if step == POISON else []
        lineage.record(step, seed=1000 + step, batch=step, faults=faults)
        _, summary = run.step(step, faults)
        if not summary.good and flagged is None:
            flagged = step
        if step == LAST_GOOD:
            run.ck.save_train_state(step, run.model, run.opt)
    replays = []

    def replay(upto):
        replays.append(upto)
        start, _ = run.R.auto_resume(run.ck, run.model, run.opt,
                                     step=LAST_GOOD)
        assert start == LAST_GOOD + 1
        tripped = False
        for s in range(start, upto + 1):
            e = lineage.get(s)
            tripped |= not run.step(e["batch"], e["faults"])[1].good
        return tripped

    found = run.R.localize_poison(replay, LAST_GOOD, LOCALIZE_TOTAL)
    return flagged, found, replays


def test_localize_poison_names_the_planted_step(init, tmp_path):
    got = _localize("port", init, tmp_path)
    want = _localize("ref", init, tmp_path)
    assert got == want
    flagged, found, replays = got
    assert flagged == found == POISON
    assert len(replays) <= 1 + math.ceil(
        math.log2(LOCALIZE_TOTAL - LAST_GOOD))


# ------------------------------------------------------------ preemption
def _state_fn(run, step):
    return lambda: {"step": step,
                    "model": numpy_state_dict(run.model),
                    "optimizer": run.opt.state_dict()}


def test_request_preemption_drains_and_records(init, tmp_path):
    run = _Run("port", init, tmp_path)
    before = _numbers(obs)
    assert not TR.request_preemption("no handler")
    with TR.PreemptionHandler(checkpointer=run.ck) as pre:
        assert preemption.get_handler() is pre
        assert not pre.check(0)
        assert TR.request_preemption("unit-test")
        assert pre.preempted and pre.reason == "unit-test"
        assert pre.check(5, _state_fn(run, 5))
        assert pre.drained and pre.drain_step == 5 and pre.drain_ms >= 0
    assert not TR.request_preemption("after exit")
    assert preemption.get_handler() is None
    assert run.ck.steps() == [5]
    moved = _moved(before, _numbers(obs))
    assert moved["resilience_preemptions_total"] == 1
    assert moved["span:resilience.preempt.drain"] == 1
    assert moved["resilience_checkpoint_writes_total"] == 1
    pre.reset()
    assert not pre.preempted and pre.drain_ms is None


def test_sigterm_drains_at_the_next_step(init, tmp_path, capfd):
    """A real SIGTERM to the process only sets the flag (the notice waits
    for the poll, as the reference's); the next check drains."""
    run = _Run("port", init, tmp_path)
    prev = signal.getsignal(signal.SIGTERM)
    pre = TR.PreemptionHandler(checkpointer=run.ck, auto_install=False)
    pre.install_signal_handlers()
    try:
        signal.raise_signal(signal.SIGTERM)
        assert pre.preempted and pre.reason == "signal:SIGTERM"
        assert "preemption requested" not in capfd.readouterr().err
        assert pre.check(3, _state_fn(run, 3))
        assert "preemption requested (signal:SIGTERM)" in \
            capfd.readouterr().err
    finally:
        pre.uninstall_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert run.ck.steps() == [3]


def test_preempt_fault_drains_and_resume_matches_uninterrupted(init,
                                                               tmp_path):
    """A ``preempt`` fault at the third ``optimizer.step`` under a
    PreemptionHandler: the loop drains a checkpoint of step 3 and stops;
    a fresh model and optimizer resumed from it take steps 4-6 under
    to_static, and equal the reference's resumed run (losses and weights
    within 1e-6): both fresh optimizers drop the saved moments. The
    parameters' digest is equal before the save and after the load. The
    reference drains at the same step."""
    clean = _Run("port", init, tmp_path / "clean")
    clean_losses = [clean.step(s)[0] for s in range(1, 7)]

    def preempted(pkg):
        run = _Run(pkg, init, tmp_path / f"pre-{pkg}")
        plan = run.R.FaultPlan([run.R.FaultSpec("optimizer.step",
                                                "preempt", at=2)])
        losses, digest = [], None
        with run.R.PreemptionHandler(checkpointer=run.ck) as pre, \
                run.R.FaultInjector(plan):
            for s in range(1, 7):
                run.opt.clear_grad()
                X, y = (P.to_tensor(a) if pkg == "ref" else torch.tensor(a)
                        for a in _batch(s))
                loss = ((run.model(X) - y) ** 2).mean()
                loss.backward()
                run.opt.step()
                losses.append(_value(loss))
                if pkg == "port":
                    digest = TR.tree_digest(dict(run.model.named_parameters()))
                    state = _state_fn(run, s)
                else:
                    state = (lambda s=s: {"step": s,
                                          "model": run.model.state_dict(),
                                          "optimizer":
                                              run.opt.state_dict()})
                if pre.check(s, state):
                    break
        return run, losses, pre.drain_step, digest

    run, losses, drained, digest = preempted("port")
    _, ref_losses, ref_drained, _ = preempted("ref")
    assert drained == ref_drained == 3 and len(losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    assert losses == clean_losses[:3]
    # the restart: in each package a fresh model and optimizer (no
    # moments made yet) resume from the drained checkpoint and take the
    # steps left under to_static; the fresh optimizer drops the saved
    # moments, as the reference's does
    zeros = {k: v * 0 for k, v in init.items()}
    resumed = _Run("port", zeros, tmp_path / "pre-port")
    start, _ = TR.auto_resume(resumed.ck, resumed.model, resumed.opt)
    assert start == 4
    assert TR.tree_digest(dict(resumed.model.named_parameters())) == digest
    assert resumed.opt.state_dict() == {}
    ref_resumed = _Run("ref", zeros, tmp_path / "pre-ref")
    assert R.auto_resume(ref_resumed.ck, ref_resumed.model,
                         ref_resumed.opt)[0] == start

    def tail(run, jit, conv):
        @jit
        def train_step(X, y):
            run.opt.clear_grad()
            loss = ((run.model(X) - y) ** 2).mean()
            loss.backward()
            run.opt.step()
            return loss

        return [_value(train_step(*(conv(a) for a in _batch(s))))
                for s in range(start, 7)]

    port_tail = tail(resumed, T.jit.to_static, torch.tensor)
    ref_tail = tail(ref_resumed, P.jit.to_static, P.to_tensor)
    np.testing.assert_allclose(port_tail, ref_tail, rtol=1e-6)
    np.testing.assert_allclose(resumed.weight(), ref_resumed.weight(),
                               rtol=1e-6, atol=1e-7)
    assert port_tail != clean_losses[3:]        # the moments restarted


def test_slow_fault_sleeps_and_fleet_kinds_raise():
    before, ref_before = _numbers(obs), _numbers(robs)
    specs = [("io.save", "slow", 0, 1, {"sleep_s": 0.05}),
             ("io.save", "slow", 1)]
    with TR.FaultInjector(TR.FaultPlan([TR.FaultSpec(*s) for s in specs])):
        t0 = time.perf_counter()
        spec = faultinject.fire("io.save")
        assert spec.kind == "slow" and time.perf_counter() - t0 >= 0.05
        t0 = time.perf_counter()
        faultinject.fire("io.save")
        assert time.perf_counter() - t0 >= 0.01
    with R.FaultInjector(R.FaultPlan([R.FaultSpec(*s) for s in specs])):
        R.faultinject.fire("io.save")
        R.faultinject.fire("io.save")
    assert _moved(before, _numbers(obs)) == \
        _moved(ref_before, _numbers(robs)) == {
            "resilience_faults_injected_total{kind=slow,site=io.save}": 2,
            "span:resilience.fault": 2}
    # the fleet kinds: a parked wedge sleeps the calling thread (the
    # SIGSTOP and SIGKILL forms act on child processes in
    # tests/test_torch_fleet.py)
    plan = TR.FaultPlan([TR.FaultSpec("x", "wedge",
                                      payload={"park_s": 0.05})])
    with TR.FaultInjector(plan) as inj:
        t0 = time.perf_counter()
        assert faultinject.fire("x").kind == "wedge"
        assert time.perf_counter() - t0 >= 0.05
    assert len(inj.injected) == 1


# ------------------------------------------------------------ telemetry
def _chaos(pkg, init, ckpt_dir):
    """TestChaosAcceptance's loop: nan_grad at steps 7 and 8, checkpoint
    at 4, rollback after 2 anomalies; then a corrupted newest checkpoint
    loaded past."""
    run = _Run(pkg, init, ckpt_dir)
    sent = run.R.TrainingSentinel(checkpointer=run.ck, model=run.model,
                                  optimizer=run.opt, skip_limit=SKIPS,
                                  lr_cooldown=1.0)
    fault_steps = {FAULT_STEP, FAULT_STEP + 1}
    planted = set()
    step = 1
    while step <= TOTAL:
        faults = []
        if step in fault_steps and step not in planted:
            planted.add(step)
            faults = [("optimizer.grads", "nan_grad", 0)]
        loss, summary = run.step(step, faults)
        act = sent.observe(step, loss=loss, summary=summary)
        if int(act) == 2:                       # ROLLBACK
            step = sent.resume_step
            continue
        if int(act) == 0 and step in (CKPT_STEP, TOTAL):
            run.ck.save_train_state(step, run.model, run.opt)
            sent.note_checkpoint(step)
        step += 1
    newest = sorted(ckpt_dir.glob("ckpt-*.pkl"))[-1]
    newest.write_bytes(b"torn")
    assert run.ck.load()[0] == CKPT_STEP
    return sent, run.weight()


def test_sentinel_and_checkpoint_telemetry_match_reference(init, tmp_path):
    before, ref_before = _numbers(obs), _numbers(robs)
    sent, w = _chaos("port", init, tmp_path / "port")
    moved = _moved(before, _numbers(obs))
    ref_sent, ref_w = _chaos("ref", init, tmp_path / "ref")
    ref_moved = _moved(ref_before, _numbers(robs))
    assert (sent.skips_total, sent.rollbacks) == \
        (ref_sent.skips_total, ref_sent.rollbacks) == (SKIPS, 1)
    np.testing.assert_allclose(w, ref_w, rtol=0, atol=1e-6)
    # the port's TrainingSentinel sets the gauge at construction as well
    for m in (moved, ref_moved):
        m.pop("sentinel_last_good_step", None)
    assert moved == ref_moved
    assert moved["sentinel_anomaly_total{kind=nan_grad,site=train}"] == 2
    assert moved["sentinel_rollbacks_total"] == 1
    assert moved["resilience_checkpoint_writes_total"] == 2
    assert moved["resilience_checkpoint_corrupt_total"] == 1
    assert moved["span:resilience.sentinel.rollback"] == 1
    assert obs.registry().gauge("sentinel_last_good_step").value == \
        robs.registry().gauge("sentinel_last_good_step").value == TOTAL
