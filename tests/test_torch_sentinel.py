"""paddle_tpu_torch training sentinel: fault injection, checkpoints, the
skip/rollback policy machine and the chaos proofs, held against
paddle_tpu's where both packages run the same thing.

- ``corrupt_array`` picks the same element and bit as the reference's
  and gives the same bits;
- the policy machine's cases of ``tests/test_sentinel.py::
  TestPolicyMachine``;
- ``Checkpointer`` falls back past a corrupted or torn payload;
- the chaos acceptance (``TestChaosAcceptance``) in the port: a resumed
  run's losses and weights equal the fault-free run's exactly;
- the same ``FaultPlan`` through both packages from the same weights:
  the same anomalies, skips and rollbacks, weights within 1e-6 (the same
  f32 arithmetic in two libraries).
"""
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu.nn as pnn
from paddle_tpu import resilience as R
from paddle_tpu.resilience import faultinject as ref_faultinject
from paddle_tpu.resilience import sentinel as ref_sentinel

import paddle_tpu_torch as T
from paddle_tpu_torch import resilience as TR
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.resilience import faultinject, sentinel

OK, SKIP, ROLLBACK = (sentinel.SentinelAction.OK, sentinel.SentinelAction.SKIP,
                      sentinel.SentinelAction.ROLLBACK)


@pytest.fixture(scope="module")
def init():
    """The reference's seeded nn.Linear(6, 3) weights."""
    P.seed(0)
    model = pnn.Linear(6, 3)
    return {k: np.asarray(t._value) for k, t in model.state_dict().items()}


def _batch(step, din=6, dout=3, n=8):
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((n, din)).astype(np.float32),
            rng.standard_normal((n, dout)).astype(np.float32))


def _build(init, guard=True, fused=False, lr=0.05):
    model = T.nn.Linear(6, 3, device="cpu")
    load_numpy_state_dict(model, init)
    opt = T.optimizer.AdamW(learning_rate=lr,
                            parameters=model.named_parameters(),
                            guard=guard, fused=fused)
    return model, opt


def _eager_step(model, opt, step):
    X, y = (torch.tensor(a) for a in _batch(step))
    opt.clear_grad()
    loss = ((model(X) - y) ** 2).mean()
    loss.backward()
    opt.step()
    return loss.item()


# ------------------------------------------------------- corrupt_array
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 3, 1234])
@pytest.mark.parametrize("kind,at,payload", [
    ("nan_grad", 0, {}), ("nan_grad", 6, {"index": 5}),
    ("bitflip", 6, {}), ("bitflip", 2, {"bit": 20}),
    ("bitflip", 1, {"bit": 31, "index": 3})])
def test_corrupt_array_matches_reference(kind, at, payload, seed, dtype):
    spec = dict(site="optimizer.grads", kind=kind, at=at, payload=payload)
    a = np.random.default_rng(seed).standard_normal((7, 5))
    if dtype == "bfloat16":
        ref_in = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
        port_in = torch.tensor(a, dtype=torch.float32).bfloat16()
    else:
        ref_in = a.astype(dtype)
        port_in = torch.tensor(ref_in)
    want = ref_faultinject.corrupt_array(ref_faultinject.FaultSpec(**spec),
                                         ref_in, seed=seed)
    got = faultinject.corrupt_array(faultinject.FaultSpec(**spec), port_in,
                                    seed=seed).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    bits = np.uint32 if want.dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(got.view(bits), want.view(bits))
    assert (got.view(bits) != np.asarray(port_in.float() if dtype ==
            "bfloat16" else port_in).view(bits)).sum() == 1


def test_fault_kinds_not_ported_raise():
    # every kind is ported now: rank_kill acts (on a child process in
    # tests/test_torch_fleet.py); one due at an occurrence never
    # reached leaves the calling process alone
    plan = TR.FaultPlan([TR.FaultSpec("optimizer.step", "rank_kill",
                                      at=99),
                         TR.FaultSpec("io.save", "exception")])
    with TR.FaultInjector(plan) as inj:
        assert faultinject.fire("optimizer.step") is None
        with pytest.raises(TR.WorkerFault):
            faultinject.fire("io.save")
        assert faultinject.fire("io.save") is None
        assert [(s, occ) for s, _f, occ in inj.injected] == [("io.save", 0)]
    assert faultinject.active_plan() is None
    with pytest.raises(ValueError, match="corrupt_array"):
        faultinject.corrupt_array(TR.FaultSpec("x", "exception"),
                                  torch.zeros(3))


# ------------------------------------------------------ policy machine
def test_summary_and_anomaly_records():
    s = sentinel.GuardSummary.from_array(np.asarray([1.0, 4.0, 0.0, 7.0]))
    assert s.good and s.grad_norm == 2.0 and s.regions == 7
    bad = sentinel.GuardSummary.from_array([0.0, np.nan, 3.0, 7.0])
    assert not bad.good and bad.bad_regions == 3
    evt = sentinel.AnomalyDetected(12, "nan_grad", "train", bad_regions=2)
    assert evt.to_dict() == {"step": 12, "kind": "nan_grad",
                             "site": "train", "bad_regions": 2}
    with pytest.raises(ValueError):
        sentinel.GuardSummary.from_array(np.zeros(2))


@pytest.mark.parametrize("kwargs,feed,kind", [
    ({}, [dict(loss=0.5), dict(loss=float("nan"))], "nan_loss"),
    ({}, [dict(loss=0.5, summary=[1.0, 2.0, 0.0, 4.0]),
          dict(loss=0.5, summary=[0.0, np.nan, 1.0, 4.0])], "nan_grad"),
    ({"grad_norm_limit": 10.0}, [dict(summary=[1.0, 25.0, 0.0, 4.0]),
                                 dict(summary=[1.0, 4e4, 0.0, 4.0])],
     "grad_norm"),
    ({"spike_factor": 3.0, "spike_window": 4},
     [dict(loss=x) for x in (1.0, 0.9, 1.1, 0.95, 1.3)] + [dict(loss=10.0)],
     "loss_spike"),
])
def test_anomaly_flagged_after_clean_steps(kwargs, feed, kind):
    sent = sentinel.TrainingSentinel(auto_rollback=False, **kwargs)
    acts = [sent.observe(i + 1, **f) for i, f in enumerate(feed)]
    assert acts == [OK] * (len(feed) - 1) + [SKIP]
    assert sent.anomalies[-1].kind == kind
    assert sent.anomalies[-1].step == len(feed)


def test_streak_resets_on_clean_step():
    sent = sentinel.TrainingSentinel(auto_rollback=False, skip_limit=3)
    sent.observe(1, loss=float("nan"))
    sent.observe(2, loss=float("nan"))
    assert sent.skip_streak == 2
    sent.observe(3, loss=0.5)
    assert sent.skip_streak == 0


BAD = np.asarray([0.0, np.nan, 1.0, 2.0], np.float32)


def test_rollback_restores_and_cools_lr(init, tmp_path):
    model, opt = _build(init)
    ck = TR.Checkpointer(str(tmp_path), keep=2)
    sent = sentinel.TrainingSentinel(checkpointer=ck, model=model,
                                     optimizer=opt, skip_limit=2,
                                     lr_cooldown=0.5)
    _eager_step(model, opt, 1)
    ck.save_train_state(1, model, opt)
    sent.note_checkpoint(1)
    w_ckpt = model.weight.detach().clone()
    m_ckpt = opt.state_dict()["weight_moment1"].clone()
    _eager_step(model, opt, 2)
    lr0 = opt.get_lr()
    lr_t = opt._lr_tensor
    assert sent.observe(3, summary=BAD) is SKIP
    assert sent.observe(4, summary=BAD) is ROLLBACK
    assert sent.rollbacks == 1 and sent.resume_step == 2
    assert torch.equal(model.weight.detach(), w_ckpt)
    assert torch.equal(opt.state_dict()["weight_moment1"], m_ckpt)
    assert opt.get_lr() == pytest.approx(lr0 * 0.5)
    # the cooldown reached the device lr in place (a captured step
    # reads this tensor on its next replay)
    assert opt._lr_tensor is lr_t and lr_t.dtype == torch.float32
    assert lr_t.item() == np.float32(lr0 * 0.5)
    assert sent.skip_streak == 0


def test_rollback_anchors_last_good_not_newest(init, tmp_path):
    model, opt = _build(init)
    ck = TR.Checkpointer(str(tmp_path), keep=4)
    sent = sentinel.TrainingSentinel(checkpointer=ck, model=model,
                                     optimizer=opt, skip_limit=2)
    _eager_step(model, opt, 1)
    ck.save_train_state(1, model, opt)
    sent.note_checkpoint(1)
    w_good = model.weight.detach().clone()
    assert sent.observe(2, summary=BAD) is SKIP
    _eager_step(model, opt, 2)
    ck.save_train_state(2, model, opt)
    sent.note_checkpoint(2)                 # mid-streak: not the anchor
    assert sent.last_good_step == 1
    assert sent.observe(3, summary=BAD) is ROLLBACK
    assert sent.resume_step == 2
    assert torch.equal(model.weight.detach(), w_good)


def test_no_restorable_checkpoint_stays_skip(init, tmp_path):
    model, opt = _build(init)
    sent = sentinel.TrainingSentinel(
        checkpointer=TR.Checkpointer(str(tmp_path), keep=2), model=model,
        optimizer=opt, skip_limit=2)
    assert sent.observe(1, loss=float("nan")) is SKIP
    assert sent.observe(2, loss=float("nan")) is SKIP
    assert sent.rollbacks == 0 and sent.resume_step is None


def test_anomalous_checkpoint_not_anchored():
    sent = sentinel.TrainingSentinel(auto_rollback=False)
    sent.observe(1, loss=float("nan"))
    sent.note_checkpoint(1)
    assert sent.last_good_step is None
    sent.observe(2, loss=0.5)
    sent.note_checkpoint(2)
    assert sent.last_good_step == 2


def test_on_anomaly_callback_outside_lock():
    sent = sentinel.TrainingSentinel(auto_rollback=False)
    seen = []

    def cb(evt):
        seen.append(evt.kind)
        sent.observe(99, loss=0.1)         # re-entrant clean observe

    sent.on_anomaly = cb
    t = threading.Thread(target=lambda: sent.observe(1, loss=float("nan")))
    t.start()
    t.join(timeout=5)
    assert not t.is_alive(), "observe() deadlocked in on_anomaly"
    assert seen == ["nan_loss"]


# --------------------------------------------------------- checkpoints
def test_checkpointer_falls_back_past_corrupt_and_torn(tmp_path):
    ck = TR.Checkpointer(str(tmp_path / "a"), keep=3)
    for step in (1, 2, 3):
        ck.save(step, {"w": torch.full((4,), float(step)), "step": step})
    path = tmp_path / "a" / "ckpt-00000003.pkl"
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))
    with TR.FaultInjector(TR.FaultPlan([])) as inj:
        step, state = ck.load()
    assert step == 2 and np.array_equal(state["w"], np.full(4, 2.0))
    assert inj.recovered[0][:2] == ("io.save", "torn_write")
    ck.save(4, {"step": 4})
    assert ck.steps() == [2, 3, 4]                 # keep=3 pruned step 1
    assert not (tmp_path / "a" / "ckpt-00000001.pkl").exists()
    for name in ("ckpt-00000002.pkl", "ckpt-00000004.pkl"):
        (tmp_path / "a" / name).write_bytes(b"junk")
    with pytest.raises(TR.CheckpointCorruption):
        ck.load(strict=True)
    assert ck.load(step=2) is None
    # a torn write through the fault site: the 2nd payload is cut short
    plan = TR.FaultPlan([TR.FaultSpec("io.save", "torn_write", at=1)])
    ck2 = TR.Checkpointer(str(tmp_path / "b"), async_save=True)
    with TR.FaultInjector(plan):
        ck2.save(1, {"x": np.arange(1000)})
        ck2.save(2, {"x": np.arange(1000) + 1})
        step, state = ck2.load()
    ck2.close()
    assert step == 1 and np.array_equal(state["x"], np.arange(1000))


# ----------------------------------------------------- to_static guard
def test_to_static_guard_probe_and_ambient_sentinel(init):
    model, opt = _build(init, fused=True)

    @T.jit.to_static(guard=True)
    def train_step(X, y):
        opt.clear_grad()
        loss = ((model(X) - y) ** 2).mean()
        loss.backward()
        opt.step()
        return loss, {"aux": torch.ones(2)}

    assert train_step.last_guard is None
    sent = sentinel.install(sentinel.TrainingSentinel())
    try:
        X, y = (torch.tensor(a) for a in _batch(1))
        loss, _ = train_step(X, y)
        lg = train_step.last_guard
        assert lg == {"values": [loss.item()], "finite": [True],
                      "loss": loss.item(), "loss_finite": True}
        assert sent.last_probe["fn"] == "train_step"
        assert opt.guard_summary().good
        train_step(torch.full((8, 6), float("nan")), y)
        assert train_step.last_guard["loss_finite"] is False
        assert not opt.guard_summary().good
    finally:
        sentinel.uninstall(sent)
    assert sentinel.current() is None


# ------------------------------------------------------------- chaos
CKPT_STEP, FAULT_STEP, TOTAL, SKIPS = 4, 7, 10, 2


def _chaos_plan(pkg, kind):
    return pkg.FaultPlan(
        [pkg.FaultSpec("optimizer.grads", kind, at=FAULT_STEP - 1,
                       times=SKIPS, payload={"bit": 30})],
        seed=3, name=f"chaos-{kind}")


def _port_chaos(init, ckpt_dir, plan, grad_norm_limit=None, fused=False):
    model, opt = _build(init, fused=fused)
    ck = TR.Checkpointer(str(ckpt_dir), keep=2)
    sent = sentinel.TrainingSentinel(
        checkpointer=ck, model=model, optimizer=opt, skip_limit=SKIPS,
        lr_cooldown=1.0, grad_norm_limit=grad_norm_limit)
    inj = faultinject.install(TR.FaultInjector(plan)) if plan else None
    losses = {}
    try:
        step = 1
        while step <= TOTAL:
            loss = _eager_step(model, opt, step)
            act = sent.observe(step, loss=loss, summary=opt.guard_summary())
            if act is ROLLBACK:
                step = sent.resume_step
                continue
            if act is OK:
                losses[step] = loss
                if step == CKPT_STEP:
                    ck.save_train_state(step, model, opt)
                    sent.note_checkpoint(step)
            step += 1
    finally:
        if inj is not None:
            faultinject.uninstall(inj)
    return losses, model.weight.detach().numpy().copy(), sent


def _ref_chaos(init, ckpt_dir, plan, grad_norm_limit=None, fused=False):
    P.seed(0)
    model = pnn.Linear(6, 3)
    model.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
    opt = P.optimizer.AdamW(learning_rate=0.05,
                            parameters=model.parameters(), guard=True,
                            fused=fused)
    ck = R.Checkpointer(str(ckpt_dir), keep=2)
    sent = ref_sentinel.TrainingSentinel(
        checkpointer=ck, model=model, optimizer=opt, skip_limit=SKIPS,
        lr_cooldown=1.0, grad_norm_limit=grad_norm_limit)
    inj = ref_faultinject.install(R.FaultInjector(plan))
    try:
        step = 1
        while step <= TOTAL:
            X, y = (P.to_tensor(a) for a in _batch(step))
            opt.clear_grad()
            loss = ((model(X) - y) ** 2).mean()
            loss.backward()
            opt.step()
            act = sent.observe(step, loss=float(loss.numpy()),
                               summary=opt.guard_summary())
            if act is ref_sentinel.SentinelAction.ROLLBACK:
                step = sent.resume_step
                continue
            if act is ref_sentinel.SentinelAction.OK and step == CKPT_STEP:
                ck.save_train_state(step, model, opt)
                sent.note_checkpoint(step)
            step += 1
    finally:
        ref_faultinject.uninstall(inj)
    return np.asarray(model.weight._value).copy(), sent


@pytest.mark.parametrize("kind,limit", [("nan_grad", None),
                                        ("bitflip", 1e3)])
def test_chaos_detect_skip_rollback_matches_fault_free(init, tmp_path, kind,
                                                       limit):
    clean_losses, clean_w, _ = _port_chaos(init, tmp_path / "a", None, limit)
    losses, w, sent = _port_chaos(init, tmp_path / "b",
                                  _chaos_plan(TR, kind), limit)
    assert sent.anomalies and sent.anomalies[0].step == FAULT_STEP
    assert sent.anomalies[0].kind in (
        ("nan_grad",) if kind == "nan_grad" else ("nan_grad", "grad_norm"))
    assert sent.skips_total == SKIPS and sent.rollbacks == 1
    assert losses == clean_losses
    np.testing.assert_array_equal(w, clean_w)
    assert np.isfinite(w).all()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind,limit", [("nan_grad", None),
                                        ("bitflip", 1e3)])
def test_same_fault_plan_same_outcome_in_both_packages(init, tmp_path, kind,
                                                       limit, fused):
    ref_w, ref_sent = _ref_chaos(init, tmp_path / "ref",
                                 _chaos_plan(R, kind), limit, fused)
    _, w, sent = _port_chaos(init, tmp_path / "port",
                             _chaos_plan(TR, kind), limit, fused)
    assert [(a.step, a.kind) for a in sent.anomalies] == \
        [(a.step, a.kind) for a in ref_sent.anomalies]
    assert (sent.skips_total, sent.rollbacks, sent.resume_step) == \
        (ref_sent.skips_total, ref_sent.rollbacks, ref_sent.resume_step)
    np.testing.assert_allclose(w, ref_w, rtol=0, atol=1e-6)
