"""paddle_tpu_torch's ``to_static`` (``jit/api.py:StaticFunction``), the
learning rate as device state and the LR schedulers, against paddle_tpu.

On the CPU a StaticFunction keys its cache and runs the step eagerly;
these tests hold that logic and the discovery's parts (the CUDA capture
itself is held on the card by ``chip_smoke.py``):

- the cache: one entry a signature, a new batch shape adds one, a NaN
  batch, ``set_lr`` and a scheduler step add none, as the reference's
  ``_compiled`` (``tests/test_sentinel.py:222-261``);
- k calls bit-identical to k eager steps (weights, accumulators, beta
  powers, gradients);
- discovery's parts: the snapshot and its restore, the state a call
  changes (which places a step without CUDA arguments), and which
  gradients a step clears before its backward;
- the port's and the reference's step from the same weights, losses
  within 1e-4 and first-step gradients within 1e-4 of each tensor's
  largest magnitude (``tests/test_torch_train.py``'s tolerances);
- every scheduler's lr over 30 steps equal to the reference's (host
  math in both, compared to 1e-12 relative), bound to the optimizer's
  f32 lr tensor, and ``state_dict`` round trips, the scheduler's and the
  optimizer's ``LR_Scheduler`` entry (a rollback restores its epoch);
- outputs, gradient accumulation, fault hooks and ``dygraph_function``.
"""
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as pnn
import paddle_tpu.nn.functional as PF
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny
from paddle_tpu.optimizer import lr as ref_lr
from paddle_tpu.resilience import faultinject as ref_faultinject

import paddle_tpu_torch as T
from paddle_tpu_torch.framework import state
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.jit import api
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import lr as port_lr
from paddle_tpu_torch.resilience import faultinject

VOCAB = 256


@pytest.fixture(scope="module")
def linear_init():
    """The reference's seeded nn.Linear(6, 3) weights."""
    P.seed(0)
    model = pnn.Linear(6, 3)
    return {k: np.asarray(t._value) for k, t in model.state_dict().items()}


@pytest.fixture(scope="module")
def gpt_init():
    """The reference's seeded gpt3_tiny weights and a 2 x 32 batch."""
    P.seed(0)
    model = RefGPT(ref_tiny(fused_ln=True))
    init = {k: np.asarray(t._value) for k, t in model.state_dict().items()}
    rng = np.random.default_rng(0)
    return init, rng.integers(0, VOCAB, (2, 32)), \
        rng.integers(0, VOCAB, (2, 32))


def _batch(step, n=8):
    rng = np.random.default_rng(1000 + step)
    return (rng.standard_normal((n, 6)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32))


def _linear_port(init, lr=0.05, guard=True, fused=False):
    model = T.nn.Linear(6, 3, device="cpu")
    load_numpy_state_dict(model, init)
    opt = T.optimizer.AdamW(learning_rate=lr,
                            parameters=model.named_parameters(),
                            guard=guard, fused=fused)

    @T.jit.to_static(guard=guard)
    def train_step(X, y):
        opt.clear_grad()
        loss = ((model(X) - y) ** 2).mean()
        loss.backward()
        opt.step()
        return loss

    return model, opt, train_step


def _linear_ref(init, lr=0.05, guard=True):
    model = pnn.Linear(6, 3)
    model.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
    opt = P.optimizer.AdamW(learning_rate=lr,
                            parameters=model.parameters(), guard=guard)

    @P.jit.to_static(guard=guard)
    def train_step(X, y):
        opt.clear_grad()
        loss = ((model(X) - y) ** 2).mean()
        loss.backward()
        opt.step()
        return loss

    return model, opt, train_step


def _gpt_port(init, fused=False, guard=False):
    model = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(model, init)
    opt = T.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.named_parameters(),
                            fused=fused, guard=guard)

    def step(ids, labels):
        opt.clear_grad()
        logits = model(ids)
        loss = F.cross_entropy(logits.reshape([-1, VOCAB]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return model, opt, step


# ---------------------------------------------------------------- cache
@pytest.mark.parametrize("change,added", [
    ("repeat", 0), ("new_shape", 1), ("nan_batch", 0), ("set_lr", 0),
    ("scheduler_step", 0)])
def test_compiled_entries_as_reference(linear_init, change, added):
    """Four calls of one signature make one entry; then ``change`` and a
    call add ``added``, in both packages."""
    sched = (port_lr.StepDecay(0.05, step_size=1, gamma=0.5),
             ref_lr.StepDecay(0.05, step_size=1, gamma=0.5)) \
        if change == "scheduler_step" else (0.05, 0.05)
    _, opt, step = _linear_port(linear_init, lr=sched[0])
    _, ref_opt, ref_step = _linear_ref(linear_init, lr=sched[1])
    X, y = _batch(1)
    n = 8
    for _ in range(4):
        step(torch.tensor(X), torch.tensor(y))
        ref_step(P.to_tensor(X), P.to_tensor(y))
    assert len(step._compiled) == len(ref_step._compiled) == 1
    if change == "new_shape":
        n = 5
    elif change == "nan_batch":
        X = np.full_like(X, np.nan)
    elif change == "set_lr":
        opt.set_lr(0.01)
        ref_opt.set_lr(0.01)
    elif change == "scheduler_step":
        sched[0].step()
        sched[1].step()
    Xb, yb = _batch(2, n) if change == "new_shape" else (X, y)
    loss = step(torch.tensor(Xb), torch.tensor(yb))
    ref_loss = ref_step(P.to_tensor(Xb), P.to_tensor(yb))
    assert len(step._compiled) == len(ref_step._compiled) == 1 + added
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert opt.get_lr() == pytest.approx(ref_opt.get_lr(), rel=1e-7)


def test_new_state_keys_a_new_entry_and_drops_the_old(linear_init):
    """A state tensor registered after the first call keys the next
    call anew, as in the reference; the entry of the older version can
    never be reached again and is dropped (the reference keeps it)."""
    _, _, step = _linear_port(linear_init)
    X, y = (torch.tensor(a) for a in _batch(1))
    step(X, y)
    (key,) = step._compiled
    other = T.optimizer.AdamW(
        parameters=[torch.nn.Parameter(torch.zeros(2))])
    step(X, y)
    (new_key,) = step._compiled
    assert new_key[:-1] == key[:-1] and new_key[-1] > key[-1]
    assert other._lr_tensor is not None


# ------------------------------------------------------------ discovery
def _state(model, opt):
    out = {f"p.{n}": p.detach() for n, p in model.named_parameters()}
    out.update({f"g.{n}": p.grad for n, p in model.named_parameters()})
    out.update({f"acc.{k}": v for k, v in opt.state_dict().items()})
    return out


def _summary(opt):
    s = opt.guard_summary()
    return None if s is None else (s.good, s.grad_sumsq, s.bad_regions,
                                   s.regions)


@pytest.mark.parametrize("fused,guard", [(False, False), (True, True)])
def test_steps_bit_identical_to_eager(gpt_init, fused, guard):
    """k to_static calls against k eager steps from the same weights:
    weights, gradients, moments and beta powers bit-identical after
    every call, the first call one step."""
    init, ids, labels = gpt_init
    ids, labels = torch.tensor(ids), torch.tensor(labels)
    model, opt, raw = _gpt_port(init, fused, guard)
    emodel, eopt, eager = _gpt_port(init, fused, guard)
    step = T.jit.to_static(raw, guard=guard)
    runs = []
    for _ in range(3):
        loss = step(ids, labels)
        runs.append((loss, {k: v.clone() for k, v in
                            _state(model, opt).items()},
                     _summary(opt)))
    # the eager twin's accumulators register after the captured calls,
    # which would otherwise key a new entry
    assert len(step._compiled) == 1
    for k, (loss, got, summary) in enumerate(runs):
        assert torch.equal(loss, eager(ids, labels)), k
        exp = _state(emodel, eopt)
        assert sorted(got) == sorted(exp)
        assert len([n for n in got if n.startswith("acc.")]) == \
            4 * len(list(model.parameters()))
        for name in exp:
            assert torch.equal(got[name], exp[name]), (k, name)
        if guard:
            assert summary == _summary(eopt)


def _init(key):
    return 1.0 if key.endswith("_pow") else 0.0


def test_snapshot_restores_state_and_fills_inits(linear_init):
    """What the discovery calls change is put back: weights and
    gradients in place, accumulators made meanwhile at their inits; a
    state tensor registered without an init refuses the restore."""
    model, opt, _ = _linear_port(linear_init)
    X, y = (torch.tensor(a) for a in _batch(1))
    ((model(X) - y) ** 2).mean().backward()
    before = {n: (p.detach().clone(), p.grad.clone())
              for n, p in model.named_parameters()}
    weight = model.weight
    snap = api._StateSnapshot(torch.device("cpu"))
    opt.step()
    opt.step()
    made = opt.state_dict()
    assert len(made) == 8 and all(
        not torch.equal(v, torch.full_like(v, _init(k)))
        for k, v in made.items())
    snap.restore()
    assert model.weight is weight
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n][0]) and \
            torch.equal(p.grad, before[n][1])
    for key, v in opt.state_dict().items():
        assert torch.equal(v, torch.full_like(v, _init(key))), key
    snap = api._StateSnapshot(torch.device("cpu"))
    extra = torch.zeros(2)
    state.register_state_tensor(extra)
    with pytest.raises(RuntimeError, match="without an init"):
        snap.restore()


def _params_state(model):
    return [(p.detach().clone(), None if p.grad is None else p.grad.clone())
            for p in model.parameters()]


@pytest.mark.parametrize("kind,changes", [
    ("train_step", "params+accumulators"), ("backward", "params"),
    ("forward", "nothing"), ("no_grad", "nothing")])
def test_changed_state_names_what_a_call_changes(linear_init, kind, changes):
    """``changed_state`` finds the registered tensors a call changes
    (gradients set, accumulators made) and puts everything back, as the
    placement of a step without CUDA arguments needs."""
    model, opt, step = _linear_port(linear_init)
    X, y = (torch.tensor(a) for a in _batch(1))
    step(X, y)                      # gradients and accumulators exist
    before = _params_state(model)
    acc = {k: v.clone() for k, v in opt.state_dict().items()}
    calls = {
        "train_step": lambda: step.dygraph_function(X, y),
        "backward": lambda: ((model(X) - y) ** 2).mean().backward(),
        "forward": lambda: model(X),
        "no_grad": lambda: torch.no_grad()(model)(X)}
    changed = api.changed_state(calls[kind], torch.device("cpu"))
    ids = {id(t) for t in changed}
    params = {id(p) for p in model.parameters()}
    accs = {id(t) for t in opt.state_dict().values()}
    accs.add(id(opt._guard_summary_t))
    want = {"params+accumulators": params | accs, "params": params,
            "nothing": set()}[changes]
    assert ids == want
    for (w, g), p in zip(before, model.parameters()):
        assert torch.equal(p, w) and torch.equal(p.grad, g)
    for k, v in opt.state_dict().items():
        assert torch.equal(v, acc[k]), k


@pytest.mark.parametrize("clear,cleared", [
    ("clear_grad", True), ("zero_grad", True), ("zero_grad_in_place", True),
    ("assign_none", True), ("clear_after_step", True), ("none", False)])
def test_clears_watched_per_parameter(linear_init, clear, cleared):
    """Which parameters a call clears before its backward adds to their
    gradient, by any means: what decides, after a replay, whether the
    graph's gradient replaces the parameter's or adds to it."""
    model, opt, _ = _linear_port(linear_init)
    X, y = (torch.tensor(a) for a in _batch(1))
    clears = {
        "clear_grad": opt.clear_grad,
        "zero_grad": model.zero_grad,
        "zero_grad_in_place": lambda: model.zero_grad(set_to_none=False),
        "assign_none": lambda: [setattr(p, "grad", None)
                                for p in model.parameters()]}

    def step():
        clears.get(clear, lambda: None)()
        ((model(X) - y) ** 2).mean().backward()
        opt.step()
        if clear == "clear_after_step":
            opt.clear_grad()

    step()
    params = list(model.parameters())
    old = [weakref.ref(p.grad) for p in params if p.grad is not None]
    with api.clears_watched(params) as got:
        step()
        # the watch holds no gradient: one the step dropped is freed
        freed = [r() is None for r in old]
    assert got == ({id(p) for p in params} if cleared else set())
    rebinds = clear in ("clear_grad", "zero_grad", "assign_none")
    assert freed == [rebinds] * len(old)


# ------------------------------------------------------------ reference
def test_gpt_steps_match_reference(gpt_init):
    """The port's to_static step and the reference's from the same
    weights: 3 f32 losses within 1e-4, the first step's gradients
    within 1e-4 of each tensor's largest magnitude."""
    init, ids, labels = gpt_init
    P.seed(0)
    ref_model = RefGPT(ref_tiny(fused_ln=True))
    ref_model.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
    ref_opt = P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=ref_model.parameters())

    @P.jit.to_static
    def ref_step(ids, labels):
        ref_opt.clear_grad()
        loss = PF.cross_entropy(ref_model(ids).reshape([-1, VOCAB]),
                                labels.reshape([-1]))
        loss.backward()
        ref_opt.step()
        return loss

    model, _, raw = _gpt_port(init)
    step = T.jit.to_static(raw)
    for k in range(3):
        want = float(ref_step(P.to_tensor(ids, dtype="int64"),
                              P.to_tensor(labels, dtype="int64")))
        got = step(torch.tensor(ids), torch.tensor(labels)).item()
        assert abs(got - want) <= 1e-4, k
        if k == 0:
            ref_grads = {n: np.asarray(p.grad._value)
                         for n, p in ref_model.named_parameters()}
            for n, p in model.named_parameters():
                err = np.abs(p.grad.numpy() - ref_grads[n]).max()
                assert err <= 1e-4 * np.abs(ref_grads[n]).max(), (n, err)
    assert len(step._compiled) == len(ref_step._compiled) == 1


# ----------------------------------------------------------- schedulers
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=5,
                                       learning_rate=1.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12],
                                                 [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=10,
                                                   cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=20), warmup_steps=5,
        start_lr=0.0, end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, milestones=[4, 9, 20]),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=7),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.95 ** e),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(0.1,
                                                           lambda e: 0.9),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, T_max=12),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, patience=2,
                                                   factor=0.5),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=25),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     mode="triangular2"),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=5, T_mult=2),
}
METRICS = [1.0, 0.9, 0.95, 0.96, 0.97, 0.8, 0.85, 0.86, 0.87, 0.88] * 3


def _advance(sched, i):
    if type(sched).__name__ == "ReduceOnPlateau":
        sched.step(METRICS[i])
    else:
        sched.step()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_reference_on_the_lr_tensor(name):
    """30 steps: the port's lr equals the reference's, the optimizer's
    f32 lr tensor holds it after every step, ``set_lr`` raises while the
    scheduler owns the lr, and the state dict round-trips."""
    sched, ref = SCHEDULERS[name](port_lr), SCHEDULERS[name](ref_lr)
    opt = T.optimizer.AdamW(learning_rate=sched,
                            parameters=[torch.nn.Parameter(torch.zeros(3))])
    lrs, want = [], []
    for i in range(30):
        lrs.append(opt.get_lr())
        want.append(ref())
        assert opt._lr_tensor.dtype == torch.float32
        assert opt._lr_tensor.item() == np.float32(sched())
        _advance(sched, i)
        _advance(ref, i)
    np.testing.assert_allclose(lrs, want, rtol=1e-12, atol=0)
    assert len(set(lrs)) > 1
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.5)
    other = SCHEDULERS[name](port_lr)
    other.set_state_dict(sched.state_dict())
    assert other.state_dict() == sched.state_dict()
    assert other() == sched()


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_optimizer_state_dict_carries_the_schedule(name):
    """``Optimizer.state_dict()["LR_Scheduler"]`` is the reference's after
    7 steps; restored into a fresh optimizer it sets the scheduler's
    epoch, so the next step's lr is the reference's."""
    def port_opt():
        sched = SCHEDULERS[name](port_lr)
        return sched, T.optimizer.AdamW(
            learning_rate=sched,
            parameters=[torch.nn.Parameter(torch.zeros(3))])

    def ref_opt():
        sched = SCHEDULERS[name](ref_lr)
        return sched, P.optimizer.AdamW(
            learning_rate=sched, parameters=pnn.Linear(3, 1).parameters())

    (sched, opt), (ref, ropt) = port_opt(), ref_opt()
    for i in range(7):
        _advance(sched, i)
        _advance(ref, i)
    sd, ref_sd = opt.state_dict(), ropt.state_dict()
    assert sd["LR_Scheduler"] == pytest.approx(ref_sd["LR_Scheduler"],
                                               rel=1e-12)
    (sched2, opt2), (ref2, ropt2) = port_opt(), ref_opt()
    opt2.set_state_dict(sd)
    ropt2.set_state_dict(ref_sd)
    assert sched2.last_epoch == ref2.last_epoch == sched.last_epoch
    _advance(sched2, 7)
    _advance(ref2, 7)
    assert opt2.get_lr() == pytest.approx(ropt2.get_lr(), rel=1e-12)
    assert opt2._lr_tensor.item() == np.float32(sched2())


def test_set_lr_writes_the_tensor_in_place():
    opt = T.optimizer.AdamW(learning_rate=0.1,
                            parameters=[torch.nn.Parameter(torch.zeros(3))])
    t = opt._lr_tensor
    assert t.dtype == torch.float32 and t.dim() == 0
    assert any(x is t for x in state.state_tensors())
    opt.set_lr(0.25)
    assert opt._lr_tensor is t and t.item() == 0.25 == opt.get_lr()


def test_rollback_cooldown_leaves_a_scheduled_lr(linear_init, tmp_path):
    """The sentinel's cooldown goes through ``set_lr``; where a scheduler
    owns the lr it is the scheduler's job, and the rollback still
    restores (``paddle_tpu/resilience/sentinel.py:367-375``), the
    schedule's epoch too: the next scheduler step gives the reference's
    lr."""
    from paddle_tpu import resilience as PR
    from paddle_tpu_torch import resilience as TR
    sched = port_lr.ExponentialDecay(0.05, gamma=0.5)
    ref_sched = ref_lr.ExponentialDecay(0.05, gamma=0.5)
    model, opt, step = _linear_port(linear_init, lr=sched)
    ref_model, ref_opt, ref_step = _linear_ref(linear_init, lr=ref_sched)
    ck = TR.Checkpointer(str(tmp_path / "port"), keep=2)
    ref_ck = PR.Checkpointer(str(tmp_path / "ref"), keep=2)
    sent = TR.TrainingSentinel(checkpointer=ck, model=model, optimizer=opt,
                               skip_limit=1, lr_cooldown=0.5)
    ref_sent = PR.TrainingSentinel(checkpointer=ref_ck, model=ref_model,
                                   optimizer=ref_opt, skip_limit=1,
                                   lr_cooldown=0.5)
    for i in (1, 2):
        X, y = _batch(i)
        step(torch.tensor(X), torch.tensor(y))
        ref_step(P.to_tensor(X), P.to_tensor(y))
        if i == 1:
            ck.save_train_state(1, model, opt)
            ref_ck.save_train_state(1, ref_model, ref_opt)
            sent.note_checkpoint(1)
            ref_sent.note_checkpoint(1)
            w_ckpt = model.weight.detach().clone()
            sched.step()
            ref_sched.step()
    bad = np.asarray([0.0, np.nan, 1.0, 2.0], np.float32)
    assert sent.observe(3, summary=bad) is TR.SentinelAction.ROLLBACK
    assert ref_sent.observe(3, summary=bad) is PR.SentinelAction.ROLLBACK
    assert torch.equal(model.weight.detach(), w_ckpt)
    assert opt.get_lr() == sched() == ref_opt.get_lr() == 0.025
    assert opt._lr_tensor.item() == np.float32(0.025)
    assert sched.last_epoch == ref_sched.last_epoch == 0
    sched.step()
    ref_sched.step()
    assert opt.get_lr() == ref_opt.get_lr() == 0.025
    assert opt._lr_tensor.item() == np.float32(0.025)


# ------------------------------------------------------------- the rest
def test_returned_outputs_are_not_overwritten(linear_init):
    _, _, step = _linear_port(linear_init)
    X, y = (torch.tensor(a) for a in _batch(1))
    first = step(X, y)
    kept = first.clone()
    second = step(X, y)
    assert first is not second and torch.equal(first, kept)
    assert not torch.equal(first, second)


def test_grads_accumulate_without_clear_as_reference(linear_init):
    """A step that runs backward without clearing: the port's gradients
    after 3 calls are the reference's (``_apply``'s accumulation);
    a step that clears keeps one call's gradient."""
    model, opt, _ = _linear_port(linear_init)
    ref_model, _, _ = _linear_ref(linear_init)
    X, y = _batch(1)

    @T.jit.to_static
    def accumulate(X, y):
        ((model(X) - y) ** 2).mean().backward()

    @P.jit.to_static
    def ref_accumulate(X, y):
        ((ref_model(X) - y) ** 2).mean().backward()

    for _ in range(3):
        accumulate(torch.tensor(X), torch.tensor(y))
        ref_accumulate(P.to_tensor(X), P.to_tensor(y))
    for n, p in model.named_parameters():
        want = np.asarray(dict(ref_model.named_parameters())[n].grad._value)
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-6,
                                   atol=1e-7)
    one = {n: p.grad / 3 for n, p in model.named_parameters()}

    @T.jit.to_static
    def clearing(X, y):
        opt.clear_grad()
        ((model(X) - y) ** 2).mean().backward()

    for _ in range(2):
        clearing(torch.tensor(X), torch.tensor(y))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), one[n].numpy(),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("plan", ["none", "exception_at_3"])
def test_fault_hooks_and_dygraph_function(linear_init, plan):
    """``optimizer.step``'s hook over: a first call, two more, a new
    batch shape, ``set_lr`` and a call. Both packages fire it only while
    a signature is built, as often as the reference traces it (2, 2, 2,
    3, 3: the first call's discovery registers the accumulators, so it
    runs twice), never on a cached call; ``dygraph_function`` fires once
    a call and adds no entry. An exception planted at the fourth
    occurrence fires in neither package's five calls."""
    _, opt, step = _linear_port(linear_init)
    _, ref_opt, ref_step = _linear_ref(linear_init)
    faults = [] if plan == "none" else [("optimizer.step", "exception", 3)]
    counts, ref_counts, entries = [], [], []
    with faultinject.FaultInjector(faultinject.FaultPlan(
            [faultinject.FaultSpec(*f) for f in faults])) as inj, \
            ref_faultinject.FaultInjector(ref_faultinject.FaultPlan(
                [ref_faultinject.FaultSpec(*f) for f in faults])) as ref_inj:
        for i, n in enumerate((8, 8, 8, 5, 5)):
            if i == 4:
                opt.set_lr(0.01)
                ref_opt.set_lr(0.01)
            X, y = _batch(i, n)
            step(torch.tensor(X), torch.tensor(y))
            ref_step(P.to_tensor(X), P.to_tensor(y))
            counts.append(inj.occurrences("optimizer.step"))
            ref_counts.append(ref_inj.occurrences("optimizer.step"))
            entries.append(len(step._compiled))
        assert inj.injected == [] and ref_inj.injected == []
        if plan == "none":
            step.dygraph_function(*(torch.tensor(a) for a in _batch(9)))
            assert inj.occurrences("optimizer.step") == counts[-1] + 1
        else:
            with pytest.raises(faultinject.WorkerFault):
                step.dygraph_function(*(torch.tensor(a) for a in _batch(9)))
    assert ref_counts == [2, 2, 2, 3, 3]
    assert entries == [1, 1, 1, 2, 2]
    assert counts == ref_counts
    assert len(step._compiled) == 2


def test_unported_and_bad_arguments_raise():
    with pytest.raises(ValueError, match="remat"):
        T.jit.to_static(lambda: None, remat="f16")
    assert T.jit.to_static(lambda: None, remat="bf16")._policy.remat == \
        "bf16"
    step = T.jit.to_static(lambda x, opts: x)
    with pytest.raises(TypeError, match="neither a tensor nor hashable"):
        step(torch.zeros(2), np.zeros(2))
    assert step(torch.ones(2), ("a", 1)).tolist() == [1.0, 1.0]
    assert step.dygraph_function(1, None) == 1
