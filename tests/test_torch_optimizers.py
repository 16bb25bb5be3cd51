"""paddle_tpu_torch's SGD, Momentum, LarsMomentum, RMSProp, Adagrad,
Adadelta, Adamax, Lamb and GradientMergeOptimizer against paddle_tpu's:
a two-layer MLP (``tests/test_torch_clip_decay.py``'s) from shared
weights takes 5 steps through each package's optimizer with each
option, and the weights after them are compared; a state dict crosses
from the reference to the port; ``to_static`` on the CPU equals eager
steps; the guard gates SGD.

Tolerances: weights within 1e-6 of each tensor's largest magnitude (the
same f32 arithmetic, norms summed in another order); captured against
eager bit for bit; guard verdicts exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import regularizer as ref_reg
from paddle_tpu.nn import clip as ref_clip
from paddle_tpu.optimizer import lr as ref_lr

import paddle_tpu_torch as T
from paddle_tpu_torch import regularizer
from paddle_tpu_torch.nn import clip
from paddle_tpu_torch.optimizer import lr as port_lr

SIZES = ((6, 5), (5, 3))
STEPS = 5
LR = 0.05


def _init():
    rng = np.random.default_rng(0)
    ws = [(0.5 * rng.standard_normal(s)).astype(np.float32) for s in SIZES]
    bs = [(0.1 * rng.standard_normal(s[1])).astype(np.float32)
          for s in SIZES]
    return ws + bs


def _batch(step):
    rng = np.random.default_rng(100 + step)
    return (rng.standard_normal((8, 6)).astype(np.float32),
            rng.standard_normal((8, 3)).astype(np.float32))


NAMES = ("w0", "w1", "b0", "b1")


def _port_params(arrays):
    return [(n, torch.nn.Parameter(torch.tensor(a)))
            for n, a in zip(NAMES, arrays)]


def _ref_params(arrays):
    out = []
    for name, a in zip(NAMES, arrays):
        t = P.to_tensor(a)
        t.stop_gradient = False
        t.name = name
        out.append(t)
    return out


def _loss(ps, X, y, pkg):
    w0, w1, b0, b1 = ps
    to = torch.as_tensor if pkg is T else P.to_tensor
    tanh = torch.tanh if pkg is T else P.tanh
    return (((tanh(to(X) @ w0 + b0) @ w1 + b1) - to(y)) ** 2).mean()


def _starts_b(p):
    return p.name.startswith("b")


# option -> (optimizer, its keyword arguments, a scheduler's lr)
def _options(pkg):
    cl, reg = (clip, regularizer) if pkg is T else (ref_clip, ref_reg)
    return {
        "sgd": ("SGD", {}),
        "sgd_l2": ("SGD", dict(weight_decay=reg.L2Decay(0.1))),
        "momentum": ("Momentum", dict(momentum=0.9)),
        "momentum_nesterov_rescale": ("Momentum", dict(
            momentum=0.8, use_nesterov=True, rescale_grad=0.5)),
        "momentum_l1_clip": ("Momentum", dict(
            weight_decay=reg.L1Decay(0.05),
            grad_clip=cl.ClipGradByGlobalNorm(0.05))),
        "lars_exclude": ("LarsMomentum", dict(
            lars_coeff=0.02, lars_weight_decay=0.01,
            exclude_from_weight_decay=["b"])),
        "lars_rescale": ("LarsMomentumOptimizer", dict(
            momentum=0.5, lars_coeff=0.02, epsilon=1e-4, rescale_grad=2.0)),
        "rmsprop": ("RMSProp", dict(rho=0.9)),
        "rmsprop_centered": ("RMSProp", dict(
            rho=0.9, momentum=0.5, centered=True, weight_decay=0.01)),
        "adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
        "adadelta_l2": ("Adadelta", dict(rho=0.9,
                                         weight_decay=reg.L2Decay(0.05))),
        "adamax_clip": ("Adamax", dict(beta2=0.99,
                                       grad_clip=cl.ClipGradByValue(0.05))),
        "lamb_exclude": ("Lamb", dict(lamb_weight_decay=0.05,
                                      exclude_from_weight_decay_fn=_starts_b)),
        "lamb_clip_scheduler": ("Lamb", dict(
            grad_clip=cl.ClipGradByGlobalNorm(0.05), scheduler=True)),
        "momentum_scheduler": ("Momentum", dict(scheduler=True)),
    }


def _make(pkg, option, params):
    """(optimizer, scheduler or None) of ``option`` over ``params``."""
    cls, kw = _options(pkg)[option]
    kw = dict(kw)
    sched = None
    lr = LR
    if kw.pop("scheduler", False):
        mod = port_lr if pkg is T else ref_lr
        sched = lr = mod.StepDecay(learning_rate=LR, step_size=2, gamma=0.5)
    return getattr(pkg.optimizer, cls)(learning_rate=lr, parameters=params,
                                       **kw), sched


def _train(pkg, opt, sched, ps, steps, first=0):
    for i in range(first, first + steps):
        opt.clear_grad()
        X, y = _batch(i)
        _loss(ps, X, y, pkg).backward()
        opt.step()
        if sched is not None:
            sched.step()


def _run_port(option, arrays, steps=STEPS):
    named = _port_params(arrays)
    opt, sched = _make(T, option, named)
    ps = [p for _, p in named]
    _train(T, opt, sched, ps, steps)
    return opt, sched, ps


def _run_ref(option, arrays, steps=STEPS):
    ps = _ref_params(arrays)
    opt, sched = _make(P, option, ps)
    _train(P, opt, sched, ps, steps)
    return opt, sched, ps


def _close(got, want):
    """Each tensor within 1e-6 of its largest magnitude."""
    for g, w, name in zip(got, want, NAMES):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        w = np.asarray(w._value) if hasattr(w, "_value") else np.asarray(w)
        err = np.abs(g - w).max()
        assert err <= 1e-6 * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("option", list(_options(T)))
def test_optimizer_matches_reference(option):
    init = _init()
    _, _, got = _run_port(option, init)
    _, _, want = _run_ref(option, init)
    _close(got, want)
    for g, a in zip(got, init):
        assert not np.array_equal(g.detach().numpy(), a)   # it trained


@pytest.mark.parametrize("option", ["lars_exclude", "lamb_exclude"])
def test_exclusions_select_the_biases(option):
    """The same exclusion selects the same parameters in both packages:
    without it the biases end elsewhere, the weights' updates stay
    weight-only."""
    init = _init()
    _, _, excluded = _run_port(option, init)
    named = _port_params(init)
    cls, kw = _options(T)[option]
    kw = {k: v for k, v in kw.items() if not k.startswith("exclude")}
    opt = getattr(T.optimizer, cls)(learning_rate=LR, parameters=named, **kw)
    ps = [p for _, p in named]
    _train(T, opt, None, ps, STEPS)
    moved = [not torch.equal(a, b) for a, b in zip(excluded, ps)]
    assert moved[2] and moved[3]           # the biases lost their decay


@pytest.mark.parametrize("option", ["momentum_nesterov_rescale",
                                    "lars_exclude", "rmsprop_centered",
                                    "adagrad", "adadelta_l2", "adamax_clip",
                                    "lamb_exclude", "lamb_clip_scheduler"])
def test_state_dict_crosses_from_the_reference(option):
    """The reference's accumulators (and its scheduler's epoch) after 3
    steps load into the port by name, and the next step agrees."""
    init = _init()
    ref_opt, ref_sched, ref_ps = _run_ref(option, init, steps=3)
    port_opt, port_sched, port_ps = _run_port(option, init, steps=3)
    sd = ref_opt.state_dict()
    assert set(port_opt.state_dict()) - {"LR_Scheduler"} == \
        set(sd) - {"LR_Scheduler"}
    with torch.no_grad():
        for p, r in zip(port_ps, ref_ps):
            p.copy_(torch.tensor(np.asarray(r._value)))
    port_opt.set_state_dict({k: (v if k == "LR_Scheduler"
                                 else np.array(v._value))
                             for k, v in sd.items()})
    for k, v in port_opt.state_dict().items():
        if k != "LR_Scheduler":
            np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]._value))
    _train(T, port_opt, port_sched, port_ps, 1, first=3)
    _train(P, ref_opt, ref_sched, ref_ps, 1, first=3)
    _close(port_ps, ref_ps)


@pytest.mark.parametrize("option", list(_options(T)) + ["merge"])
def test_to_static_equals_eager(option):
    """3 ``to_static`` calls against 3 eager steps from the same weights:
    weights and every accumulator bit-identical, one cache entry."""
    init = _init()
    runs = []
    for captured in (False, True):
        named = _port_params(init)
        if option == "merge":
            opt = T.optimizer.GradientMergeOptimizer(
                T.optimizer.Momentum(learning_rate=LR, parameters=named),
                k_steps=2)
        else:
            opt, _ = _make(T, option, named)
        ps = [p for _, p in named]

        def raw(X, y):
            opt.clear_grad()
            loss = _loss(ps, X, y, T)
            loss.backward()
            opt.step()
            return loss

        step = T.jit.to_static(raw) if captured else raw
        for i in range(3):
            step(*(torch.tensor(a) for a in _batch(i)))
        if captured:
            assert len(step._compiled) == 1
        runs.append(([p.detach().clone() for p in ps],
                     {k: v.clone() for k, v in opt.state_dict().items()
                      if k != "LR_Scheduler"}))
    (w_eager, s_eager), (w_cap, s_cap) = runs
    assert all(torch.equal(a, b) for a, b in zip(w_eager, w_cap))
    assert sorted(s_eager) == sorted(s_cap)
    assert all(torch.equal(s_eager[k], s_cap[k]) for k in s_eager)


def test_guard_covers_sgd():
    """The generic guard around SGD's update (the counterpart of
    ``tests/test_sentinel.py:159``): an inf gradient keeps that
    parameter, the rest move, and both packages give the same verdict."""
    init = _init()
    summaries = []
    for pkg in (T, P):
        ps = [p for _, p in _port_params(init)] if pkg is T \
            else _ref_params(init)
        opt = pkg.optimizer.SGD(
            learning_rate=LR, guard=True,
            parameters=list(zip(NAMES, ps)) if pkg is T else ps)
        X, y = _batch(0)
        _loss(ps, X, y, pkg).backward()
        if pkg is T:
            ps[0].grad.fill_(float("inf"))
        else:
            ps[0].grad._set_value(ps[0].grad._value * np.inf)
        opt.step()
        after = [p.detach().numpy() if pkg is T else np.asarray(p._value)
                 for p in ps]
        np.testing.assert_array_equal(after[0], init[0])
        assert all(not np.array_equal(a, b)
                   for a, b in zip(after[1:], init[1:]))
        s = opt.guard_summary()
        summaries.append((s.good, s.bad_regions, s.regions))
    assert summaries[0] == summaries[1] == (False, 1, 4)


@pytest.mark.parametrize("k,avg", [(1, True), (2, True), (2, False),
                                   (3, True), (3, False)])
def test_gradient_merge_matches_reference(k, avg):
    """6 steps of ``GradientMergeOptimizer(Adam, k, avg)`` under a
    global-norm clip (which measures the merged gradient): weights and
    the merge state against the reference's; between firings the
    weights do not move."""
    init = _init()
    out = []
    for pkg in (T, P):
        cl = clip if pkg is T else ref_clip
        ps = [p for _, p in _port_params(init)] if pkg is T \
            else _ref_params(init)
        inner = pkg.optimizer.Adam(
            learning_rate=LR, grad_clip=cl.ClipGradByGlobalNorm(0.05),
            parameters=list(zip(NAMES, ps)) if pkg is T else ps)
        opt = pkg.optimizer.GradientMergeOptimizer(inner, k_steps=k, avg=avg)
        moved = []
        for i in range(6):
            before = [np.array(p.detach().numpy() if pkg is T
                               else np.asarray(p._value)) for p in ps]
            _train(pkg, opt, None, ps, 1, first=i)
            now = [p.detach().numpy() if pkg is T else np.asarray(p._value)
                   for p in ps]
            moved.append(not np.array_equal(now[0], before[0]))
        out.append((ps, moved, opt.state_dict()))
    (got, moved, sd), (want, ref_moved, ref_sd) = out
    _close(got, want)
    assert moved == ref_moved == [(i + 1) % k == 0 for i in range(6)]
    if k > 1:
        assert int(sd["learning_rate_gm_count"]) == 6
        for name in NAMES:
            key = f"{name}_gm_acc"
            np.testing.assert_allclose(sd[key].numpy(),
                                       np.asarray(ref_sd[key]._value),
                                       rtol=0, atol=1e-6)


def test_gradient_merge_over_the_fused_update():
    """The fused AdamW writes p, m and v in place: the merge's snapshot
    keeps a non-firing step from moving them, and the result equals the
    unfused inner update's."""
    init = _init()
    runs = []
    for fused in (False, True):
        named = _port_params(init)
        ps = [p for _, p in named]
        opt = T.optimizer.GradientMergeOptimizer(
            T.optimizer.AdamW(learning_rate=LR, parameters=named,
                              fused=fused), k_steps=2)
        _train(T, opt, None, ps, 1)
        assert all(torch.equal(p.detach(), torch.tensor(a))
                   for p, a in zip(ps, init))
        assert all(not v.any() for k, v in opt.state_dict().items()
                   if k.endswith(("moment1", "moment2")))
        _train(T, opt, None, ps, 3, first=1)
        runs.append([p.detach().clone() for p in ps])
    _close(runs[1], [r.numpy() for r in runs[0]])
