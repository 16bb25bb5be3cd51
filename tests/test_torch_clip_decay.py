"""paddle_tpu_torch's gradient clipping, coupled decay, lr multipliers,
``GradScaler`` and ``amp.debugging`` against paddle_tpu's: a two-layer
MLP from shared weights trains 3 steps through each package's
optimizer with each option, and the weights after them are compared;
the clip functions on gradients, the scaler's scale, unscale, skip and
update, and the NaN/Inf checks likewise.

Tolerances: weights within rtol 1e-5 / atol 1e-6 after 3 steps (the
same f32 arithmetic, reductions summed in another order); scales, step
counts and NaN/Inf counts exact.
"""
import numpy as np
import pytest
import torch

import jax

import paddle_tpu as P
from paddle_tpu import regularizer as ref_reg
from paddle_tpu.amp import debugging as ref_debugging
from paddle_tpu.nn import clip as ref_clip

import paddle_tpu_torch as T
from paddle_tpu_torch import regularizer
from paddle_tpu_torch.amp import debugging
from paddle_tpu_torch.nn import clip

SIZES = ((6, 5), (5, 3))


def _init():
    rng = np.random.default_rng(0)
    ws = [(0.5 * rng.standard_normal(s)).astype(np.float32) for s in SIZES]
    bs = [(0.1 * rng.standard_normal(s[1])).astype(np.float32)
          for s in SIZES]
    X = rng.standard_normal((8, 6)).astype(np.float32)
    y = rng.standard_normal((8, 3)).astype(np.float32)
    return ws, bs, X, y


def _port_params(ws, bs):
    out = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        out += [(f"w{i}", torch.nn.Parameter(torch.tensor(w))),
                (f"b{i}", torch.nn.Parameter(torch.tensor(b)))]
    return out


def _ref_params(ws, bs):
    out = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        for name, a in ((f"w{i}", w), (f"b{i}", b)):
            t = P.to_tensor(a)
            t.stop_gradient = False
            t.name = name
            out.append((name, t))
    return out


def _forward(ps, X, tanh):
    w0, b0, w1, b1 = ps
    return tanh(X @ w0 + b0) @ w1 + b1


# option name -> (optimizer class, its keyword arguments, parameter attributes)
def _options(pkg_clip, pkg_reg):
    return {
        "clip_value": ("AdamW", dict(grad_clip=pkg_clip.ClipGradByValue(
            0.02)), {}),
        "clip_value_min": ("Adam", dict(grad_clip=pkg_clip.ClipGradByValue(
            0.05, min=-0.01)), {}),
        "clip_norm": ("AdamW", dict(grad_clip=pkg_clip.ClipGradByNorm(
            0.05)), {}),
        "clip_global_norm": ("AdamW", dict(
            grad_clip=pkg_clip.ClipGradByGlobalNorm(0.05)),
            {"b1": {"need_clip": False}}),
        "decay_float": ("Adam", dict(weight_decay=0.1), {}),
        "decay_l2": ("Adam", dict(weight_decay=pkg_reg.L2Decay(0.1)), {}),
        "decay_l1": ("Adam", dict(weight_decay=pkg_reg.L1Decay(0.1)), {}),
        "param_regularizer": ("Adam", dict(
            weight_decay=pkg_reg.L2Decay(0.1)),
            {"w0": {"regularizer": pkg_reg.L1Decay(0.3)},
             "b0": {"regularizer": pkg_reg.L2Decay(0.5)}}),
        "lr_ratio": ("AdamW", dict(
            lr_ratio=lambda p: 0.5 if len(p.shape) == 1 else 2.0), {}),
        "optimize_attr": ("AdamW", {}, {
            "w1": {"optimize_attr": {"learning_rate": 0.25}}}),
        "fused_clip_lr_ratio": ("AdamW", dict(
            fused=True, grad_clip=pkg_clip.ClipGradByGlobalNorm(0.1),
            lr_ratio=lambda p: 0.5),
            {"w0": {"optimize_attr": {"learning_rate": 3.0}}}),
    }


def _run_port(option, ws, bs, X, y):
    cls, kw, attrs = _options(clip, regularizer)[option]
    named = _port_params(ws, bs)
    for name, p in named:
        for k, v in attrs.get(name, {}).items():
            setattr(p, k, v)
    opt = getattr(T.optimizer, cls)(learning_rate=0.05, parameters=named,
                                    **kw)
    ps = [p for _, p in named]
    for _ in range(3):
        opt.clear_grad()
        loss = ((_forward(ps, torch.tensor(X), torch.tanh)
                 - torch.tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
    return [p.detach().numpy() for p in ps]


def _run_ref(option, ws, bs, X, y):
    cls, kw, attrs = _options(ref_clip, ref_reg)[option]
    named = _ref_params(ws, bs)
    for name, p in named:
        for k, v in attrs.get(name, {}).items():
            setattr(p, k, v)
    ps = [p for _, p in named]
    opt = getattr(P.optimizer, cls)(learning_rate=0.05, parameters=ps, **kw)
    for _ in range(3):
        opt.clear_grad()
        loss = ((_forward(ps, P.to_tensor(X), P.tanh)
                 - P.to_tensor(y)) ** 2).mean()
        loss.backward()
        opt.step()
    return [np.asarray(p._value) for p in ps]


@pytest.mark.parametrize("option", list(_options(clip, regularizer)))
def test_optimizer_option_matches_reference(option):
    ws, bs, X, y = _init()
    got = _run_port(option, ws, bs, X, y)
    want = _run_ref(option, ws, bs, X, y)
    plain = _run_port("optimize_attr", ws, bs, X, y) \
        if option != "optimize_attr" else None
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    if plain is not None:          # the option acted
        assert any(not np.allclose(g, q) for g, q in zip(got, plain))


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_clip_grad_functions_match_reference(norm_type):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    port = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    ref = [P.to_tensor(np.zeros(g.shape, np.float32)) for g in grads]
    for p, r, g in zip(port, ref, grads):
        p.grad = torch.tensor(g)
        r.grad = P.to_tensor(g)
    total = clip.clip_grad_norm_(port, 1.5, norm_type=norm_type)
    want = ref_clip.clip_grad_norm_(ref, 1.5, norm_type=norm_type)
    np.testing.assert_allclose(total.item(), float(want), rtol=1e-6)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r.grad._value),
                                   rtol=1e-6, atol=1e-7)
    clip.clip_grad_value_(port, 0.1)
    ref_clip.clip_grad_value_(ref, 0.1)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r.grad._value),
                                   rtol=1e-6, atol=1e-7)
    assert clip.clip_grad_norm_([torch.zeros(2)], 1.0) is None


def _scaler_run(pkg, scaler, ps, X, y, blowups):
    """4 steps; a step in ``blowups`` scales its loss by 1e38 (the scaled
    gradients overflow to inf)."""
    opt = pkg.optimizer.Adam(learning_rate=0.05, parameters=ps)
    to = torch.tensor if pkg is T else P.to_tensor
    tanh = torch.tanh if pkg is T else P.tanh
    scales, found = [], []
    for i in range(4):
        opt.clear_grad()
        loss = ((_forward(ps, to(X), tanh) - to(y)) ** 2).mean()
        if i in blowups:
            loss = loss * 1e38
        scaler.scale(loss).backward()
        scaler.step(opt)
        scales.append(scaler.get_init_loss_scaling())
        found.append(scaler._found_inf)
    return scales, found


def test_grad_scaler_matches_reference():
    """Scale, unscale, skip (a step whose gradients overflow leaves the
    weights alone and halves the scale), and the dynamic update (doubled
    after 2 good steps), against the reference's scaler."""
    ws, bs, X, y = _init()
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=2)
    port = [p for _, p in _port_params(ws, bs)]
    ref = [p for _, p in _ref_params(ws, bs)]
    got = _scaler_run(T, T.amp.GradScaler(**kw), port, X, y, {2})
    want = _scaler_run(P, P.amp.GradScaler(**kw), ref, X, y, {2})
    assert got == want == ([1024.0, 2048.0, 1024.0, 1024.0],
                           [False, False, True, False])
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r._value),
                                   rtol=1e-5, atol=1e-6)
    off = T.amp.GradScaler(enable=False)
    t = torch.ones(2)
    assert off.scale(t) is t and not off.is_enable()
    sd = T.amp.GradScaler(**kw).state_dict()
    assert float(sd["scale"]) == 1024.0 and sd["good_steps"] == 0


def test_debugging_matches_reference():
    bad = np.array([1.0, np.nan, np.inf, -np.inf, np.nan], np.float32)
    assert debugging.compute_nan_inf_count(torch.tensor(bad)) == \
        ref_debugging.compute_nan_inf_count(P.to_tensor(bad)) == (2, 2)
    with pytest.raises(FloatingPointError, match="2 NaN, 2 Inf"):
        debugging.check_numerics(torch.tensor(bad), "matmul", "x")
    with pytest.raises(FloatingPointError, match="2 NaN, 2 Inf"):
        ref_debugging.check_numerics(P.to_tensor(bad), "matmul", "x")
    ok = torch.ones(3)
    assert debugging.check_numerics(ok) is ok
    assert debugging.compute_nan_inf_count(torch.arange(3)) == (0, 0)
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig())
    try:
        torch.ones(2) + 1.0
        with pytest.raises(FloatingPointError, match="NaN in the output"):
            torch.log(torch.tensor([-1.0]))
    finally:
        debugging.disable_tensor_checker()
    torch.log(torch.tensor([-1.0]))            # off again
    with debugging.check_nan_inf():
        with pytest.raises(FloatingPointError):
            torch.zeros(1) / torch.zeros(1)
    ref_debugging.enable_tensor_checker(ref_debugging.TensorCheckerConfig())
    try:
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(P.log(P.to_tensor([-1.0]))._value)
    finally:
        ref_debugging.disable_tensor_checker()
