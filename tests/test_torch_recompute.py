"""paddle_tpu_torch's recompute against paddle_tpu's: a region with
dropout replays its forward's masks in the backward (outputs, input
gradients and the key after it equal to the plain run's and the
reference's recompute), ``GPTConfig(use_recompute=True)`` and
``to_static(remat=True | "bf16")`` on ``gpt3_tiny`` at its dropout
defaults, ``enable_recompute`` per layer and ``recompute_sequential``.

Tolerances, the reference's own for its recompute: a region against the
plain run within 1e-6 (``tests/test_resnet_remat.py``), ``remat="bf16"``
within 0.05 of the plain run (``tests/test_bytesopt.py``); the port
against the reference within 1e-5 (f32, the same arithmetic in another
order), keys exact.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as PF
from paddle_tpu.distributed.recompute import recompute as ref_recompute
from paddle_tpu.framework import state as ref_state
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny

import paddle_tpu_torch as T
from paddle_tpu_torch.distributed import (enable_recompute, recompute,
                                          recompute_sequential)
from paddle_tpu_torch.framework.io import load_numpy_state_dict, numpy_grads
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import functional as F

VOCAB = 256


class _Drop(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.lin = T.nn.Linear(8, 8, device="cpu")
        load_numpy_state_dict(self.lin, {"weight": w, "bias": b})

    def forward(self, x):
        return F.dropout(torch.relu(self.lin(x)), p=0.5, training=True)


class _RefDrop(P.nn.Layer):
    def __init__(self, w, b):
        super().__init__()
        self.lin = P.nn.Linear(8, 8)
        self.lin.set_state_dict({"weight": w, "bias": b})

    def forward(self, x):
        return PF.dropout(PF.relu(self.lin(x)), p=0.5, training=True)


def _key():
    return T.get_rng_state().tolist()


def test_recompute_replays_the_forward_masks():
    """A Linear + ReLU + dropout region: its output, the input's and the
    weight's gradients and the key after the backward equal the plain
    run's and the reference's recompute for the same seed; the key
    advances once a draw, so two regions draw two masks."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    x0 = rng.standard_normal((4, 8)).astype(np.float32)

    def run(use_recompute):
        T.seed(123)
        m = _Drop(w, b)
        x = torch.tensor(x0, requires_grad=True)
        out = recompute(m, x) if use_recompute else m(x)
        out.sum().backward()
        return out.detach().numpy(), x.grad.numpy(), \
            m.lin.weight.grad.numpy(), _key()

    ref_m = _RefDrop(w, b)           # its initializers draw from the key
    P.seed(123)
    rx = P.to_tensor(x0)
    rx.stop_gradient = False
    ref_out = ref_recompute(ref_m, rx)
    ref_out.sum().backward()
    plain, rc = run(False), run(True)
    for a, c in zip(plain[:3], rc[:3]):
        np.testing.assert_allclose(c, a, atol=1e-6)
    np.testing.assert_allclose(rc[0], np.asarray(ref_out._value), atol=1e-6)
    np.testing.assert_allclose(rc[1], np.asarray(rx.grad._value), atol=1e-6)
    assert rc[3] == plain[3] == np.asarray(
        ref_state.get_rng_state()).astype(np.int64).tolist()
    m = _Drop(w, b)
    x = torch.ones(64, 8)
    with torch.enable_grad():
        a, c = recompute(m, x), recompute(m, x)
    assert not torch.equal(a, c)


def _gpt(remat_cfg=False, fused_ln=False):
    return GPTForCausalLM(gpt3_tiny(dropout=0.1, attention_dropout=0.1,
                                    use_recompute=remat_cfg,
                                    fused_ln=fused_ln), device="cpu")


@pytest.mark.parametrize("fused_ln", [False, True])
def test_use_recompute_gradients_equal_the_plain_run(fused_ln):
    """``GPTConfig(use_recompute=True)``: every decoder block a region;
    one eager step's loss and every gradient equal the plain model's
    from the same weights and seed (within 1e-6), and the key after it."""
    plain, rc = _gpt(fused_ln=fused_ln), _gpt(True, fused_ln)
    rc.load_state_dict(plain.state_dict())
    ids = torch.tensor(np.random.default_rng(1).integers(0, VOCAB, (2, 16)))
    out = []
    for m in (plain, rc):
        T.seed(9)
        loss = F.cross_entropy(m(ids).reshape([-1, VOCAB]),
                               ids.reshape([-1]))
        loss.backward()
        out.append((loss.item(), numpy_grads(m), _key()))
    assert abs(out[0][0] - out[1][0]) <= 1e-6
    assert out[0][2] == out[1][2]
    assert out[0][1].keys() == out[1][1].keys()
    for k, g in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k], g, atol=1e-6, err_msg=k)
    with pytest.raises(RuntimeError, match="eval mode"):
        rc(ids, kv_ctx=object())


@pytest.fixture(scope="module")
def reference_remat_run():
    """paddle_tpu's ``to_static(remat=True)`` step at the dropout
    defaults (gpt3_tiny cut to one layer): initial weights, batch, 3
    losses and the key after each."""
    P.seed(0)
    model = RefGPT(ref_tiny(dropout=0.1, attention_dropout=0.1,
                            num_layers=1))
    opt = P.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters())

    @P.jit.to_static(remat=True)
    def step(ids, labels):
        opt.clear_grad()
        loss = PF.cross_entropy(model(ids).reshape([-1, VOCAB]),
                                labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    init = {k: np.asarray(t._value) for k, t in model.state_dict().items()}
    rng = np.random.default_rng(3)
    ids, labels = (rng.integers(0, VOCAB, (2, 16)) for _ in range(2))
    P.seed(7)
    losses, keys = [], []
    for _ in range(3):
        losses.append(float(step(P.to_tensor(ids, dtype="int64"),
                                 P.to_tensor(labels, dtype="int64"))))
        keys.append(np.asarray(ref_state.get_rng_state()).astype(
            np.int64).tolist())
    return init, ids, labels, losses, keys


def _port_losses(init, ids, labels, remat):
    model = GPTForCausalLM(gpt3_tiny(dropout=0.1, attention_dropout=0.1,
                                     num_layers=1), device="cpu")
    load_numpy_state_dict(model, init)
    opt = T.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters())

    @T.jit.to_static(remat=remat)
    def step(ids, labels):
        opt.clear_grad()
        loss = F.cross_entropy(model(ids).reshape([-1, VOCAB]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    T.seed(7)
    losses, keys = [], []
    for _ in range(3):
        losses.append(step(torch.tensor(ids), torch.tensor(labels)).item())
        keys.append(_key())
    return losses, keys


def test_to_static_remat_matches_reference(reference_remat_run):
    """3 ``to_static(remat=...)`` steps: ``remat=True`` within 1e-6 of
    the port's plain run and 1e-5 of the reference's ``remat=True``
    run, ``"bf16"`` within 0.05 of the plain run; keys exact."""
    init, ids, labels, ref_losses, ref_keys = reference_remat_run
    plain, plain_keys = _port_losses(init, ids, labels, None)
    assert plain_keys == ref_keys
    for remat, tol in ((True, 1e-6), ("bf16", 0.05)):
        losses, keys = _port_losses(init, ids, labels, remat)
        assert keys == plain_keys
        np.testing.assert_allclose(losses, plain, atol=tol, rtol=0)
        if remat is True:
            np.testing.assert_allclose(losses, ref_losses, atol=1e-5,
                                       rtol=0)


def _mlp_losses(mode, policy=None):
    torch.manual_seed(0)
    m = torch.nn.Sequential(T.nn.Linear(16, 32, device="cpu"),
                            torch.nn.GELU(),
                            T.nn.Linear(32, 8, device="cpu"))
    if mode is not None:
        enable_recompute(m[0], mode)
    opt = T.optimizer.AdamW(learning_rate=0.01, parameters=m.parameters())
    xs = torch.tensor(np.random.default_rng(0).standard_normal(
        (4, 16)).astype(np.float32))
    losses, regions = [], []

    def loss_fn():
        return (m(xs) ** 2).mean()

    for _ in range(4):
        opt.clear_grad()
        if policy is None:
            loss = loss_fn()
        else:
            with T.amp.activation_residency(None, remat=policy):
                loss = loss_fn()
        regions.append(loss.grad_fn is not None and any(
            "Recompute" in type(n[0]).__name__ for n in _nodes(loss)))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses, regions


def _nodes(t):
    seen, todo = [], [t.grad_fn]
    while todo:
        n = todo.pop()
        for nxt, _ in n.next_functions:
            if nxt is not None:
                seen.append((nxt,))
                todo.append(nxt)
    return seen


def test_enable_recompute_per_layer():
    """A layer under ``enable_recompute(True)`` trains to the plain
    layer's losses (within 1e-6); ``"auto"`` is a region only under an
    ambient remat policy."""
    plain, _ = _mlp_losses(None)
    on, on_regions = _mlp_losses(True)
    auto_off, off_regions = _mlp_losses("auto")
    auto_on, auto_regions = _mlp_losses("auto", policy=True)
    for got in (on, auto_off, auto_on):
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
    assert all(on_regions) and all(auto_regions)
    assert not any(off_regions)
    with pytest.raises(ValueError, match="mode"):
        enable_recompute(torch.nn.Linear(2, 2), "sometimes")


def test_recompute_sequential_segments():
    """``recompute_sequential`` over 4 layers in 2 segments: output and
    every gradient equal the plain chain's; each segment's members'
    parameters get their gradients through the region."""
    torch.manual_seed(1)
    seq = torch.nn.Sequential(*[T.nn.Linear(6, 6, device="cpu")
                                for _ in range(4)])
    x = torch.randn(3, 6, requires_grad=True)
    want = seq(x)
    want.sum().backward()
    grads = [p.grad.clone() for p in seq.parameters()]
    xg = x.grad.clone()
    seq.zero_grad()
    x.grad = None
    got = recompute_sequential({"segments": 2}, seq, x)
    got.sum().backward()
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(x.grad, xg)
    for p, g in zip(seq.parameters(), grads):
        torch.testing.assert_close(p.grad, g)
