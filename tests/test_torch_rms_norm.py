"""paddle_tpu_torch RMSNorm: the kernel's plain version against the
reference's Pallas kernel (``fused_rms_norm``, interpret mode on the
CPU), the autograd Function against ``jax.vjp`` of the reference's custom
VJP, ``F.rms_norm`` (fused and not) against ``paddle_tpu``'s with values
and dtypes, ``nn.RMSNorm`` from a ``paddle_tpu`` state dict, and the
no-fallback contract of the CUDA wrapper.

Tolerances: f32 at atol = rtol = 1e-6 (the f32 row sum runs in another
order); bf16 outputs within one bf16 ulp of their magnitude (plus 1e-6
near zero); gradients within 1e-5 of each tensor's largest magnitude.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.nn import functional as PF
from paddle_tpu.ops.pallas import norm as pallas_norm

from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import build, norm

EPS = 1e-6
ROWS = 37            # ragged against the reference's 128-row blocks


def _data(hidden, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, hidden)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    g = rng.standard_normal((ROWS, hidden)).astype(np.float32)
    return x, w, g


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of `dtype`."""
    if a is None:
        return None, None
    if dtype == "bfloat16":
        return jnp.asarray(a).astype(jnp.bfloat16), \
            torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.tensor(a)


def _assert_close(got, want, dtype, atol=1e-6):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got - want)
    if dtype == "bfloat16":
        mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                         np.finfo(np.float32).tiny)
        tol = np.exp2(np.floor(np.log2(mag)) - 7) + atol
    else:
        tol = atol + atol * np.abs(want)
    assert (err <= tol).all(), f"max abs err {err.max()}"


def _assert_grad(got, want, rel=1e-5):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), f"max abs err {err}"


@pytest.mark.parametrize("hidden", [64, 1000])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "float32"), ("float32", None), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16"), ("bfloat16", None)])
def test_rms_fwd_matches_pallas_kernel(hidden, x_dtype, w_dtype):
    x, w, _ = _data(hidden)
    jx, tx = _pair(x, x_dtype)
    jw, tw = _pair(None if w_dtype is None else w, w_dtype)
    want = pallas_norm.fused_rms_norm(jx, jw, EPS, None, True)
    got = norm.rms_fwd(tx, tw, EPS)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert str(want.dtype) == str(got.dtype).split(".")[1]
    _assert_close(got, want, x_dtype)


@pytest.mark.parametrize("x_dtype,weighted", [
    ("float32", True), ("float32", False), ("bfloat16", True)])
def test_rms_function_grads_match_jax(x_dtype, weighted):
    """The Function's backward (the plain form of ``_rms_bwd_rule``)
    against jax.vjp of the reference's fused_rms_norm, with a leading
    axis so dw sums over every leading axis; bf16 x with an f32 weight as
    the bf16 policy hands it: dx bf16, dw f32."""
    x, w, g = _data(64, seed=1)
    shape = (1, ROWS, 64)
    jx, tx = _pair(x.reshape(shape), x_dtype)
    jw, tw = _pair(w if weighted else None, "float32")
    jg, tg = _pair(g.reshape(shape), x_dtype)
    args = (jx, jw) if weighted else (jx,)
    _, vjp = jax.vjp(lambda *a: pallas_norm.fused_rms_norm(
        a[0], a[1] if weighted else None, EPS, None, True), *args)
    want = vjp(jg)
    leaves = [tx.requires_grad_()] + ([tw.requires_grad_()] if weighted
                                      else [])
    out = norm.rms_fwd(tx, tw if weighted else None, EPS)
    out.backward(tg)
    assert tx.grad.dtype == tx.dtype
    rel = 1e-5 if x_dtype == "float32" else 2.0 ** -7   # dx rounded to bf16
    _assert_grad(tx.grad, want[0], rel)
    if weighted:
        assert tw.grad.dtype == torch.float32 and str(want[1].dtype) == \
            "float32"
        _assert_grad(tw.grad, want[1])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_functional_rms_norm_matches_reference(fused, x_dtype):
    """Values and dtypes: the composition rounds to x's type before the
    f32 weight multiplies, so bf16 x gives f32 there; the fused path
    returns x's type."""
    x, w, _ = _data(64, seed=2)
    jx, tx = _pair(x, x_dtype)
    want = PF.rms_norm(P.to_tensor(jx), P.to_tensor(w), EPS, fused=fused)
    got = F.rms_norm(tx, torch.tensor(w), EPS, fused=fused)
    want_dtype = str(want._value.dtype)
    assert str(got.dtype).split(".")[1] == want_dtype
    assert want_dtype == ("float32" if not fused or x_dtype == "float32"
                          else "bfloat16")
    _assert_close(got, want._value, want_dtype)


def test_rms_norm_layer_loads_reference_state_dict():
    ref = P.nn.RMSNorm(64, epsilon=EPS)
    x, w, _ = _data(64, seed=3)
    ref.weight.set_value(w)
    state = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    layer = nn.RMSNorm(64, epsilon=EPS)
    assert [k for k, _ in layer.named_parameters()] == ["weight"]
    assert bool((layer.weight == 1.0).all())
    load_numpy_state_dict(layer, state)
    want = ref(P.to_tensor(x))
    for fused in (False, True):
        layer._fused = fused
        _assert_close(layer(torch.tensor(x)), want._value, "float32")


def test_fused_default_follows_the_tensor_device(monkeypatch):
    calls = []
    monkeypatch.setattr(norm, "rms_fwd", lambda *a: calls.append(a) or a[0])
    x = torch.zeros(2, 64)
    F.rms_norm(x, torch.ones(64))
    assert not calls
    F.rms_norm(x, torch.ones(64), fused=True)
    assert len(calls) == 1


def test_cuda_request_raises_without_toolkit(monkeypatch, tmp_path):
    """A tensor routed to the kernel never reaches the plain version:
    with no nvcc the wrapper raises; a width the kernel does not take
    raises with the limit before any build."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*a, **k):
        raise AssertionError("plain version reached on the CUDA route")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(norm, "_route_rms", lambda *t: "cuda")
    monkeypatch.setattr(norm, "_rms_fwd_ref", plain_called)
    x, w, _ = (torch.tensor(a) for a in _data(64))
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.rms_fwd(x, w)
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.rms_fwd(x, None)
    with pytest.raises(ValueError, match="at most 16384"):
        norm.rms_fwd(torch.zeros(2, norm.MAX_RMS_HIDDEN + 8))
    with pytest.raises(ValueError, match="multiple of 8"):
        norm.rms_fwd(torch.zeros(2, 100))
    assert norm.LAUNCHES["rms_fwd"] == 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="no RMSNorm kernel"):
        norm.rms_fwd(torch.empty(2, 64, device="meta"))


def test_rms_norm_past_the_kernel_limit_matches_reference():
    """A hidden size the kernel does not take (past MAX_RMS_HIDDEN) goes
    to the composition before any launch, counted in ROUTED, even with
    fused=True; it equals the reference's fused result, f32 at 1e-5."""
    hidden = norm.MAX_RMS_HIDDEN + 8
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, hidden)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(hidden)).astype(np.float32)
    before = norm.ROUTED["rms_norm"]
    want = PF.rms_norm(P.to_tensor(x), P.to_tensor(w), EPS, fused=True)
    got = F.rms_norm(torch.tensor(x), torch.tensor(w), EPS, fused=True)
    assert norm.ROUTED["rms_norm"] == before + 1
    assert norm.LAUNCHES["rms_fwd"] == 0
    _assert_close(got, want._value, "float32")
