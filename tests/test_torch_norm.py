"""paddle_tpu_torch LayerNorm kernels: plain versions against the
reference's Pallas kernels (interpret mode on the CPU), the fused
dispatch, and the no-fallback contract of the CUDA wrappers.

Tolerances: f32 at atol = rtol = 1e-5 (the f32 sums run in another
order); bf16 outputs within one bf16 ulp of their magnitude, plus 1e-5
near zero where that order alone moves the rounded value.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import norm as pallas_norm
from paddle_tpu.nn import functional as PF
import paddle_tpu as P

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import build
from paddle_tpu_torch.ops.cuda import norm

HIDDEN = 128
EPS = 1e-5


def _data(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, HIDDEN)).astype(np.float32)
    r = rng.standard_normal((rows, HIDDEN)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)
    b = (0.1 * rng.standard_normal(HIDDEN)).astype(np.float32)
    return x, r, w, b


def _pair(a, dtype):
    """The same values as a jax array and a torch tensor of `dtype`."""
    if dtype == "bfloat16":
        return jnp.asarray(a).astype(jnp.bfloat16), \
            torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.tensor(a)


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got - want)
    if dtype == "bfloat16":
        mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                         np.finfo(np.float32).tiny)
        tol = np.exp2(np.floor(np.log2(mag)) - 7) + 1e-5
    else:
        tol = 1e-5 + 1e-5 * np.abs(want)
    assert (err <= tol).all(), f"max abs err {err.max()}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, 13])          # 13: ragged
def test_ln_fwd_matches_pallas_kernel(rows, dtype):
    x, _r, w, b = _data(rows)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    want = pallas_norm.fused_layer_norm(jx, jw, jb, EPS)
    got = norm.ln_fwd(tx, tw, tb, EPS)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got, want, dtype)


def test_ln_fwd_without_affine_matches_pallas_kernel():
    x, *_ = _data(13)
    want = pallas_norm.fused_layer_norm(jnp.asarray(x), None, None, EPS)
    _assert_close(norm.ln_fwd(torch.tensor(x), None, None, EPS), want,
                  "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_res_fwd_matches_pallas_kernel(act, dtype):
    x, r, w, b = _data(13, seed=1)
    (jx, tx), (jr, tr), (jw, tw), (jb, tb) = (_pair(a, dtype)
                                              for a in (x, r, w, b))
    want_h, want_y = pallas_norm.fused_ln_residual(jx, jr, jw, jb, EPS, act)
    h, y = norm.ln_res_fwd(tx, tr, tw, tb, EPS, act)
    assert h.dtype == y.dtype == tx.dtype
    _assert_close(h, want_h, dtype)
    _assert_close(y, want_y, dtype)


def test_ln_res_fwd_mixed_dtypes_promote_like_reference():
    x, r, w, b = _data(8, seed=2)
    jx, tx = _pair(x, "bfloat16")
    want_h, want_y = pallas_norm.fused_ln_residual(
        jx, jnp.asarray(r), jnp.asarray(w), jnp.asarray(b), EPS, None)
    h, y = norm.ln_res_fwd(tx, torch.tensor(r), torch.tensor(w),
                           torch.tensor(b), EPS)
    assert h.dtype == y.dtype == torch.float32
    assert str(want_h.dtype) == "float32"
    _assert_close(h, want_h, "float32")
    _assert_close(y, want_y, "float32")


@pytest.mark.parametrize("fused", [False, True])
def test_functional_layer_norm_matches_reference(fused):
    x, _r, w, b = _data(13, seed=3)
    want = PF.layer_norm(P.to_tensor(x), HIDDEN, P.to_tensor(w),
                         P.to_tensor(b), EPS, fused=fused)
    got = F.layer_norm(torch.tensor(x).reshape(13, 1, HIDDEN), HIDDEN,
                       torch.tensor(w), torch.tensor(b), EPS, fused=fused)
    _assert_close(got.reshape(13, HIDDEN), want._value, "float32")


@pytest.mark.parametrize("fused", [False, True])
def test_functional_fused_ln_residual_matches_reference(fused):
    x, r, w, b = _data(13, seed=4)
    want_h, want_y = PF.fused_ln_residual(
        P.to_tensor(x), P.to_tensor(r), P.to_tensor(w), P.to_tensor(b),
        EPS, fused=fused)
    h, y = F.fused_ln_residual(torch.tensor(x), torch.tensor(r),
                               torch.tensor(w), torch.tensor(b), EPS,
                               fused=fused)
    _assert_close(h, want_h._value, "float32")
    _assert_close(y, want_y._value, "float32")


def test_fused_default_follows_the_tensor_device(monkeypatch):
    """fused=None picks the kernel wrapper for CUDA tensors only; an
    explicit fused=True takes it for a CPU tensor too."""
    calls = []
    monkeypatch.setattr(norm, "ln_fwd",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(norm, "ln_res_fwd",
                        lambda *a: calls.append(a) or (a[0], a[0]))
    x = torch.zeros(2, HIDDEN)
    w = torch.ones(HIDDEN)
    F.layer_norm(x, HIDDEN, w)
    F.fused_ln_residual(x, x, w)
    assert not calls
    F.layer_norm(x, HIDDEN, w, fused=True)
    F.fused_ln_residual(x, x, w, fused=True)
    assert len(calls) == 2


def test_cuda_request_raises_without_toolkit(monkeypatch, tmp_path):
    """A tensor routed to the kernel never reaches the plain version:
    with no nvcc the wrapper raises."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*a, **k):
        raise AssertionError("plain version reached on the CUDA route")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(norm, "_route", lambda *t: "cuda")
    monkeypatch.setattr(norm, "_ln_fwd_ref", plain_called)
    monkeypatch.setattr(norm, "_ln_res_fwd_ref", plain_called)
    x, r, w, b = (torch.tensor(a) for a in _data(8))
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.ln_fwd(x, w, b)
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.ln_res_fwd(x, r, w, b)
    assert norm.LAUNCHES == {"ln_fwd": 0, "ln_res_fwd": 0}


def test_other_devices_and_bad_inputs_raise():
    x = torch.empty(4, HIDDEN, device="meta")
    with pytest.raises(ValueError, match="no LayerNorm kernel"):
        norm.ln_fwd(x, None, None)
    with pytest.raises(ValueError, match="act"):
        norm.ln_res_fwd(torch.zeros(2, HIDDEN), torch.zeros(2, HIDDEN),
                        torch.ones(HIDDEN), act="relu")
    with pytest.raises(ValueError, match="weight"):
        norm.ln_res_fwd(torch.zeros(2, HIDDEN), torch.zeros(2, HIDDEN), None)
    with pytest.raises(ValueError, match="multiple of 8"):
        norm._check_rows("x", torch.zeros(2, 12))
    with pytest.raises(ValueError, match="contiguous"):
        norm._check_rows("x", torch.zeros(HIDDEN, 4).t())
    with pytest.raises(TypeError, match="dtype"):
        norm._check_rows("x", torch.zeros(2, HIDDEN, dtype=torch.float16))

