"""paddle_tpu_torch LayerNorm kernels: plain versions against the
reference's Pallas kernels (interpret mode on the CPU), the autograd
Functions against ``jax.vjp`` of the reference's custom VJPs, the fused
dispatch, and the no-fallback contract of the CUDA wrappers.

Tolerances: f32 at atol = rtol = 1e-5 (the f32 sums run in another
order); bf16 outputs within one bf16 ulp of their magnitude, plus 1e-5
near zero where that order alone moves the rounded value.
"""
import numpy as np
import pytest
import torch

import jax
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
    monkeypatch.setattr(norm, "_ln_bwd_ref", plain_called)
    x, r, w, b = (torch.tensor(a) for a in _data(8))
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.ln_fwd(x, w, b)
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.ln_res_fwd(x, r, w, b)
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.ln_bwd(x, r, w, b)
    with pytest.raises(RuntimeError, match="nvcc"):
        norm.ln_bwd(x, r, w, b, gh=r)
    assert norm.LAUNCHES == {"ln_fwd": 0, "ln_res_fwd": 0, "ln_bwd": 0,
                             "ln_bwd_res": 0, "rms_fwd": 0}


def test_other_devices_and_bad_inputs_raise():
    x = torch.empty(4, HIDDEN, device="meta")
    with pytest.raises(ValueError, match="no LayerNorm kernel"):
        norm.ln_fwd(x, None, None)
    with pytest.raises(ValueError, match="act"):
        norm.ln_res_fwd(torch.zeros(2, HIDDEN), torch.zeros(2, HIDDEN),
                        torch.ones(HIDDEN), act="relu")
    with pytest.raises(ValueError, match="weight"):
        norm.ln_res_fwd(torch.zeros(2, HIDDEN), torch.zeros(2, HIDDEN), None)
    with pytest.raises(ValueError, match="weight"):
        norm.ln_bwd(torch.zeros(2, HIDDEN), torch.zeros(2, HIDDEN), None)
    with pytest.raises(ValueError, match="act"):
        norm.ln_bwd(torch.zeros(2, HIDDEN), torch.zeros(2, HIDDEN),
                    torch.ones(HIDDEN), act="relu")
    with pytest.raises(ValueError, match="multiple of 8"):
        norm._check_rows("x", torch.zeros(2, 12))
    with pytest.raises(ValueError, match="contiguous"):
        norm._check_rows("x", torch.zeros(HIDDEN, 4).t())
    with pytest.raises(TypeError, match="dtype"):
        norm._check_rows("x", torch.zeros(2, HIDDEN, dtype=torch.float16))


# ------------------------------------------------------------- backward
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual,act", [(False, None), (True, None),
                                          (True, "gelu")])
def test_ln_bwd_matches_pallas_kernel(residual, act, dtype):
    """_ln_bwd_ref against _ln_bwd_pallas (both Pallas variants) on the
    same h, gy (and gh), 13 rows: a ragged row block."""
    h, gy, w, b = _data(13, seed=5)
    gh = np.random.default_rng(6).standard_normal(h.shape).astype(np.float32)
    (jh, th), (jg, tg), (jgh, tgh) = (_pair(a, dtype) for a in (h, gy, gh))
    jw, tw = jnp.asarray(w), torch.tensor(w)
    jb, tb = jnp.asarray(b), torch.tensor(b)
    want = pallas_norm._ln_bwd_pallas(jh, jw, jb, jg,
                                      jgh if residual else None, EPS, act,
                                      None, True)
    got = norm.ln_bwd(th, tg, tw, tb, EPS, act, tgh if residual else None)
    assert got[0].dtype == th.dtype and got[1].dtype == got[2].dtype \
        == torch.float32
    _assert_close(got[0], want[0], dtype)
    for g, wnt in zip(got[1:], want[1:]):
        # dw/db: f32 sums of 13 rows of bf16-rounded products
        _assert_close(g, wnt, "float32" if dtype == "float32" else
                      "bfloat16")


@pytest.mark.parametrize("affine", ["weight_bias", "weight", "none"])
def test_layer_norm_function_grads_match_jax(affine):
    """The autograd Function of ln_fwd (the repaired wrapper) against
    jax.vjp of the reference's fused_layer_norm (its custom VJP: the
    Pallas backward kernel with a weight, the jnp composition
    without)."""
    x, g, w, b = _data(13, seed=7)
    if affine == "none":
        w = b = None
    elif affine == "weight":
        b = None
    args = [a for a in (x, w, b)]
    y, vjp = jax.vjp(lambda *t: pallas_norm.fused_layer_norm(
        *t, EPS, None, True), *[None if a is None else jnp.asarray(a)
                                for a in args])
    want = vjp(jnp.asarray(g))
    leaves = [None if a is None else torch.tensor(a).requires_grad_()
              for a in args]
    out = norm.ln_fwd(*leaves, EPS)
    _assert_close(out.detach(), y, "float32")
    out.backward(torch.tensor(g))
    for t, wnt in zip(leaves, want):
        if t is None:
            assert wnt is None
        else:
            _assert_close(t.grad, wnt, "float32")


@pytest.mark.parametrize("h_used", [True, False])
@pytest.mark.parametrize("act", [None, "gelu"])
def test_ln_residual_function_grads_match_jax(act, h_used):
    """The autograd Function of ln_res_fwd against jax.vjp of the
    reference's fused_ln_residual; an unused h (no cotangent) takes the
    plain backward, as a zero cotangent does in the reference."""
    x, r, w, b = _data(13, seed=8)
    rng = np.random.default_rng(9)
    ch = rng.standard_normal(x.shape).astype(np.float32)
    cy = rng.standard_normal(x.shape).astype(np.float32)
    if not h_used:
        ch = np.zeros_like(ch)
    _, vjp = jax.vjp(lambda *t: pallas_norm.fused_ln_residual(
        *t, EPS, act, None, True), *map(jnp.asarray, (x, r, w, b)))
    want = vjp((jnp.asarray(ch), jnp.asarray(cy)))
    leaves = [torch.tensor(a).requires_grad_() for a in (x, r, w, b)]
    h, y = norm.ln_res_fwd(*leaves, EPS, act)
    if h_used:
        torch.autograd.backward([h, y], [torch.tensor(ch), torch.tensor(cy)])
    else:
        y.backward(torch.tensor(cy))
    for t, wnt in zip(leaves, want):
        _assert_close(t.grad, wnt, "float32")


def test_ln_residual_grads_take_the_input_dtypes():
    """dx and dres come back in the types of x and residual
    (_ln_res_bwd_rule), whatever the promoted type of h."""
    x, r, w, b = _data(8, seed=10)
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_()
    tr = torch.tensor(r).requires_grad_()
    tw = torch.tensor(w).requires_grad_()
    h, y = norm.ln_res_fwd(tx, tr, tw, None, EPS)
    assert h.dtype == y.dtype == torch.float32
    (y.sum() + h.sum()).backward()
    assert tx.grad.dtype == torch.bfloat16
    assert tr.grad.dtype == tw.grad.dtype == torch.float32


# ------------------------------------------- ln_bwd's host-side row split
@pytest.mark.parametrize("rows,hidden,sms", [
    (4096, 2048, 132),      # the training path on an H100
    (4097, 2048, 132),      # one row past it: a ragged last block
    (8, 2048, 132),
    (4096, 1024, 132),      # 4 rows a block at once
    (4096, 4096, 132),      # one row a block, 512 threads
    (1, 8, 132),
    (12345, 136, 114),
])
def test_ln_bwd_split_covers_every_row_once(rows, hidden, sms):
    slots, per_block, n_blocks = norm.ln_bwd_split(rows, hidden, sms)
    per_slot = -(-hidden // 8 // 32) * 32
    assert 1 <= slots and slots * per_slot <= 512
    assert per_block % slots == 0
    assert n_blocks <= max(2 * sms, 1) or per_block == slots
    seen = []
    for blk in range(n_blocks):             # the kernel's walk of its rows
        r0, r1 = blk * per_block, min(rows, (blk + 1) * per_block)
        assert r0 < r1
        steps = -(-(r1 - r0) // slots)
        for step in range(steps):
            for slot in range(slots):
                row = r0 + step * slots + slot
                if row < r1:
                    seen.append(row)
    assert sorted(seen) == list(range(rows))


# ------------------------------------------- the forwards' row split
@pytest.mark.parametrize("sms", [132, 114])            # H100 SXM, PCIe
@pytest.mark.parametrize("hidden", [8, 2048, 4096])
@pytest.mark.parametrize("rows", [1, 8, 900, 1000, 4096, 4097])
def test_ln_fwd_split_covers_every_row_once(rows, hidden, sms):
    threads, slots, blocks = norm.ln_fwd_split(rows, hidden, sms)
    # the kernels' launch bound: a row of MAX_HIDDEN / 8 threads
    assert threads % 32 == 0 and 32 <= threads <= norm.MAX_HIDDEN // 8 <= 1024
    team = threads // slots
    assert team * slots == threads and team % 32 == 0
    assert team == 32 or slots == 1      # a team of several warps is a block
    # one 16-byte chunk a lane, the kernel's register array: the team's
    # lanes cover the row, and no warp of it is idle
    assert team * 8 >= hidden > (team - 32) * 8
    assert 1 <= blocks <= -(-rows // slots)
    assert blocks <= sms * (norm._FWD_SM_THREADS // threads)   # one wave
    seen = []
    for blk in range(blocks):            # the kernel's walk of its rows
        for slot in range(slots):
            seen.extend(range(blk * slots + slot, rows, blocks * slots))
    assert sorted(seen) == list(range(rows))


# ------------------------------------------- routing by shape (C.1)
def _vectors(hidden, dtype=torch.float32):
    return torch.ones(hidden, dtype=dtype), torch.zeros(hidden, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_take_the_gpt_1p3b_rows(dtype):
    """GPT-1.3B's rows (hidden 2048, f32 or bf16, f32 weights) and a
    row slice of them are what the kernels take."""
    x = torch.zeros(4, 1024, 2048, dtype=dtype)
    w, b = _vectors(2048)
    for rows in (x, x[1:3]):
        assert norm.ln_kernel_takes(rows, w, b)
        assert norm.ln_kernel_takes(rows, w, b, residual=rows)
        assert norm.ln_kernel_takes(rows)
        assert norm.rms_kernel_takes(rows, w)
        norm._check_rows("x", rows)                 # the checks pass too
        norm._check_vector("w", w, 2048, rows.device)


@pytest.mark.parametrize("case", ["hidden 5120", "hidden 4100", "float16",
                                  "misaligned", "bias type", "residual"])
def test_ln_kernel_takes_refuses_what_the_kernels_raise_on(case):
    w, b = _vectors(2048)
    x = torch.zeros(3, 2048)
    residual = None
    if case == "hidden 5120":
        x, (w, b) = torch.zeros(3, 5120), _vectors(5120)
    elif case == "hidden 4100":
        x, (w, b) = torch.zeros(3, 4100), _vectors(4100)
    elif case == "float16":
        x = x.half()
    elif case == "misaligned":                      # base 8 bytes past 16
        x = torch.zeros(3 * 2048 + 4, dtype=torch.bfloat16)[4:].view(3, 2048)
    elif case == "bias type":
        b = b.to(torch.bfloat16)
    else:
        residual = torch.zeros(3, 1024)
    assert not norm.ln_kernel_takes(x, w, b, residual)
    with pytest.raises((ValueError, TypeError)):
        if residual is None:
            norm._check_rows("x", x)
            norm._check_vector("weight", w, x.shape[-1], x.device)
            norm._check_vector("bias", b, x.shape[-1], x.device, w.dtype)
        else:
            norm._check_rows("residual", residual, x.shape[-1])


def test_rms_kernel_takes_its_own_limit():
    w, _ = _vectors(5120)
    assert norm.rms_kernel_takes(torch.zeros(3, 5120), w)
    assert norm.rms_kernel_takes(torch.zeros(2, norm.MAX_RMS_HIDDEN))
    assert not norm.rms_kernel_takes(torch.zeros(2, norm.MAX_RMS_HIDDEN + 8))
    assert not norm.rms_kernel_takes(torch.zeros(2, 5124))
    assert not norm.rms_kernel_takes(torch.zeros(2, 5120).half(), w)


@pytest.mark.parametrize("fused", [None, True])
def test_layer_norm_at_a_refused_hidden_matches_reference(fused):
    """hidden 5120, past MAX_HIDDEN: with the fused path asked for, the
    functional takes the composition before any launch (counted in
    ROUTED) and equals the reference's result, f32 at 1e-5; so does the
    residual form. On a CPU tensor fused=None asks for the composition
    itself, so nothing is routed."""
    rng = np.random.default_rng(9)
    x, r, w, b = (rng.standard_normal(s).astype(np.float32)
                  for s in ((3, 5120), (3, 5120), 5120, 5120))
    before = dict(norm.ROUTED)
    want = PF.layer_norm(P.to_tensor(x), 5120, P.to_tensor(w),
                         P.to_tensor(b), EPS, fused=fused)
    got = F.layer_norm(torch.tensor(x), 5120, torch.tensor(w),
                       torch.tensor(b), EPS, fused=fused)
    _assert_close(got, want._value, "float32")
    want_h, want_y = PF.fused_ln_residual(
        P.to_tensor(x), P.to_tensor(r), P.to_tensor(w), P.to_tensor(b), EPS,
        fused=fused)
    h, y = F.fused_ln_residual(torch.tensor(x), torch.tensor(r),
                               torch.tensor(w), torch.tensor(b), EPS,
                               fused=fused)
    _assert_close(h, want_h._value, "float32")
    _assert_close(y, want_y._value, "float32")
    routed = int(fused is True)
    assert norm.ROUTED["layer_norm"] == before["layer_norm"] + routed
    assert norm.ROUTED["fused_ln_residual"] == \
        before["fused_ln_residual"] + routed
    assert not any(norm.LAUNCHES.values())
