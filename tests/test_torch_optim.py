"""paddle_tpu_torch fused AdamW (kernel #9): the plain version of
``fused_adam_update`` against the reference's Pallas kernel (interpret
mode on the CPU) on the same seeded inputs, the port's
``AdamW(fused=True)`` against its own unfused loop, the guard's per-block
gate, and the no-fallback contract of the CUDA wrapper.

Tolerances: p, m and v in f32 within rtol 1e-6 and atol 1e-6 (the
reference's fused-vs-unfused contract, tests/test_bytesopt.py); bf16
moments within one bf16 ulp (the same f32 value may round to either
neighbour); the guard's block sums of squares within 1e-5 relative
(f32 sums in another order), their finite verdicts exact. The port's
fused optimizer against its unfused loop: rtol 1e-5, atol 1e-6 over 3
steps (f32 moments), 1e-2 with bf16 moments.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import optim as pallas_optim

import paddle_tpu_torch as T
from paddle_tpu_torch.ops.cuda import build
from paddle_tpu_torch.ops.cuda import optim

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8
LR, STEP = 1e-3, 3
TWO_BLOCKS = (2048, 512)      # _pick_block_rows: 2 row blocks of 1024
ONE_BLOCK = (13, 40)          # odd rows: a single block, cols % 8 != 0


def _inputs(shape, seed, nan_block=None):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    m = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    v = (0.01 * rng.standard_normal(shape) ** 2).astype(np.float32)
    if nan_block is not None:
        br, _ = optim._regions(shape)
        g[nan_block * br + 5, 7] = np.nan
    return p, g, m, v


def _ulp_bf16(x):
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("weight_decay,decay_on",
                         [(0.0, True), (0.05, True), (0.05, False)])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [TWO_BLOCKS, ONE_BLOCK])
def test_plain_matches_pallas_kernel(shape, moment_dtype, weight_decay,
                                     decay_on, guard):
    """_adam_ref (through the wrapper, in place) against the reference's
    fused_adam_update(interpret=True); under guard on two blocks, a NaN
    in block 1: block 0 commits, block 1 keeps its inputs bit for bit."""
    nan_block = 1 if guard and shape == TWO_BLOCKS else None
    p, g, m, v = _inputs(shape, seed=shape[0] + (moment_dtype == "bfloat16"),
                         nan_block=nan_block)
    c1, c2 = 1 - BETA1 ** STEP, 1 - BETA2 ** STEP
    jm = jnp.asarray(m).astype(moment_dtype)
    jv = jnp.asarray(v).astype(moment_dtype)
    want = pallas_optim.fused_adam_update(
        jnp.asarray(p), jnp.asarray(g), jm, jv, LR, c1, c2, beta1=BETA1,
        beta2=BETA2, eps=EPS, weight_decay=weight_decay, decay_on=decay_on,
        guard=guard, interpret=True)
    tdt = getattr(torch, moment_dtype)
    tp = torch.tensor(p)
    tm = torch.tensor(np.asarray(jm.astype(jnp.float32))).to(tdt)
    tv = torch.tensor(np.asarray(jv.astype(jnp.float32))).to(tdt)
    m_in, v_in = tm.clone(), tv.clone()
    sc = torch.tensor([LR, c1, c2, float(decay_on)], dtype=torch.float32)
    parts = optim.fused_adam_update(
        tp, torch.tensor(g), tm, tv, sc, beta1=BETA1, beta2=BETA2, eps=EPS,
        weight_decay=weight_decay, guard=guard)
    assert tm.dtype == tdt and tv.dtype == tdt and tp.dtype == torch.float32
    for got, ref in zip((tp, tm, tv), want[:3]):
        got = got.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        err = np.abs(got - ref)
        if got is not tp and moment_dtype == "bfloat16":
            tol = _ulp_bf16(np.maximum(np.abs(got), np.abs(ref)))
        else:
            tol = 1e-6 + 1e-6 * np.abs(ref)
        assert (err <= tol).all(), f"max err {err.max()}"
    if not guard:
        assert parts is None
        return
    ref_parts = np.asarray(want[3])[:, 0]
    parts = parts.numpy()
    assert parts.shape == ref_parts.shape
    np.testing.assert_array_equal(np.isfinite(parts), np.isfinite(ref_parts))
    ok = np.isfinite(ref_parts)
    np.testing.assert_allclose(parts[ok], ref_parts[ok], rtol=1e-5)
    if nan_block is not None:
        br, _ = optim._regions(shape)
        rows = slice(nan_block * br, (nan_block + 1) * br)
        assert torch.equal(tp[rows], torch.tensor(p)[rows])
        assert torch.equal(tm[rows], m_in[rows])
        assert torch.equal(tv[rows], v_in[rows])
        assert not torch.equal(tp[:br], torch.tensor(p)[:br])


def _params(seed=0):
    """A two-block weight, an odd single-block weight and a bias, named."""
    rng = np.random.default_rng(seed)
    return [(name, torch.nn.Parameter(torch.tensor(
        rng.standard_normal(shape).astype(np.float32))))
        for name, shape in (("w2", TWO_BLOCKS), ("w1", ONE_BLOCK),
                            ("b", (40,)))]


def _run(fused, moment_dtype=None, guard=False, steps=3, nan_step=None):
    named = _params()
    opt = T.optimizer.AdamW(
        learning_rate=1e-2, weight_decay=0.05, parameters=named,
        apply_decay_param_fun=lambda n: n != "w1", moment_dtype=moment_dtype,
        fused=fused, guard=guard)
    rng = np.random.default_rng(7)
    summaries = []
    for step in range(steps):
        for _, p in named:
            g = rng.standard_normal(p.shape).astype(np.float32)
            if step == nan_step and p.shape == TWO_BLOCKS:
                g[1500, 3] = np.nan                      # block 1 of w2
            p.grad = torch.tensor(g)
        opt.step()
        if guard:
            summaries.append(opt.guard_summary())
    return named, opt, summaries


@pytest.mark.parametrize("moment_dtype,tol", [(None, (1e-5, 1e-6)),
                                              ("bfloat16", (1e-2, 1e-2))])
def test_fused_adamw_matches_unfused(moment_dtype, tol):
    unfused, _, _ = _run(False, moment_dtype)
    fused, opt, _ = _run(True, moment_dtype)
    for (name, a), (_, b) in zip(fused, unfused):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=tol[0],
                                   atol=tol[1], msg=name)
    mdt = torch.bfloat16 if moment_dtype else torch.float32
    assert opt.state_dict()["w2_moment1"].dtype == mdt
    assert not any(optim.LAUNCHES.values())          # CPU: plain version


def test_guarded_step_gates_one_block_and_holds_its_powers():
    """A NaN in block 1 of the two-block weight: that block keeps its p
    and moments, block 0 and the other parameters commit, the weight's
    beta powers hold (the reference's partial-commit behaviour) while
    the others advance; the summary counts 2 + 1 + 1 regions."""
    clean, _, summaries = _run(True, guard=True, steps=2)
    assert [s.good for s in summaries] == [True, True]
    assert all(s.regions == 4 and s.bad_regions == 0 for s in summaries)
    ref, ref_opt, _ = _run(True, guard=True, steps=1)
    named, opt, summaries = _run(True, guard=True, steps=2, nan_step=1)
    s = summaries[-1]
    assert (s.good, s.bad_regions, s.regions) == (False, 1, 4)
    assert not np.isfinite(s.grad_sumsq)
    w2, w2_ref, w2_clean = named[0][1], ref[0][1], clean[0][1]
    assert torch.equal(w2[1024:], w2_ref[1024:])           # held
    assert torch.equal(w2[:1024], w2_clean[:1024])         # committed
    st, st_ref = opt.state_dict(), ref_opt.state_dict()
    for acc in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
        held = st[f"w2_{acc}"]
        if held.dim():
            held, want = held[1024:], st_ref[f"w2_{acc}"][1024:]
        else:
            want = st_ref[f"w2_{acc}"]
        assert torch.equal(held, want), acc
    assert st["w1_beta1_pow"].item() == pytest.approx(BETA1 ** 2)
    for i in (1, 2):                                   # the others committed
        assert torch.equal(named[i][1], clean[i][1])


def test_state_dict_round_trip_and_lr():
    named, opt, _ = _run(True, steps=2)
    st = {k: v.clone() for k, v in opt.state_dict().items()}
    assert sorted(st) == sorted(f"{n}_{a}" for n in ("w2", "w1", "b") for a in
                                ("moment1", "moment2", "beta1_pow",
                                 "beta2_pow"))
    for t in opt.state_dict().values():
        t.zero_()
    opt.set_state_dict({k: v.numpy() for k, v in st.items()})
    for k, v in opt.state_dict().items():
        assert torch.equal(v, st[k]), k
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5


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
    monkeypatch.setattr(optim, "_route", lambda *t: "cuda")
    monkeypatch.setattr(optim, "_adam_ref", plain_called)
    p, g, m, v = (torch.zeros(16, 32) for _ in range(4))
    sc = torch.ones(4)
    for guard in (False, True):
        with pytest.raises(RuntimeError, match="nvcc"):
            optim.fused_adam_update(p, g, m, v, sc, beta1=BETA1, beta2=BETA2,
                                    eps=EPS, guard=guard)
    assert optim.LAUNCHES == {"adam_update": 0, "adam_update_guard": 0,
                              "adam_guard_sumsq": 0}


def test_other_devices_and_bad_inputs_raise(monkeypatch):
    kw = dict(beta1=BETA1, beta2=BETA2, eps=EPS)
    meta = [torch.empty(16, 32, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="no fused AdamW kernel"):
        optim.fused_adam_update(*meta, torch.empty(4, device="meta"), **kw)
    with pytest.raises(ValueError, match="rank 2"):
        optim.fused_adam_update(*(torch.zeros(8) for _ in range(4)),
                                torch.ones(4), **kw)
    monkeypatch.setattr(optim, "_route", lambda *t: "cuda")

    def call(p=None, g=None, m=None, v=None, sc=None):
        z = torch.zeros(16, 32)
        optim.fused_adam_update(
            z.clone() if p is None else p, z.clone() if g is None else g,
            z.clone() if m is None else m, z.clone() if v is None else v,
            torch.ones(4) if sc is None else sc, **kw)

    with pytest.raises(TypeError, match="p dtype"):
        call(p=torch.zeros(16, 32, dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="g dtype"):
        call(g=torch.zeros(16, 32, dtype=torch.float16))
    with pytest.raises(TypeError, match="v dtype"):
        call(v=torch.zeros(16, 32, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        call(g=torch.zeros(32, 16).t())
    with pytest.raises(ValueError, match="shape"):
        call(m=torch.zeros(16, 24))
    with pytest.raises(ValueError, match="sc shape"):
        call(sc=torch.ones(3))
    with pytest.raises(ValueError, match="aligned"):
        call(g=torch.zeros(16 * 32 + 1)[1:].view(16, 32))
    with pytest.raises(ValueError, match="moment_dtype"):
        T.optimizer.AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))],
                          moment_dtype="float16")
