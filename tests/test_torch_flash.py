"""paddle_tpu_torch flash attention: the plain versions of the three
kernels against the reference's Pallas kernels (interpret mode on the
CPU), the autograd Function against autograd through a composition, the
attention functional against the reference's, and the no-fallback
contract of the CUDA wrappers.

Tolerances: f32 at atol = rtol = 1e-5 (the reference accumulates over
blocks of 16 keys, the plain version over the whole row: the same
products summed in another order). bf16: the plain version and the
Pallas kernel round p and ds to bf16 at the same places, but p comes
from a running maximum in the kernel and from the row's maximum here, so
a p can round to a neighbouring bf16 value (2^-8 relative); outputs are
held within 2^-7 of the tensor's largest magnitude (two bf16 ulps there).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.framework import state as ref_state
from paddle_tpu.nn import functional as PF
from paddle_tpu.ops.pallas import flash_attention as pallas_flash

import paddle_tpu_torch as T
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import build, cost
from paddle_tpu_torch.ops.cuda import flash_attention as flash

BLOCK = 16            # reference blocks: s = 40 is a ragged 3 x 3 grid


def _data(b, sq, sk, h, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax(a, dtype):
    """[b, s, h, d] numpy -> the reference's [b, h, s, d] layout."""
    return jnp.asarray(a.transpose(0, 2, 1, 3)).astype(dtype)


def _torch(a, dtype):
    return torch.tensor(a).to(dtype)


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    if dtype == "bfloat16":
        tol = 2.0 ** -7 * np.abs(want).max()
    else:
        tol = 1e-5 + 1e-5 * np.abs(want)
    assert (err <= tol).all(), f"max abs err {err.max()}"


def _bshd(a_bhsd):
    """The reference's [b, h, s, d] result as numpy [b, s, h, d] f32."""
    return np.asarray(jnp.asarray(a_bhsd).astype(jnp.float32)).transpose(
        0, 2, 1, 3)


CASES = [  # (causal, sq, sk, dtype)
    (True, 40, 40, "float32"),
    (False, 40, 40, "float32"),
    (False, 24, 40, "float32"),     # dense sq != sk (_bwd_dkv's seq_q)
    (True, 40, 40, "bfloat16"),
]


@pytest.mark.parametrize("causal,sq,sk,dtype", CASES)
def test_plain_versions_match_pallas_kernels(causal, sq, sk, dtype):
    b, h, d = 1, 2, 16
    q, k, v, do = _data(b, sq, sk, h, d, seed=sq + sk + int(causal))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (_jax(a, jdt) for a in (q, k, v, do))
    want_o, want_lse = pallas_flash._flash_fwd(jq, jk, jv, causal, scale,
                                               BLOCK, BLOCK, True)
    tq, tk, tv, tdo = (_torch(a, tdt) for a in (q, k, v, do))
    o, lse = flash._flash_fwd_ref(tq, tk, tv, causal, scale)
    assert o.shape == tq.shape and o.dtype == tdt
    assert lse.shape == (b * h, sq) and lse.dtype == torch.float32
    _close(o.float().numpy(), _bshd(want_o), dtype)
    _close(lse.numpy(), np.asarray(want_lse).reshape(b * h, sq), "float32")

    # the backward from the same lse and delta on both sides
    delta = (tdo.float() * o.float()).sum(-1).transpose(1, 2)   # [b, h, sq]
    jlse = jnp.asarray(lse.numpy()).reshape(b, h, sq)
    want = pallas_flash._flash_bwd_impl(
        jq, jk, jv, jdo, jlse, jnp.asarray(delta.numpy()), causal, scale,
        BLOCK, BLOCK, True)
    args = (tq, tk, tv, tdo, lse, delta.reshape(b * h, sq), causal, scale)
    got = (flash.flash_bwd_dq(*args),) + flash.flash_bwd_dkv(*args)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == tdt
        _close(g.float().numpy(), _bshd(w), dtype)


def _composition(q, k, v, causal, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool)
                          .triu(1), -1e30)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_composition(causal):
    q, k, v, do = (torch.tensor(a) for a in _data(2, 33, 33, 3, 16, seed=5))
    grads = []
    for fn in (lambda *a: flash.flash_attention_bshd(*a, causal=causal),
               lambda *a: _composition(*a, causal, 0.25)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert not any(flash.LAUNCHES.values())     # CPU: plain versions only


@pytest.mark.parametrize("causal", [True, False])
def test_functional_matches_reference(causal):
    """The port's attention functional (flash plain version on the CPU)
    against the reference's (which falls back to _sdpa_ref off-TPU)."""
    q, k, v, _ = _data(2, 24, 24, 2, 16, seed=7)
    want = PF.scaled_dot_product_attention(
        P.to_tensor(q), P.to_tensor(k), P.to_tensor(v), is_causal=causal)
    got = F.scaled_dot_product_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), is_causal=causal)
    _close(got.numpy(), np.asarray(want._value), "float32")


def test_functional_mask_and_dropout():
    q, k, v, _ = (torch.tensor(a) for a in _data(1, 8, 8, 2, 16, seed=9))
    keep = torch.ones(8, 8, dtype=torch.bool).tril()
    masked = F.scaled_dot_product_attention(q, k, v, attn_mask=keep)
    causal = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    np.testing.assert_allclose(masked.numpy(), causal.numpy(), atol=1e-6)
    # dropout in training leaves flash for _sdpa_ref in both packages,
    # its mask drawn from the global key: the same seed, the same result
    # and the same key after it
    T.seed(11)
    P.seed(11)
    got = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                         is_causal=True)
    want = PF.scaled_dot_product_attention(
        *(P.to_tensor(t.numpy()) for t in (q, k, v)), dropout_p=0.1,
        is_causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               rtol=1e-6, atol=1e-6)
    assert T.get_rng_state().tolist() == \
        np.asarray(ref_state.get_rng_state()).astype(np.int64).tolist()
    assert not np.allclose(got.numpy(), causal.numpy())
    off = F.scaled_dot_product_attention(q, k, v, dropout_p=0.1,
                                         training=False)
    assert T.get_rng_state().tolist() == \
        np.asarray(ref_state.get_rng_state()).astype(np.int64).tolist()
    np.testing.assert_allclose(
        off.numpy(), F.scaled_dot_product_attention(q, k, v).numpy())


def test_cuda_request_raises_without_toolkit(monkeypatch, tmp_path):
    """A tensor routed to the kernels never reaches a plain version: with
    no nvcc every wrapper raises."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*a, **k):
        raise AssertionError("plain version reached on the CUDA route")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(flash.launch, "route", lambda *a: "cuda")
    monkeypatch.setattr(flash, "_flash_fwd_ref", plain_called)
    monkeypatch.setattr(flash, "_flash_bwd_dq_ref", plain_called)
    monkeypatch.setattr(flash, "_flash_bwd_dkv_ref", plain_called)
    q, k, v, do = (torch.tensor(a) for a in _data(1, 8, 8, 2, 128, seed=1))
    stats = torch.zeros(2, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        flash.flash_fwd(q, k, v, causal=True)
    with pytest.raises(RuntimeError, match="nvcc"):
        flash.flash_bwd_dq(q, k, v, do, stats, stats, causal=True)
    with pytest.raises(RuntimeError, match="nvcc"):
        flash.flash_bwd_dkv(q, k, v, do, stats, stats, causal=True)
    assert not any(flash.LAUNCHES.values())


def test_bad_inputs_raise():
    x = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="disagree"):
        flash.flash_fwd(x, torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 3, 64))
    with pytest.raises(ValueError, match="head_dim"):
        flash._check_kernel_operand("q", torch.zeros(1, 8, 2, 80),
                                    torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        flash._check_kernel_operand("q", x.half(), torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        flash._check_kernel_operand(
            "q", torch.zeros(1, 8, 128, 2).transpose(2, 3), torch.float32)
    with pytest.raises(ValueError, match="no flash attention kernel"):
        flash.flash_fwd(*(torch.empty(1, 8, 2, 64, device="meta"),) * 3)


# ------------------------------------ the bf16 forward's host-side logic
def test_tma_geometry_of_a_fused_projection_view():
    """q, k and v split off a fused [b, s, h, 3d] projection are read in
    place: the map walks (d, h, s, b) with the projection's strides."""
    qkv = torch.zeros(2, 40, 4, 3 * 128, dtype=torch.bfloat16)
    for part in qkv.split(128, dim=-1):
        geo = flash.tma_geometry(part)
        assert geo["dims"] == (128, 4, 40, 2)
        assert geo["strides"] == (384 * 2, 4 * 384 * 2, 40 * 4 * 384 * 2)
        assert geo["box"] == (flash.TMA_BOX, 1, flash.FWD_TILE, 1)


def test_tma_geometry_of_a_contiguous_tensor():
    geo = flash.tma_geometry(torch.zeros(3, 200, 2, 128, dtype=torch.bfloat16))
    assert geo["dims"] == (128, 2, 200, 3)
    assert geo["strides"] == (256, 2 * 256, 200 * 2 * 256)
    # two boxes of 64 head values (128 bytes) cover the head
    assert geo["box"][0] * 2 == 128 and 2 * geo["box"][0] == 128


@pytest.mark.parametrize("view", [
    lambda t: t[..., :128],                # rows of 132 values: 264 bytes
    lambda t: t[..., 4:132],               # base 8 bytes past alignment
    # aligned heads, but sequence rows 520 bytes apart
    lambda t: t.flatten().as_strided((1, 8, 2, 128), (2112, 260, 128, 1)),
])
def test_tma_geometry_raises_on_misaligned_strides(view):
    t = view(torch.zeros(1, 8, 2, 132, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="16-byte"):
        flash.tma_geometry(t)


@pytest.mark.parametrize("seq_q,seq_k,bh,causal", [
    (1024, 1024, 64, True),        # the training path: 8 tiles x 64 (b, h)
    (1000, 1000, 8, True),         # a ragged last tile
    (200, 328, 4, True),           # sq != sk both ways
    (328, 200, 4, True),
    (1024, 1024, 1, True),         # one (b, h)
    (300, 300, 3, False),
])
def test_fwd_tile_order_covers_each_tile_once_heaviest_first(
        seq_q, seq_k, bh, causal):
    q_tiles = -(-seq_q // flash.FWD_TILE)
    order = flash.fwd_tile_order(q_tiles, bh)
    assert sorted(order) == [(i, t) for i in range(bh)
                             for t in range(q_tiles)]
    work = [flash.fwd_key_tiles(t * flash.FWD_TILE, seq_k, causal)
            for _, t in order]
    assert work == sorted(work, reverse=True)
    assert work[0] == max(work) and work[-1] == min(work)


def test_fwd_key_tiles_stop_at_the_diagonal():
    tile = flash.FWD_TILE
    assert [flash.fwd_key_tiles(t * tile, 1024, True) for t in range(8)] \
        == list(range(1, 9))
    assert flash.fwd_key_tiles(0, 1024, False) == 8
    assert flash.fwd_key_tiles(tile, 200, True) == 2      # past seq_k: 2 tiles
    assert flash.fwd_key_tiles(0, 328, True) == 1


# ------------------------------------------- routing by shape (C.1)
def _fused_views(dtype, b=4, s=1024, h=16, d=128):
    """q, k, v as GPTAttention splits them off its fused projection."""
    return torch.empty(b, s, h, 3 * d, dtype=dtype).split(d, dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_the_gpt_1p3b_shapes(dtype):
    q, k, v = _fused_views(dtype)                   # [4, 1024, 16, 128]
    assert flash.kernel_takes(q, k, v)
    flash._check_shapes(q, k, v)                    # the checks pass too
    for name, t in (("q", q), ("k", k), ("v", v)):
        flash._check_kernel_operand(name, t, dtype)
    assert flash.kernel_takes(*(t.contiguous() for t in (q, k, v)))
    assert flash.kernel_takes(q[:, :200], k, v)                 # sq < sk
    assert flash.kernel_takes(q, k[:, :200], v[:, :200])        # sq > sk


@pytest.mark.parametrize("case", ["head_dim 16", "head_dim 96", "float16",
                                  "mixed types", "rows", "base", "shapes"])
def test_kernel_takes_refuses_what_the_kernels_raise_on(case):
    views = {
        "head_dim 16": lambda: _fused_views(torch.bfloat16, 2, 40, 4, 16),
        "head_dim 96": lambda: _fused_views(torch.float32, 2, 40, 4, 96),
        "float16": lambda: _fused_views(torch.float16, 2, 40, 4),
        "mixed types": lambda: (torch.zeros(1, 8, 2, 128),) + tuple(
            _fused_views(torch.bfloat16, 1, 8, 2)[1:]),
        # sequence rows 520 bytes apart
        "rows": lambda: (torch.zeros(1, 8, 2, 132, dtype=torch.bfloat16)
                         .flatten().as_strided((1, 8, 2, 128),
                                               (2112, 260, 128, 1)),) * 3,
        # base 8 bytes past alignment
        "base": lambda: (torch.zeros(1, 8, 2, 136, dtype=torch.bfloat16)
                         [..., 4:132],) * 3,
        "shapes": lambda: (torch.zeros(1, 8, 2, 128),
                           torch.zeros(1, 8, 3, 128),
                           torch.zeros(1, 8, 3, 128)),
    }
    q, k, v = views[case]()
    assert not flash.kernel_takes(q, k, v)
    with pytest.raises((ValueError, TypeError)):
        flash._check_shapes(q, k, v)
        for name, t in (("q", q), ("k", k), ("v", v)):
            flash._check_kernel_operand(name, t, q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_takes_head_dim_64_views(dtype):
    """BERT-base's and ViT-B/16's q, k, v: strided views of a fused
    ``[b, s, h, 3 * 64]`` projection, f32 and bf16, at seq 512 and at the
    ragged 197 (batch 2: the strides do not depend on it), and sequences
    cut short on either side."""
    for s in (512, 197):
        q, k, v = _fused_views(dtype, 2, s, 12, 64)
        assert flash.kernel_takes(q, k, v)
        for name, t in (("q", q), ("k", k), ("v", v)):
            flash._check_kernel_operand(name, t, dtype)
        assert flash.kernel_takes(*(t.contiguous() for t in (q, k, v)))
    q, k, v = _fused_views(dtype, 2, 197, 12, 64)
    assert flash.kernel_takes(q[:, :69], k, v)                  # sq < sk
    assert flash.kernel_takes(q, k[:, :69], v[:, :69])          # sq > sk


HEAD64_CASES = [  # (causal, sq, sk, dtype): one reference block of 128
    (False, 100, 100, "float32"),
    (True, 100, 100, "float32"),
    (False, 69, 100, "float32"),
    (False, 100, 100, "bfloat16"),
    (True, 100, 100, "bfloat16"),
]


@pytest.mark.parametrize("causal,sq,sk,dtype", HEAD64_CASES)
def test_head_dim_64_plain_versions_match_pallas_kernels(causal, sq, sk,
                                                         dtype):
    """At head_dim 64 the three plain versions (what the wrappers compute
    on the CPU, and what the card's kernels are held to) against the
    reference's Pallas kernels in interpret mode, one block of 128 over a
    ragged length of 100 (69 queries in the sq != sk case)."""
    b, h, d, block = 1, 2, 64, 128
    q, k, v, do = _data(b, sq, sk, h, d, seed=sq + sk + int(causal) + 64)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = (_jax(a, jdt) for a in (q, k, v, do))
    want_o, want_lse = pallas_flash._flash_fwd(jq, jk, jv, causal, scale,
                                               block, block, True)
    tq, tk, tv, tdo = (_torch(a, tdt) for a in (q, k, v, do))
    o, lse = flash.flash_fwd(tq, tk, tv, causal, scale)
    _close(o.float().numpy(), _bshd(want_o), dtype)
    _close(lse.numpy(), np.asarray(want_lse).reshape(b * h, sq), "float32")
    delta = (tdo.float() * o.float()).sum(-1).transpose(1, 2)   # [b, h, sq]
    want = pallas_flash._flash_bwd_impl(
        jq, jk, jv, jdo, jnp.asarray(lse.numpy()).reshape(b, h, sq),
        jnp.asarray(delta.numpy()), causal, scale, block, block, True)
    args = (tq, tk, tv, tdo, lse, delta.reshape(b * h, sq), causal, scale)
    got = (flash.flash_bwd_dq(*args),) + flash.flash_bwd_dkv(*args)
    for g, w, t in zip(got, want, (tq, tk, tv)):
        assert g.shape == t.shape and g.dtype == tdt
        _close(g.float().numpy(), _bshd(w), dtype)
    assert not any(flash.LAUNCHES.values())     # CPU: plain versions only


def test_cost_reads_head_dim_from_the_operands():
    """``ops/cuda/cost.py`` books the head_dim-64 launches by their own
    head_dim: BERT-base's forward moves q, k, v, o and lse (50.7 MB, the
    bytes bound it) and does 4 d operations a pair; dq 6 d, dk/dv 8 d."""
    b, s, h, d = 16, 512, 12, 64
    q, k, v, do = (torch.empty(b, s, h, d, dtype=torch.bfloat16,
                               device="meta") for _ in range(4))
    stats = torch.empty(b * h, s, device="meta")
    pairs = b * h * s * s
    (fwd,) = cost.flash_fwd(q, k, v)
    assert fwd.flops == 4 * pairs * d
    assert fwd.bytes == 4 * b * s * h * d * 2 + b * h * s * 4
    (dq,) = cost.flash_bwd_dq(q, k, v, do, stats, stats)
    (dkv,) = cost.flash_bwd_dkv(q, k, v, do, stats, stats)
    assert (dq.flops, dkv.flops) == (6 * pairs * d, 8 * pairs * d)


def test_functional_at_head_dim_64_takes_the_kernel_path():
    """A head_dim-64 call without mask or dropout goes to the flash
    wrappers (plain versions on the CPU), not to the composition: ROUTED
    stays, and the output and gradients equal autograd through
    ``_sdpa_ref``'s composition, f32 at 1e-5."""
    q, k, v, do = (torch.tensor(a) for a in _data(2, 40, 40, 2, 64, seed=11))
    before = flash.ROUTED["flash_attention"]
    grads = []
    for fn in (lambda *a: F.scaled_dot_product_attention(*a),
               lambda *a: _composition(*a, False, 0.125)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        grads.append([out.detach()] + [t.grad for t in leaves])
    assert flash.ROUTED["flash_attention"] == before
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("sq,sk", [(24, 40), (40, 24)])
def test_functional_at_a_refused_head_dim_matches_the_reference_kernel(
        sq, sk):
    """head_dim 16, causal, sq != sk both ways: the kernels do not take
    it, so the functional runs autograd through flash's plain forward
    (counted in ROUTED, no launch); output and gradients equal the
    reference's Pallas kernel at that head_dim (interpret mode, causal
    mask top-left), f32 at 1e-5."""
    b, h, d = 1, 2, 16
    q, k, v, do = _data(b, sq, sk, h, d, seed=sq * 3 + sk)

    def ref(q_, k_, v_):
        return pallas_flash.flash_attention_bshd(
            q_, k_, v_, causal=True, block_q=BLOCK, block_k=BLOCK,
            interpret=True)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    before = flash.ROUTED["flash_attention"]
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    out.backward(torch.tensor(do))
    assert flash.ROUTED["flash_attention"] == before + 1
    assert not any(flash.LAUNCHES.values())
    _close(out.detach().numpy(), np.asarray(want), "float32")
    for t, g in zip(leaves, want_grads):
        _close(t.grad.numpy(), np.asarray(g), "float32")


# ------------------------------------- the bf16 backward's host-side logic
def test_tma_geometry_of_the_backward_boxes():
    """The backward reads q, k, v and do in boxes of 64 rows: the same
    dims and strides as the forward's map, in place."""
    qkv = torch.zeros(2, 40, 4, 3 * 128, dtype=torch.bfloat16)
    for part in qkv.split(128, dim=-1):
        geo = flash.tma_geometry(part, rows=flash.BWD_STEP)
        assert geo["dims"] == (128, 4, 40, 2)
        assert geo["strides"] == (384 * 2, 4 * 384 * 2, 40 * 4 * 384 * 2)
        assert geo["box"] == (flash.TMA_BOX, 1, 64, 1)
    do = torch.zeros(3, 200, 2, 128, dtype=torch.bfloat16)
    geo = flash.tma_geometry(do, rows=flash.BWD_STEP)
    assert geo["dims"] == (128, 2, 200, 3)
    assert geo["strides"] == (256, 2 * 256, 200 * 2 * 256)
    assert geo["box"] == (64, 1, 64, 1)
    # 64 rows of 64 values: two boxes make a step's 16 KB tile
    assert 2 * geo["box"][0] * geo["box"][2] * do.element_size() == 16384
    with pytest.raises(ValueError, match="16-byte"):
        flash.tma_geometry(torch.zeros(1, 8, 2, 132, dtype=torch.bfloat16)
                           [..., :128], rows=flash.BWD_STEP)


ORDER_CASES = [  # seq_q, seq_k, bh, causal
    (1024, 1024, 64, True),        # the training path
    (1000, 1000, 8, True),         # ragged last tiles
    (200, 328, 4, True),           # sq != sk both ways
    (328, 200, 4, True),
    (1024, 1024, 1, True),
    (300, 300, 3, False),
]


@pytest.mark.parametrize("seq_q,seq_k,bh,causal", ORDER_CASES)
def test_dq_tile_order_covers_each_tile_once_heaviest_first(
        seq_q, seq_k, bh, causal):
    q_tiles = -(-seq_q // flash.BWD_TILE)
    order = flash.fwd_tile_order(q_tiles, bh)
    assert sorted(order) == [(i, t) for i in range(bh)
                             for t in range(q_tiles)]
    work = [flash.dq_key_tiles(t * flash.BWD_TILE, seq_k, causal)
            for _, t in order]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("seq_q,seq_k,bh,causal", ORDER_CASES)
def test_dkv_tile_order_covers_each_tile_once_heaviest_first(
        seq_q, seq_k, bh, causal):
    k_tiles = -(-seq_k // flash.BWD_TILE)
    order = flash.dkv_tile_order(k_tiles, bh)
    assert sorted(order) == [(i, t) for i in range(bh)
                             for t in range(k_tiles)]
    q_steps = -(-seq_q // flash.BWD_STEP)
    work = [max(q_steps - flash.dkv_query_start(t * flash.BWD_TILE, causal),
                0) for _, t in order]
    assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("seq_q,seq_k", [(1024, 1024), (200, 328),
                                         (328, 200), (1000, 1000), (64, 300)])
def test_backward_steps_cover_exactly_the_causal_pairs(seq_q, seq_k):
    """Top-left causal (col <= row): dq's key steps reach every key a
    query tile's rows see, and stop at the diagonal; dk/dv's query steps
    start at the step holding row k0 and skip only rows that see none of
    the block's keys, also when the block lies past seq_q."""
    step, tile = flash.BWD_STEP, flash.BWD_TILE
    for q0 in range(0, seq_q, tile):
        last_row = min(q0 + tile, seq_q) - 1
        need = -(-min(last_row + 1, seq_k) // step)
        walked = flash.dq_key_tiles(q0, seq_k, True)
        assert walked >= need and walked <= need + 1
        assert walked == min(-(-seq_k // step), (q0 + tile - 1) // step + 1)
    q_steps = -(-seq_q // step)
    for k0 in range(0, seq_k, tile):
        first = flash.dkv_query_start(k0, True)
        assert first * step <= k0 < (first + 1) * step
        # rows before the first step see no key >= k0
        assert all(row < k0 for row in range(min(first * step, seq_q)))
        if k0 >= seq_q:
            assert max(q_steps - first, 0) == 0
        assert flash.dkv_query_start(k0, False) == 0
