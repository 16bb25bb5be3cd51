"""Flash attention kernels (``csrc/flash_attention.cu``): wrappers,
autograd, plain versions and launch counts.

- :func:`flash_fwd` replaces
  ``paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel``;
- :func:`flash_bwd_dq` replaces ``_bwd_dq_kernel``;
- :func:`flash_bwd_dkv` replaces ``_bwd_dkv_kernel``.

Tensors are ``[batch, seq, heads, head_dim]`` with a contiguous last
axis; the kernels read and write them through their strides, so views
(the q/k/v split of a fused projection) need no copy. ``lse`` and
``delta`` are f32 ``[batch * heads, seq_q]``. The causal mask is
top-left aligned (``col <= row``), as in the Pallas kernels.

:func:`flash_attention_bshd` is the differentiable entry point, the
counterpart of the reference's ``flash_attention_bshd`` and its custom
VJP (``_flash_bhsd``): the backward computes ``delta = rowsum(do * o)``
in f32 and hands it to both backward kernels.

The bf16 kernels run on wgmma with their operands fed by TMA. What
their launchers and blocks compute on the way is written out here as
plain Python, held by the CPU tests: :func:`tma_geometry` (the 4-D
tensor map of a strided operand, in boxes of 128 rows for the forward
and 64 for the backward; ``_check_kernel_operand`` requires what it
needs), :func:`fwd_tile_order` and :func:`fwd_key_tiles` (which block of
the forward and of dq takes which query tile, heaviest first, and how
many key steps it walks: :func:`dq_key_tiles` for dq's 64-key steps),
:func:`dkv_tile_order` and :func:`dkv_query_start` (the same for dk/dv's
key tiles and its query steps); ``csrc/flash_attention.cu`` computes the
same. The f32 kernels keep the mma.sync tiles of
``csrc/attention_tiles.cuh``.

:func:`kernel_takes` says whether the kernels take a call's q, k and v
(head_dim 64 or 128, f32 or bf16 alike, TMA-aligned strides). The attention
functional asks it before the call and sends what it refuses to a
composition, counting those calls in ``ROUTED``; the wrappers themselves
still raise on what they do not take.

A wrapper given CPU tensors computes its plain version
(:func:`_flash_fwd_ref`, :func:`_flash_bwd_dq_ref`,
:func:`_flash_bwd_dkv_ref`: the whole softmax at once, in f32, rounding p
and ds where the kernels do). Given CUDA tensors
it launches the kernels on the current stream, without synchronising, or
raises. ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from paddle_tpu_torch.ops.cuda import cost, launch

__all__ = ["BWD_STEP", "BWD_TILE", "FWD_TILE", "HEAD_DIMS", "LAUNCHES",
           "ROUTED",
           "TMA_BOX", "dkv_query_start", "dkv_tile_order", "dq_key_tiles",
           "flash_attention_bshd", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd",
           "fwd_key_tiles", "fwd_tile_order", "kernel_takes", "tma_geometry"]

LAUNCHES = launch.counts(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
# calls the attention functional sent to a composition because the
# kernels do not take their shape or type (kernel_takes)
ROUTED = launch.counts(("flash_attention",))
HEAD_DIMS = (64, 128)          # the instances: BERT's and ViT's, GPT-1.3B's
FWD_TILE = 128                 # bf16 forward: query rows a block, keys a step
BWD_TILE = 128                 # bf16 dq / dk,dv: query rows / keys a block owns
BWD_STEP = 64                  # bf16 dq / dk,dv: keys / query rows a step
TMA_BOX = 64                   # head_dim values a TMA box row (128 B swizzle)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
# the profiler scopes of the two contractions, the names the reference's
# jnp.einsum gives them
SCORES_SCOPE = "bqhd,bkhd->bhqk"
VALUES_SCOPE = "bhqk,bkhd->bqhd"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_S = ctypes.POINTER(ctypes.c_longlong)
_TAIL = [_I, _I, _I, _I, _I, _I, _F, _I, _I, _P]
_SIGNATURES = {
    "flash_fwd": [_P, _P, _P, _P, _P, _S] + _TAIL,
    "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _S] + _TAIL,
    "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _S] + _TAIL,
}


# ------------------------------------------------------ plain versions
def _scores(q, k, causal, scale):
    """log2-domain scores ``[b, h, sq, sk]`` in f32, masked to -1e30."""
    with launch.op_scope(SCORES_SCOPE):
        s = torch.matmul(q.float().transpose(1, 2),
                         k.float().permute(0, 2, 3, 1))
    s = s * (scale * _LOG2E)
    if causal:
        sq, sk = s.shape[-2:]
        rows = torch.arange(sq, device=s.device)[:, None]
        cols = torch.arange(sk, device=s.device)[None, :]
        s = s.masked_fill(cols > rows, _NEG_INF)
    return s


def _flash_fwd_ref(q, k, v, causal, scale):
    """Plain version of :func:`flash_fwd`: ``(o, lse)``."""
    b, sq, h, _ = q.shape
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    with launch.op_scope(VALUES_SCOPE):
        o = torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))
    o = o / l_safe
    lse = (m * _LN2 + torch.log(l_safe)).reshape(b * h, sq)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def _probs(q, k, lse, causal, scale):
    b, sq, h, _ = q.shape
    return torch.exp2(_scores(q, k, causal, scale)
                      - lse.reshape(b, h, sq, 1) * _LOG2E)


def _dscores(q, k, v, do, lse, delta, causal, scale):
    """(p, ds) ``[b, h, sq, sk]`` in f32, as the backward kernels form
    them."""
    b, sq, h, _ = q.shape
    p = _probs(q, k, lse, causal, scale)
    dp = torch.matmul(do.float().transpose(1, 2),
                      v.float().permute(0, 2, 3, 1))
    return p, p * (dp - delta.reshape(b, h, sq, 1)) * scale


def _bshd(g, like):
    return g.transpose(1, 2).to(like.dtype).contiguous()


def _flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale):
    """Plain version of :func:`flash_bwd_dq`."""
    _, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    return _bshd(torch.matmul(ds.to(k.dtype).float(),
                              k.float().transpose(1, 2)), q)


def _flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale):
    """Plain version of :func:`flash_bwd_dkv`: ``(dk, dv)``."""
    p, ds = _dscores(q, k, v, do, lse, delta, causal, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2),
                      do.float().transpose(1, 2))
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float().transpose(1, 2))
    return _bshd(dk, k), _bshd(dv, v)


# ------------------------------------------- the bf16 kernels' host side
def tma_geometry(t, rows=FWD_TILE):
    """The 4-D tensor map a bf16 kernel encodes for a ``[b, s, h, d]``
    operand read in place: ``dims`` (d, h, s, b), innermost first; the
    byte ``strides`` of h, s and b; the ``box`` (64, 1, rows, 1), 64 head
    values (128 bytes, the swizzle width) by ``rows`` rows of one head
    (the forward's 128, the backward's ``BWD_STEP``), so a 128-wide head
    is two boxes. Raises ValueError where TMA cannot take the tensor: a
    last axis that is not contiguous, a base address or a byte stride
    that is not a multiple of 16."""
    b, s, h, d = t.shape
    sb, ss, sh, sd = t.stride()
    e = t.element_size()
    strides = (sh * e, ss * e, sb * e)
    if sd != 1 or t.data_ptr() % 16 or any(x % 16 or x < 0 for x in strides):
        raise ValueError(f"flash attention: TMA needs a contiguous last axis "
                         f"and 16-byte aligned rows (strides {t.stride()}, "
                         f"{e}-byte elements)")
    return {"dims": (d, h, s, b), "strides": strides,
            "box": (TMA_BOX, 1, rows, 1)}


def fwd_key_tiles(q0, seq_k, causal):
    """Key tiles of ``FWD_TILE`` the query tile starting at row ``q0``
    visits: all of them, or under ``causal`` those up to the diagonal."""
    n = -(-seq_k // FWD_TILE)
    return min(n, (q0 + FWD_TILE - 1) // FWD_TILE + 1) if causal else n


def fwd_tile_order(q_tiles, bh_count):
    """``(bh, q_tile)`` of each block of the bf16 forward and of bf16 dq
    (both own 128 query rows), by block index: the last query tiles (the
    most key tiles under ``causal``) first, each across every (b, h), so
    the longest blocks start in the first wave."""
    return [(i % bh_count, q_tiles - 1 - i // bh_count)
            for i in range(q_tiles * bh_count)]


def dq_key_tiles(q0, seq_k, causal):
    """Key steps of ``BWD_STEP`` that bf16 dq's block of ``BWD_TILE``
    query rows from ``q0`` walks: all of them, or under ``causal`` those
    up to the diagonal of its last row."""
    n = -(-seq_k // BWD_STEP)
    return min(n, (q0 + BWD_TILE - 1) // BWD_STEP + 1) if causal else n


def dkv_tile_order(k_tiles, bh_count):
    """``(bh, k_tile)`` of each block of bf16 dk/dv (``BWD_TILE`` keys
    each), by block index: the first key tiles first, each across every
    (b, h). Under ``causal`` those see the most query steps, so the
    longest blocks start in the first wave (``fwd_tile_order`` turned
    round)."""
    return [(i % bh_count, i // bh_count) for i in range(k_tiles * bh_count)]


def dkv_query_start(k0, causal):
    """The first query step (of ``BWD_STEP`` rows) that bf16 dk/dv's
    block of keys from ``k0`` walks: under ``causal`` the one that holds
    row k0, since rows before it see none of these keys; else 0. The
    block walks from there to the last step of seq_q."""
    return k0 // BWD_STEP if causal else 0


# -------------------------------------------------------------- checks
# Each *_fault returns the exception a check raises, or None: the checks
# raise it, and kernel_takes asks whether there is one.
def _shapes_fault(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return ValueError("flash attention takes [batch, seq, heads, "
                          "head_dim] tensors")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        return ValueError(f"flash attention: q {tuple(q.shape)}, k "
                          f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q.shape[1] == 0 or k.shape[1] == 0:
        return ValueError("flash attention: empty sequence")
    return None


def _operand_fault(name, t, dtype):
    if t.dtype != dtype or t.dtype not in _DTYPES:
        return TypeError(f"flash attention {name}: dtype {t.dtype} (float32 "
                         f"or bfloat16, all operands alike)")
    if t.shape[-1] not in HEAD_DIMS:
        return ValueError(f"flash attention {name}: head_dim {t.shape[-1]} "
                          f"is not one of {HEAD_DIMS}")
    e = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or \
            any(s * e % 16 for s in t.stride()[:3]):
        return ValueError(f"flash attention {name}: the last axis must be "
                          f"contiguous and rows 16-byte aligned (strides "
                          f"{t.stride()})")
    return None


def _check_shapes(q, k, v):
    fault = _shapes_fault(q, k, v)
    if fault is not None:
        raise fault


def _check_kernel_operand(name, t, dtype):
    fault = _operand_fault(name, t, dtype)
    if fault is not None:
        raise fault


def kernel_takes(q, k, v):
    """True exactly when the kernels take these operands (the checks of
    :func:`flash_fwd` pass): ``[b, s, h, d]`` q, k and v of one type,
    f32 or bf16, d in ``HEAD_DIMS``, with a contiguous last axis and
    16-byte aligned rows and base. It asks nothing of the device."""
    return _shapes_fault(q, k, v) is None and all(
        _operand_fault(name, t, q.dtype) is None
        for name, t in (("q", q), ("k", k), ("v", v)))


def _check_rowstats(name, t, rows, cols, device):
    if t.dtype != torch.float32 or tuple(t.shape) != (rows, cols) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"flash attention {name}: must be a contiguous f32 "
                         f"[{rows}, {cols}] tensor on {device}")


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _lib():
    return launch.bind(_SIGNATURES)


# ------------------------------------------------------------ wrappers
@launch.booked(cost.flash_fwd)
def flash_fwd(q, k, v, causal=False, scale=None):
    """Attention forward: ``(o, lse)`` with o ``[b, sq, h, d]`` in q's
    type and lse f32 ``[b * h, sq]`` (natural log)."""
    _check_shapes(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = _scale_of(q, scale)
    if launch.route("flash attention", q, k, v) == "cpu":
        return _flash_fwd_ref(q, k, v, causal, scale)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, t, q.dtype)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    rc = _lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        _strides(q, k, v, o), b, h, sq, sk, d, _DTYPES[q.dtype], scale,
        int(bool(causal)), q.device.index, launch.stream(q.device))
    launch.raise_on(rc, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta):
    _check_shapes(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"flash attention: do {tuple(do.shape)} != q "
                         f"{tuple(q.shape)}")
    if launch.route("flash attention", q, k, v, do, lse, delta) == "cpu":
        return "cpu"
    b, sq, h, _ = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_kernel_operand(name, t, q.dtype)
    _check_rowstats("lse", lse, b * h, sq, q.device)
    _check_rowstats("delta", delta, b * h, sq, q.device)
    return "cuda"


def _bwd_tail(q, k, causal, scale):
    b, sq, h, d = q.shape
    return (b, h, sq, k.shape[1], d, _DTYPES[q.dtype], scale,
            int(bool(causal)), q.device.index, launch.stream(q.device))


def _scale_of(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


@launch.booked(cost.flash_bwd_dq)
def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, scale=None):
    """dq given ``lse`` and ``delta`` (f32 ``[b * h, sq]``; ``delta =
    rowsum(do * o)``, or ``delta - dlse`` when lse has a cotangent too),
    in q's type."""
    scale = _scale_of(q, scale)
    if _check_bwd(q, k, v, do, lse, delta) == "cpu":
        return _flash_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = _lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        _strides(q, k, v, do, dq), *_bwd_tail(q, k, causal, scale))
    launch.raise_on(rc, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


@launch.booked(cost.flash_bwd_dkv)
def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """``(dk, dv)`` given ``lse`` and ``delta``, in k's and v's type."""
    scale = _scale_of(q, scale)
    if _check_bwd(q, k, v, do, lse, delta) == "cpu":
        return _flash_bwd_dkv_ref(q, k, v, do, lse, delta, causal, scale)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    rc = _lib().flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(q, k, v, do, dk, dv), *_bwd_tail(q, k, causal, scale))
    launch.raise_on(rc, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ------------------------------------------------------------ autograd
class _FlashAttention(torch.autograd.Function):
    """``_flash_fwd_rule``/``_flash_bwd_rule``: saves q, k, v, o, lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        b, sq, h, _ = q.shape
        delta = (do.float() * o.float()).sum(dim=-1)          # [b, sq, h]
        delta = delta.transpose(1, 2).reshape(b * h, sq).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bshd(q, k, v, causal=False, scale=None):
    """Differentiable flash attention on ``[batch, seq, heads,
    head_dim]`` inputs; ``scale`` defaults to 1/sqrt(head_dim)."""
    return _FlashAttention.apply(q, k, v, bool(causal), _scale_of(q, scale))
