"""What each kernel of the port costs the card, from its call's tensors:
the bytes its operands and results move (each read once, each written
once), the operations it does, the peak rate those run at, and where it
reuses what it reads (its grid and the bytes a block stages).

One formula serves the profiler and the kernel table: a wrapper books
its launch through :func:`paddle_tpu_torch.ops.cuda.launch.booked` with
the function of this module that costs it, and ``bound_ms`` is the
least time the card could take for that work, the larger of bytes over
``HBM_BYTES_PER_S`` and operations over the peak of their kind
(``PEAKS``): NVIDIA's H100 SXM data sheet for bf16 tensor-core products
and f32 arithmetic, and the int32 instruction rate of 132 SMs at
1.98 GHz for the keep mask's threefry. Attention counts the (query,
key) pairs its mask needs, not the whole square.

The plain versions the wrappers compute for CPU tensors are costed as
the kernel they stand for: one row at the call boundary.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

__all__ = ["HBM_BYTES_PER_S", "KernelCost", "PEAKS", "SM_COUNT", "adam",
           "bound_ms", "bsa_fwd", "flash_bwd_dkv", "flash_bwd_dq",
           "flash_fwd", "keep_mask", "ln_bwd", "ln_fwd", "ln_res_fwd",
           "rms_fwd"]

HBM_BYTES_PER_S = 3.35e12
SM_COUNT = 132
# int32: the instruction rate, 4 warp instructions a clock an SM (128
# lanes: the int32 ALU's 64 and the FMA pipe's IMAD) at 1.98 GHz
PEAKS = {"bf16": 989e12,                      # dense tensor-core products
         "f32": 67e12,                        # non-tensor-core f32
         "int32": SM_COUNT * 128 * 1.98e9}    # integer instructions
LN_OPS_PER_ELEM = 8          # sum, sub, square, sum, scale, w, b
LN_BWD_OPS_PER_ELEM = 20     # stats, xhat, two row sums, dx, dw, db
RMS_OPS_PER_ELEM = 4         # square, sum, scale, weight
ADAM_OPS_PER_ELEM = 15       # decay, two moments, two divides, sqrt
# a keep-mask element: one threefry-2x32 (20 rounds of add, rotate, xor;
# 5 key injections of two adds; the two initial adds) and the counter,
# bits, uniform, compare and store
KEEP_OPS_PER_ELEM = 80


@dataclass
class KernelCost:
    """One launch: ``bytes`` at its boundary, ``flops`` of kind ``peak``,
    and its interior: ``grid`` blocks, ``stage_bytes`` the largest a
    block stages at once, ``interior_bytes`` what all blocks stage over
    the launch (operands re-read from shared memory or L2 count again)."""

    name: str
    bytes: int
    flops: int
    peak: str
    grid: int = 1
    stage_bytes: int = 0
    interior_bytes: int = 0
    shape: tuple = field(default_factory=tuple)

    def bound_ms(self, bytes_per_s=HBM_BYTES_PER_S, peaks=PEAKS):
        return bound_ms(self.bytes, self.flops, self.peak, bytes_per_s,
                        peaks)[0]


def bound_ms(nbytes, ops, peak, bytes_per_s=HBM_BYTES_PER_S, peaks=PEAKS):
    """(the larger of the bytes' time and the operations' time in ms,
    "bytes" or "operations": which one it is)."""
    bytes_ms = nbytes / bytes_per_s * 1e3
    ops_ms = ops / peaks[peak] * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _rows(x):
    return x.numel() // x.shape[-1] if x.numel() else 0


def _one_pass(name, nbytes, flops, peak, grid, shape):
    """A kernel that reads and writes each byte once: its interior is its
    boundary, spread over ``grid`` blocks."""
    grid = max(1, int(grid))
    return KernelCost(name, nbytes, flops, peak, grid,
                      -(-nbytes // grid), nbytes, shape)


def _ln_grid(x):
    from paddle_tpu_torch.ops.cuda import norm
    return norm.ln_fwd_split(_rows(x), x.shape[-1], SM_COUNT)[2]


def _wide(*dtypes):
    """bf16 products for narrow types, f32 arithmetic otherwise."""
    return "bf16" if all(d in (torch.bfloat16, torch.float16)
                         for d in dtypes) else "f32"


# ------------------------------------------------------------ LayerNorm
def ln_fwd(x, weight, bias, eps):
    """x and the weights read, y written."""
    y_bytes = _nbytes(x)
    nbytes = _nbytes(x, weight, bias) + y_bytes
    return [_one_pass("ln_fwd", nbytes, LN_OPS_PER_ELEM * x.numel(), "f32",
                      _ln_grid(x), tuple(x.shape))]


def ln_res_fwd(x, residual, weight, bias, eps, act):
    """x, the residual and the weights read; h and y written, in the
    promoted type."""
    out = torch.promote_types(x.dtype, residual.dtype).itemsize * x.numel()
    nbytes = _nbytes(x, residual, weight, bias) + 2 * out
    return [_one_pass("ln_res_fwd", nbytes,
                      (LN_OPS_PER_ELEM + 1) * x.numel(), "f32",
                      _ln_grid(x), tuple(x.shape))]


def ln_bwd(h, gy, weight, bias=None, eps=1e-5, act=None, gh=None):
    """h, gy (and gh) and the weights read; dx, dw and db written."""
    from paddle_tpu_torch.ops.cuda import norm
    nbytes = _nbytes(h, gy, gh, weight, bias) + _nbytes(h, weight, bias)
    grid = norm.ln_bwd_split(_rows(h), h.shape[-1], SM_COUNT)[2] \
        if h.numel() else 1
    return [_one_pass("ln_bwd" if gh is None else "ln_bwd_res", nbytes,
                      LN_BWD_OPS_PER_ELEM * h.numel(), "f32", grid,
                      tuple(h.shape))]


def rms_fwd(x, weight, eps):
    nbytes = _nbytes(x, weight) + _nbytes(x)
    return [_one_pass("rms_fwd", nbytes, RMS_OPS_PER_ELEM * x.numel(),
                      "f32", _rows(x), tuple(x.shape))]


# ------------------------------------------------------------ attention
def causal_pairs(sq, sk):
    """(query, key) pairs of a top-left aligned causal mask (col <= row),
    the flash kernels'."""
    full = max(0, min(sq, sk))            # rows i < sk see i + 1 keys
    return full * (full + 1) // 2 + max(0, sq - sk) * sk


def _attention_pairs(q, k, causal):
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    return b * h * (causal_pairs(sq, sk) if causal else sq * sk)


def _flash_interior(q, k, causal, tile, step, dkv=False):
    """(blocks, largest stage, bytes staged) of a flash launch: each
    block owns ``tile`` query rows (keys for dk/dv) and walks the other
    side in steps of ``step``, staging a K and a V tile (Q and dO for
    dk/dv) each step beside its own tile."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    b, sq, h, d = q.shape
    sk = k.shape[1]
    e = q.element_size()
    own, walk = (sk, sq) if dkv else (sq, sk)
    tiles = -(-own // tile)
    total = 0
    for t in range(tiles):
        start = t * tile
        if dkv:
            steps = -(-walk // step) - (fa.dkv_query_start(start, causal)
                                        if causal else 0)
        elif tile == step:
            steps = fa.fwd_key_tiles(start, walk, causal)
        else:
            steps = fa.dq_key_tiles(start, walk, causal)
        total += 2 * tile * d * e + steps * 2 * step * d * e
    stage = 2 * tile * d * e + 2 * step * d * e
    return tiles * b * h, stage, total * b * h


def flash_fwd(q, k, v, causal=False, scale=None):
    """q, k, v read; o and the f32 lse written; 4 d operations a pair
    (two products of 2 d)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    lse = q.shape[0] * q.shape[2] * q.shape[1] * 4
    nbytes = _nbytes(q, k, v) + _nbytes(q) + lse
    flops = 4 * _attention_pairs(q, k, causal) * q.shape[-1]
    grid, stage, interior = _flash_interior(q, k, causal, fa.FWD_TILE,
                                            fa.FWD_TILE)
    return [KernelCost("flash_fwd", nbytes, flops, _wide(q.dtype), grid,
                       stage, interior + lse, tuple(q.shape))]


def flash_bwd_dq(q, k, v, do, lse, delta, causal=False, scale=None):
    """q, k, v, do, lse and delta read; dq written; 6 d operations a pair
    (the scores, dp and ds @ k)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    nbytes = _nbytes(q, k, v, do, lse, delta) + _nbytes(q)
    flops = 6 * _attention_pairs(q, k, causal) * q.shape[-1]
    grid, stage, interior = _flash_interior(q, k, causal, fa.BWD_TILE,
                                            fa.BWD_STEP)
    return [KernelCost("flash_bwd_dq", nbytes, flops, _wide(q.dtype), grid,
                       stage, interior, tuple(q.shape))]


def flash_bwd_dkv(q, k, v, do, lse, delta, causal=False, scale=None):
    """q, k, v, do, lse and delta read; dk and dv written; 8 d operations
    a pair (the scores, dp, p^T do and ds^T q)."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    nbytes = _nbytes(q, k, v, do, lse, delta) + _nbytes(k, v)
    flops = 8 * _attention_pairs(q, k, causal) * q.shape[-1]
    grid, stage, interior = _flash_interior(q, k, causal, fa.BWD_TILE,
                                            fa.BWD_STEP, dkv=True)
    return [KernelCost("flash_bwd_dkv", nbytes, flops, _wide(q.dtype), grid,
                       stage, interior, tuple(q.shape))]


def bsa_pairs(tables, sq, sk):
    """(query, key) pairs the pattern's active blocks hold, ragged ends
    cut, for one (batch, head)."""
    bq, bk = tables.block_q, tables.block_k
    pairs = 0
    for i in range(tables.kt.shape[0]):
        rows = min(bq, sq - i * bq)
        for j in tables.kt[i, :int(tables.counts[i])]:
            pairs += rows * min(bk, sk - int(j) * bk)
    return pairs


def bsa_fwd(q, k, v, tables, scale=None):
    """q, k, v read; o and the f32 lse written; 4 d operations an active
    pair. A q-block stages its own tile, and a K and a V block for each
    active step of its row."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    e = q.element_size()
    lse = b * h * sq * 4
    nbytes = _nbytes(q, k, v) + _nbytes(q) + lse
    flops = 4 * b * h * bsa_pairs(tables, sq, sk) * d
    bq, bk = tables.block_q, tables.block_k
    steps = int(tables.counts.sum())
    interior = b * h * (2 * tables.kt.shape[0] * bq * d * e
                        + steps * 2 * bk * d * e) + lse
    return [KernelCost("bsa_fwd", nbytes, flops, _wide(q.dtype),
                       b * h * tables.kt.shape[0],
                       2 * bq * d * e + 2 * bk * d * e, interior,
                       tuple(q.shape))]


# ------------------------------------------------------------ optimizer
def adam(p, g, m, v, sc, *, beta1, beta2, eps, weight_decay=0.0,
         guard=False):
    """The fused AdamW of one rank-2 weight: the update (guarded or not)
    reads p, g, m, v and writes p, m, v, 28 bytes and 15 operations an
    f32 element; guarded, the sums of squares read g first (4 bytes, 2
    operations an element)."""
    from paddle_tpu_torch.ops.cuda import optim
    n = p.numel()
    nbytes = 2 * _nbytes(p, m, v) + _nbytes(g)   # 28 n when all are f32
    regions = optim._regions(tuple(p.shape))[1]
    shape = tuple(p.shape)
    out = []
    if guard:
        out.append(KernelCost("adam_guard_sumsq", _nbytes(g), 2 * n, "f32",
                              regions, -(-_nbytes(g) // max(1, regions)),
                              _nbytes(g), shape))
    out.append(KernelCost("adam_update_guard" if guard else "adam_update",
                          nbytes, ADAM_OPS_PER_ELEM * n, "f32", regions,
                          -(-nbytes // max(1, regions)), nbytes, shape))
    return out


# ---------------------------------------------------------------- random
def keep_mask(key, keep_prob, shape, dtype=torch.bool):
    """The mask written, the key's words read and written with the
    subkey's: 80 int32 operations an element."""
    n = math.prod(int(s) for s in shape)
    nbytes = n * torch.empty((), dtype=dtype).element_size() + 32
    return [_one_pass("keep_mask", nbytes, KEEP_OPS_PER_ELEM * n, "int32",
                      -(-n // 1024), tuple(int(s) for s in shape))]
