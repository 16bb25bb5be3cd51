"""Block-sparse flash attention (``csrc/block_sparse_attention.cu``):
host-side tables, wrapper, autograd, plain versions and launch count.

:func:`bsa_fwd` replaces
``paddle_tpu/ops/pallas/block_sparse_attention.py:_fwd_kernel``. The
sparsity is a ``[nq, nk]`` boolean mask over blocks of ``block_q`` query
and ``block_k`` key tokens, fixed on the host (a layout, not data).
:func:`block_mask_tables` lists each q-block's active k-blocks
(``kt``, padded with the row's last active block, and ``counts``); the
transposed tables (``qt``, ``qcounts``) list each k-block's active
q-blocks for dk/dv. These numpy helpers and the mask builders are copies
of the reference's and give the same arrays. :func:`tile_walk_tables`
lays the same rows out for the bf16 kernel, which owns 128 query rows a
block and walks 64-key boxes two a stage.

:func:`block_sparse_flash_attention` is differentiable: its forward is
:func:`bsa_fwd`, its backward the PyTorch form of the reference's
``_bsa_bwd_rule`` (:func:`_bsa_bwd_ref`): p recomputed in f32 from the
saved lse, dq walked by q-row over ``kt``, dk/dv by k-column over
``qt``, padded steps dropped with ``torch.where``.
:func:`block_sparse_attention` is the public entry point.

Tensors are ``[batch, heads, seq, head_dim]`` (Paddle's sparse_attention
layout) with a contiguous last axis; the kernel reads them through their
strides, so head-split views of a projection need no copy. A wrapper
given CPU tensors computes the plain version (:func:`_bsa_fwd_ref`, block
by block over the tables); given CUDA tensors it launches the kernel on
the current stream, without synchronising, or raises. ``LAUNCHES`` counts
the kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from paddle_tpu_torch.ops.cuda import cost, launch

__all__ = ["BLOCK_SIZES", "HEAD_DIMS", "LAUNCHES", "block_mask_tables",
           "block_sparse_attention", "block_sparse_flash_attention",
           "bsa_fwd", "make_global_plus_window_mask",
           "make_sliding_window_mask", "prepare_block_mask",
           "tile_walk_tables"]

LAUNCHES = launch.counts(("bsa_fwd",))
HEAD_DIMS = (64, 128)               # the instantiated kernels'
BLOCK_SIZES = (64, 128, 256, 512)   # mask blocks the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453
_TABLES_CAP = 64
TILE_ROWS = 128     # query rows a block of the bf16 kernel owns, 64 a warpgroup
BOX_KEYS = 64       # keys a TMA box of the bf16 kernel holds, two a stage

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "bsa_fwd": [_P] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 11
               + [ctypes.c_float, _I, _P],
}


# --------------------------------------------------------- host tables
def make_sliding_window_mask(nq, nk, window_blocks, causal=True):
    """[nq, nk] bool: each q-block attends its diagonal neighborhood."""
    qi = np.arange(nq)[:, None]
    ki = np.arange(nk)[None, :]
    m = np.abs(qi - ki) < window_blocks
    if causal:
        m &= ki <= qi
    return m


def make_global_plus_window_mask(nq, nk, window_blocks, global_blocks,
                                 causal=True):
    """Sliding window + the first `global_blocks` k-blocks visible to
    every query (the Longformer/BigBird pattern at block granularity)."""
    m = make_sliding_window_mask(nq, nk, window_blocks, causal)
    m[:, :global_blocks] = True
    if causal:
        m &= np.arange(nk)[None, :] <= np.arange(nq)[:, None]
    return m


def block_mask_tables(block_mask):
    """[nq, nk] bool -> (kt, counts, max_active): kt[qi, j] is the j-th
    active k-block of q-row qi, padded with the row's last active block
    (block 0 for an empty row)."""
    bm = np.asarray(block_mask, bool)
    nq, _nk = bm.shape
    counts = bm.sum(1).astype(np.int32)
    max_active = int(counts.max()) if counts.size else 0
    if max_active == 0:
        raise ValueError("block mask has no active blocks")
    kt = np.zeros((nq, max_active), np.int32)
    for qi in range(nq):
        act = np.nonzero(bm[qi])[0]
        if len(act) == 0:
            act = np.array([0])
        kt[qi, :len(act)] = act
        kt[qi, len(act):] = act[-1]
    return kt, counts, max_active


def tile_walk_tables(block_mask, block_q, block_k):
    """[nq, nk] bool -> (boxes, counts, order), the bf16 kernel's walk.

    Tile t is query rows [128 t, 128 t + 128), ceil(nq * block_q / 128)
    tiles; warpgroup w of it owns the 64 rows from 128 t + 64 w, which lie
    in mask row (128 t + 64 w) // block_q (block_q a multiple of 64).
    ``boxes[t, :counts[t]]`` lists the 64-key boxes of the sorted union of
    the active k-blocks of the tile's mask rows, block_k / 64 boxes a
    k-block in order, each as ``(key // 64) << 2 | flags``: bit w of flags
    says that warpgroup w's mask row holds the box's k-block. So each mask
    row's k-blocks appear in ``kt``'s order, each once. ``order`` lists
    the tiles by stages (``ceil(count / 2)``) descending, ties by index:
    blocks take the heaviest tiles first. A warpgroup past the last mask
    row holds no box."""
    bm = np.asarray(block_mask, bool)
    nq, nk = bm.shape
    tiles = -(-nq * block_q // TILE_ROWS)
    per_block = block_k // BOX_KEYS
    rows = (np.arange(tiles)[:, None] * TILE_ROWS
            + np.arange(2)[None, :] * (TILE_ROWS // 2)) // block_q
    held = np.where((rows < nq)[..., None], bm[np.minimum(rows, nq - 1)],
                    False)                               # [tiles, 2, nk]
    flags = held[:, 0].astype(np.int32) | held[:, 1].astype(np.int32) << 1
    counts = (flags > 0).sum(1).astype(np.int32) * per_block
    boxes = np.zeros((tiles, max(1, int(counts.max()))), np.int32)
    for t in range(tiles):
        kb = np.nonzero(flags[t])[0]
        chunk = (kb[:, None] * per_block + np.arange(per_block)).ravel()
        boxes[t, :len(chunk)] = chunk << 2 | np.repeat(flags[t, kb], per_block)
    order = np.argsort(-((counts + 1) // 2), kind="stable").astype(np.int32)
    return boxes, counts, order


class _BlockMaskTables:
    """The tables of one pattern: ``kt``/``counts`` by q-row, the
    transposed ``qt``/``qcounts`` by k-column and the bf16 kernel's walk
    (``boxes``/``box_counts``/``tile_order``, :func:`tile_walk_tables`),
    all numpy, and their device copies, made once per device
    (:meth:`on`)."""

    def __init__(self, block_mask, block_q, block_k):
        bm = np.asarray(block_mask, bool)
        self.kt, self.counts, self.max_active = block_mask_tables(bm)
        self.qt, self.qcounts, self.qmax = block_mask_tables(bm.T)
        self.boxes, self.box_counts, self.tile_order = tile_walk_tables(
            bm, block_q, block_k)
        self.block_q, self.block_k = int(block_q), int(block_k)
        self.shape = bm.shape
        self._on = {}

    def on(self, device):
        """``{kt, cnt, qt, qcnt, boxes, bcnt, order}`` on ``device``
        (int32; the f32 kernel reads kt and cnt, the bf16 kernel boxes,
        bcnt and order), copied at the first call for that device."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = {
                name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for name, a in (("kt", self.kt), ("cnt", self.counts),
                                ("qt", self.qt), ("qcnt", self.qcounts),
                                ("boxes", self.boxes),
                                ("bcnt", self.box_counts),
                                ("order", self.tile_order))}
        return self._on[device]


_tables = {}        # (mask bytes, shape, block_q, block_k) -> tables, FIFO


def prepare_block_mask(block_mask, block_q, block_k):
    """The tables of ``block_mask`` at these block sizes; one object per
    pattern (a FIFO of the last 64), so its device copies are made once."""
    bm = np.asarray(block_mask, bool)
    key = (bm.tobytes(), bm.shape, int(block_q), int(block_k))
    if key not in _tables:
        if len(_tables) >= _TABLES_CAP:
            _tables.pop(next(iter(_tables)))
        _tables[key] = _BlockMaskTables(bm, block_q, block_k)
    return _tables[key]


# ------------------------------------------------------ plain versions
def _blocks(x, block, n):
    """[b, h, s, d] -> [b*h, n, block, d] in f32, s zero-padded to
    n * block."""
    b, h, s, d = x.shape
    xf = x.float().reshape(b * h, s, d)
    if n * block > s:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, n * block - s))
    return xf.reshape(b * h, n, block, d)


def _rows(t, block, n):
    """[b*h, s] -> [b*h, n, block] in f32, zero-padded."""
    tf = t.float()
    if n * block > t.shape[1]:
        tf = torch.nn.functional.pad(tf, (0, n * block - t.shape[1]))
    return tf.reshape(t.shape[0], n, block)


def _key_ok(seq_k, block_k, nk, device):
    """[nk, block_k] bool: the keys of each k-block below seq_k."""
    return (torch.arange(nk * block_k, device=device) < seq_k).reshape(
        nk, block_k)


def _bsa_fwd_ref(q, k, v, kt, cnt, scale, block_q, block_k):
    """Plain version of :func:`bsa_fwd`, the reference kernel's steps:
    for each step j, every q-block meets its k-block kt[:, j] (a step at
    or past cnt leaves the state as it is), base-2 online softmax in f32
    with keys past seq_k at -1e30, p rounded to v's type before p @ v.
    Returns ``(o, lse)``: o ``[b, h, sq, d]`` in q's type, lse f32
    ``[b*h, sq]`` (natural log; a row with no active block: o = 0, lse =
    -1e30 * ln2)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    nq, max_active = kt.shape
    nk = -(-sk // block_k)
    kt, cnt = kt.long(), cnt.long()
    qb = _blocks(q, block_q, nq)
    kb = _blocks(k, block_k, nk)
    vb = _blocks(v, block_k, nk)
    key_ok = _key_ok(sk, block_k, nk, q.device)
    acc = torch.zeros_like(qb)
    m = torch.full(qb.shape[:3] + (1,), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    for j in range(max_active):
        kj = kt[:, j]
        s = torch.matmul(qb, kb[:, kj].transpose(-1, -2)) * (scale * _LOG2E)
        s = s.masked_fill(~key_ok[kj][None, :, None, :], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(p.to(v.dtype).float(), vb[:, kj])
        keep = (j < cnt)[None, :, None, None]
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        acc = torch.where(keep, acc_new, acc)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / l_safe).reshape(b, h, nq * block_q, d)[:, :, :sq]
    lse = (m * _LN2 + torch.log(l_safe)).reshape(b * h, nq * block_q)[:, :sq]
    return o.to(q.dtype), lse.contiguous()


def _bsa_bwd_ref(q, k, v, o, lse, do, tables, scale):
    """The reference's ``_bsa_bwd_rule`` in PyTorch: ``(dq, dk, dv)`` in
    q's, k's and v's types. p = exp(scale * q k^T - lse) in f32 (keys past
    seq_k at 0), delta = rowsum(do * o) in f32, ds = p * (do v^T -
    delta); dq sums scale * ds @ k over each q-row's steps of ``kt``,
    dk (scale * ds^T @ q) and dv (p^T @ do) over each k-column's steps of
    ``qt``. A padded step may meet the lse of an empty row (p = inf): it
    is dropped by ``torch.where``, never multiplied by 0."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    t = tables.on(q.device)
    kt, cnt = t["kt"].long(), t["cnt"].long()
    qt, qcnt = t["qt"].long(), t["qcnt"].long()
    bq, bk = tables.block_q, tables.block_k
    nq, nk = kt.shape[0], qt.shape[0]
    qb, dob = _blocks(q, bq, nq), _blocks(do, bq, nq)
    kb, vb = _blocks(k, bk, nk), _blocks(v, bk, nk)
    lseb = _rows(lse, bq, nq)
    delta = (do.float() * o.float()).sum(dim=-1).reshape(b * h, sq)
    deltab = _rows(delta, bq, nq)
    key_ok = _key_ok(sk, bk, nk, q.device)

    def probs(qx, kx, ls, ok):
        s = torch.matmul(qx, kx.transpose(-1, -2)) * scale
        s = s.masked_fill(~ok[None, :, None, :], -math.inf)
        return torch.exp(s - ls[..., None])

    dq = torch.zeros_like(qb)
    for j in range(kt.shape[1]):                # each q-row's j-th step
        kj = kt[:, j]
        kx, vx = kb[:, kj], vb[:, kj]
        p = probs(qb, kx, lseb, key_ok[kj])
        ds = p * (torch.matmul(dob, vx.transpose(-1, -2)) - deltab[..., None])
        upd = scale * torch.matmul(ds, kx)
        dq = dq + torch.where((j < cnt)[None, :, None, None], upd, 0.0)

    dk = torch.zeros_like(kb)
    dv = torch.zeros_like(vb)
    for j in range(qt.shape[1]):                # each k-column's j-th step
        qi = qt[:, j]
        qx, dox = qb[:, qi], dob[:, qi]
        p = probs(qx, kb, lseb[:, qi], key_ok)
        dvu = torch.matmul(p.transpose(-1, -2), dox)
        ds = p * (torch.matmul(dox, vb.transpose(-1, -2))
                  - deltab[:, qi][..., None])
        dku = scale * torch.matmul(ds.transpose(-1, -2), qx)
        keep = (j < qcnt)[None, :, None, None]
        dk = dk + torch.where(keep, dku, 0.0)
        dv = dv + torch.where(keep, dvu, 0.0)

    def out(g, n, like):
        return g.reshape(b, h, -1, d)[:, :, :n].to(like.dtype)

    return out(dq, sq, q), out(dk, sk, k), out(dv, sk, v)


# -------------------------------------------------------------- checks
def _check_inputs(q, k, v, tables):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("block-sparse attention takes [batch, heads, seq, "
                         "head_dim] tensors")
    b, h, sq, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[1], k.shape[3]) != (b, h, d):
        raise ValueError(f"block-sparse attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if sq == 0 or k.shape[2] == 0:
        raise ValueError("block-sparse attention: empty sequence")
    want = (-(-sq // tables.block_q), -(-k.shape[2] // tables.block_k))
    if tables.shape != want:
        raise ValueError(f"block_mask shape {tables.shape} != (ceil(sq/bq), "
                         f"ceil(sk/bk)) = {want}")


def _check_kernel_operand(name, t, dtype):
    if t.dtype != dtype or t.dtype not in _DTYPES:
        raise TypeError(f"bsa_fwd {name}: dtype {t.dtype} (float32 or "
                        f"bfloat16, q, k and v alike)")
    e = t.element_size()
    if t.stride(-1) != 1 or t.data_ptr() % 16 or \
            any(s * e % 16 for s in t.stride()[:3]):
        raise ValueError(f"bsa_fwd {name}: the last axis must be contiguous "
                         f"and rows 16-byte aligned (strides {t.stride()})")


def _strides(*tensors):
    """(batch, seq, head) strides of each [b, h, s, d] tensor, the order
    the kernel's Strides take."""
    vals = [s for t in tensors for s in (t.stride(0), t.stride(2),
                                         t.stride(1))]
    return (ctypes.c_longlong * len(vals))(*vals)


def _route(*tensors):
    return launch.route("block-sparse attention", *tensors)


def _scale_of(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# ------------------------------------------------------------ wrappers
@launch.booked(cost.bsa_fwd)
def bsa_fwd(q, k, v, tables, scale=None):
    """Block-sparse attention forward over the pattern ``tables`` (from
    :func:`prepare_block_mask`): ``(o, lse)`` with o ``[b, h, sq, d]`` in
    q's type and lse f32 ``[b * h, sq]`` (natural log). The kernel takes
    head_dim in ``HEAD_DIMS`` and block sizes in ``BLOCK_SIZES``."""
    _check_inputs(q, k, v, tables)
    scale = _scale_of(q, scale)
    dev = tables.on(q.device)
    if _route(q, k, v) == "cpu":
        return _bsa_fwd_ref(q, k, v, dev["kt"], dev["cnt"], scale,
                            tables.block_q, tables.block_k)
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"bsa_fwd: head_dim {d} is not one of {HEAD_DIMS}")
    if tables.block_q not in BLOCK_SIZES or tables.block_k not in BLOCK_SIZES:
        raise ValueError(f"bsa_fwd: block_q {tables.block_q}, block_k "
                         f"{tables.block_k}: each must be one of "
                         f"{BLOCK_SIZES}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_operand(name, t, q.dtype)
    o = torch.empty((b, h, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    rc = launch.bind(_SIGNATURES).bsa_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *(dev[n].data_ptr() for n in ("kt", "cnt", "boxes", "bcnt", "order")),
        _strides(q, k, v, o), b, h, sq, k.shape[2], d, _DTYPES[q.dtype],
        tables.block_q, tables.block_k, tables.max_active,
        tables.boxes.shape[0], tables.boxes.shape[1], scale, q.device.index,
        launch.stream(q.device))
    launch.raise_on(rc, "bsa_fwd")
    LAUNCHES["bsa_fwd"] += 1
    return o, lse


class _BlockSparseAttention(torch.autograd.Function):
    """``_bsa_fwd_rule``/``_bsa_bwd_rule``: saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, tables, scale):
        o, lse = bsa_fwd(q, k, v, tables, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.scale = tables, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bsa_bwd_ref(q, k, v, o, lse, do, ctx.tables, ctx.scale)
        return dq, dk, dv, None, None


def block_sparse_flash_attention(q, k, v, tables, scale=None):
    """Differentiable block-sparse attention over ``tables`` (from
    :func:`prepare_block_mask`); q/k/v ``[batch, heads, seq, d]``,
    returns ``[batch, heads, seq_q, d]``."""
    return _BlockSparseAttention.apply(q, k, v, tables, _scale_of(q, scale))


def block_sparse_attention(q, k, v, block_mask, block_q=512, block_k=512,
                           scale=None):
    """Public entry: q/k/v ``[batch, heads, seq, d]``; ``block_mask``
    ``[nq, nk]`` bool (host numpy) with nq = ceil(seq_q / block_q), nk =
    ceil(seq_k / block_k); scale defaults to 1/sqrt(d). Work is
    proportional to the active blocks."""
    return block_sparse_flash_attention(
        q, k, v, prepare_block_mask(block_mask, block_q, block_k), scale)
