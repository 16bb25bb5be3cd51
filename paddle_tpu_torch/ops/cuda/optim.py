"""Fused AdamW kernel (``csrc/optim.cu``): wrapper, plain version and
launch counts.

:func:`fused_adam_update` replaces
``paddle_tpu/ops/pallas/optim.py:_adam_kernel`` (driven there by
``fused_adam_update``): one AdamW step of one rank-2 parameter, reading
p, g, m and v once and writing p, m and v once, in place. With
``guard=True`` the parameter's rows are cut into the reference's row
blocks (:func:`_pick_block_rows`), each block's f32 gradient
sum-of-squares is returned, and a block whose sum is not finite keeps
its p, m and v (the zero-update skip of the training sentinel).

The scalars come as one 4-float device tensor ``sc = [lr, 1 - beta1^t,
1 - beta2^t, decay_on]``, made by the caller with torch ops, so an
update never reads a value back to the host.

A wrapper given CPU tensors computes the plain version
(:func:`_adam_ref`: the reference kernel's f32 arithmetic in its order,
written in place). Given CUDA tensors it launches the kernels on the
current stream, without synchronising, or raises. ``LAUNCHES`` counts
the launches: ``adam_update`` (unguarded), ``adam_update_guard`` (the
guarded update) and ``adam_guard_sumsq`` (the guard's per-chunk sums of
squares, launched before each guarded update).
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.ops.cuda import cost, launch

__all__ = ["LAUNCHES", "fused_adam_update", "supports_fused"]

LAUNCHES = launch.counts(("adam_update", "adam_update_guard",
                           "adam_guard_sumsq"))
# per-operand block-bytes ceiling of the reference's row blocks: the
# guard's regions are exactly its blocks
_BLOCK_BYTES = 1 << 21
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_REGIONS = 65535           # the kernels' grid.y

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "adam_chunk_elems": [],
    "adam_sumsq": [_P, _I, _L, _L, _I, _I, _P, _I, _P],
    "adam_update": [_P, _P, _P, _P, _P, _I, _I, _L, _L, _I, _I,
                    _F, _F, _F, _F, _F, _F, _P, _P, _I, _P],
}


def _lib():
    return launch.bind(_SIGNATURES)


def supports_fused(shape):
    """The fused kernel takes rank-2 parameters (every Linear and
    Embedding weight); rank-1 biases and norm scales stay on the
    unfused loop, as in the reference."""
    return len(tuple(shape)) == 2


def _pick_block_rows(rows, row_bytes):
    """Largest power-of-two row block that divides ``rows`` and keeps a
    block under ``_BLOCK_BYTES``; the whole array (a single block) for
    row counts that 8 does not divide."""
    br = 8
    while br * 2 <= rows and rows % (br * 2) == 0 \
            and (br * 2) * row_bytes <= _BLOCK_BYTES:
        br *= 2
    if rows % br != 0:
        return rows
    return br


def _regions(shape):
    """(row block, number of blocks) of a rank-2 parameter."""
    rows, cols = shape
    br = _pick_block_rows(rows, cols * 4)
    return br, rows // br


# ------------------------------------------------------ plain version
def _adam_ref(p, g, m, v, sc, beta1, beta2, eps, weight_decay, guard):
    """Plain version of :func:`fused_adam_update`: the reference
    kernel's f32 math in its order, written into p, m and v; under
    guard the [blocks] f32 sums of g*g, and every block whose sum is not
    finite keeps its p, m and v."""
    lr, c1, c2, decay_on = sc.unbind()
    p0 = p.float()
    g = g.float()
    m0 = m.float()
    v0 = v.float()
    pf = p0
    if weight_decay:
        pf = pf * (1.0 - decay_on * lr * weight_decay)
    new_m = beta1 * m0 + (1.0 - beta1) * g
    new_v = beta2 * v0 + (1.0 - beta2) * g * g
    mhat = new_m / c1
    vhat = new_v / c2
    upd = lr * mhat / (torch.sqrt(vhat) + eps)
    new_p = pf - upd
    parts = None
    if guard:
        br, blocks = _regions(p.shape)
        gb = g.reshape(blocks, br * p.shape[1])
        parts = (gb * gb).sum(dim=1)
        good = torch.isfinite(parts).repeat_interleave(br)[:, None]
        # where, not a multiply: NaN * 0 is NaN
        new_p = torch.where(good, new_p, p0)
        new_m = torch.where(good, new_m, m0)
        new_v = torch.where(good, new_v, v0)
    p.copy_(new_p)
    m.copy_(new_m)
    v.copy_(new_v)
    return parts


# -------------------------------------------------------------- checks
def _route(*tensors):
    return launch.route("fused AdamW", *tensors)


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"fused_adam_update: {name} on {t.device}, "
                         f"p on {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"fused_adam_update: {name} dtype {t.dtype} not "
                        f"supported ({', '.join(map(str, dtypes))})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_adam_update: {name} shape "
                         f"{tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_adam_update: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"fused_adam_update: {name} data must be "
                         f"16-byte aligned")


# ----------------------------------------------------------- launchers
def _layout(shape):
    """(elements, row-block elements, blocks, chunks per block, elements
    per chunk) of a rank-2 parameter: the kernels' grid is chunks x
    blocks, a chunk's size the kernel's own."""
    br, regions = _regions(shape)
    region_elems = br * shape[1]
    chunk = _lib().adam_chunk_elems()
    return (shape[0] * shape[1], region_elems, regions,
            max(1, -(-region_elems // chunk)), chunk)


def _chunk_sumsq_ref(g, layout):
    """Plain version of :func:`_chunk_sumsq`."""
    _, region_elems, regions, chunks, chunk = layout
    gf = g.float().reshape(regions, region_elems)
    gf = torch.nn.functional.pad(gf, (0, chunks * chunk - region_elems))
    gf = gf.reshape(regions, chunks, chunk)
    return (gf * gf).sum(dim=2).reshape(-1)


def _chunk_sumsq(g, layout):
    """The guard's first kernel: f32 sum of g*g over each chunk of each
    row block, ``[blocks * chunks]``."""
    n, region_elems, regions, chunks, _ = layout
    parts = torch.empty(regions * chunks, dtype=torch.float32,
                        device=g.device)
    rc = _lib().adam_sumsq(g.data_ptr(), _DTYPES[g.dtype], n, region_elems,
                           regions, chunks, parts.data_ptr(), g.device.index,
                           launch.stream(g.device))
    launch.raise_on(rc, "adam_sumsq")
    LAUNCHES["adam_guard_sumsq"] += 1
    return parts


def _update(p, g, m, v, sc, layout, beta1, beta2, eps, weight_decay,
            chunk_parts=None):
    """The update kernel; with ``chunk_parts`` (from :func:`_chunk_sumsq`)
    guarded, returning the ``[blocks]`` sums of squares."""
    n, region_elems, regions, chunks, _ = layout
    region_parts = None if chunk_parts is None else torch.empty(
        regions, dtype=torch.float32, device=p.device)
    rc = _lib().adam_update(
        p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
        sc.data_ptr(), _DTYPES[g.dtype], _DTYPES[m.dtype], n, region_elems,
        regions, chunks, float(beta1), float(beta2), float(1.0 - beta1),
        float(1.0 - beta2), float(eps), float(weight_decay),
        launch.ptr(chunk_parts), launch.ptr(region_parts), p.device.index,
        launch.stream(p.device))
    launch.raise_on(rc, "adam_update")
    LAUNCHES["adam_update" if chunk_parts is None
             else "adam_update_guard"] += 1
    return region_parts


# ------------------------------------------------------------- wrapper
@launch.booked(cost.adam)
def fused_adam_update(p, g, m, v, sc, *, beta1, beta2, eps,
                      weight_decay=0.0, guard=False):
    """One AdamW step of the rank-2 parameter ``p``, in place in p, m
    and v. ``sc`` is a 4-float f32 tensor on p's device, ``[lr,
    1 - beta1^t, 1 - beta2^t, decay_on]``; ``weight_decay`` non-zero
    applies the decoupled decay ``p * (1 - decay_on * lr *
    weight_decay)`` first. Moments keep their storage type (f32 or
    bf16), the math is f32. Returns None, or with ``guard=True`` the
    f32 ``[blocks]`` gradient sums of squares of p's row blocks, each
    block committing only where its sum is finite."""
    if len(p.shape) != 2:
        raise ValueError(f"fused_adam_update: p must be rank 2, got "
                         f"shape {tuple(p.shape)}")
    if _route(p, g, m, v, sc) == "cpu":
        return _adam_ref(p, g, m, v, sc, beta1, beta2, eps, weight_decay,
                         guard)
    dev = p.device
    _check("p", p, p.shape, (torch.float32,), dev)
    _check("g", g, p.shape, tuple(_DTYPES), dev)
    _check("m", m, p.shape, tuple(_DTYPES), dev)
    _check("v", v, p.shape, (m.dtype,), dev)
    _check("sc", sc, (4,), (torch.float32,), dev)
    _, regions = _regions(p.shape)
    if p.numel() == 0:
        return torch.zeros(regions, dtype=torch.float32, device=dev) \
            if guard else None
    if regions > _MAX_REGIONS:
        raise ValueError(f"fused_adam_update: {regions} row blocks, at "
                         f"most {_MAX_REGIONS}")
    layout = _layout(p.shape)
    chunk_parts = _chunk_sumsq(g, layout) if guard else None
    return _update(p, g, m, v, sc, layout, beta1, beta2, eps, weight_decay,
                   chunk_parts)
