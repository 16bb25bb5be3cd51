"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/transformer.py``).

Without a mask and without dropout in training, attention runs the flash
kernels (:mod:`paddle_tpu_torch.ops.cuda.flash_attention`) when
``kernel_takes`` says they take the operands (head_dim 64 or 128, f32
or bf16): on a CUDA tensor they launch or raise, with no fallback; on a
CPU tensor they compute their plain version. Other shapes and types go,
before any launch, to autograd through flash's plain forward (counted in
``flash_attention.ROUTED``), so every head_dim returns what the
reference's Pallas kernel returns, causal mask top-left aligned. With a
mask, or with dropout in training, it is the plain composition of the
reference's ``_sdpa_ref``, whose dropout mask comes from the keep-mask
kernel (:mod:`paddle_tpu_torch.ops.cuda.random`).
Serving does not run this function (its attention goes through the
engine's KV context).

``sparse_attention`` is Paddle's CSR-pattern attention. A pattern that
every (batch, head) shares and that is exactly block-aligned (at 512,
256, 128 or 64 tokens, tried in that order) runs the block-sparse kernel
(:mod:`paddle_tpu_torch.ops.cuda.block_sparse_attention`); any other
pattern, or one with no stored entry, the dense masked composition. The
analysis runs once per pattern: a FIFO cache keyed by the CSR's digest
holds the result with its tables (copied to the device once), and an
identity memo keyed by the CSR tensors' ``id`` and ``_version`` skips the
device-to-host copy and the digest when a loop passes the same tensors
again.
"""
from __future__ import annotations

import hashlib
import math
import time
import weakref

import numpy as np
import torch

from paddle_tpu_torch.nn.functional.common import _keep, _scalar
from paddle_tpu_torch.observability.profile import op_scope
from paddle_tpu_torch.ops.cuda.block_sparse_attention import (
    block_sparse_flash_attention, prepare_block_mask)
from paddle_tpu_torch.ops.cuda import flash_attention as _flash

__all__ = ["scaled_dot_product_attention", "sparse_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """query/key/value ``[batch, seq, heads, head_dim]``, scaled by
    ``scale`` (default 1/sqrt(head_dim)). ``attn_mask``: bool (True
    keeps) or additive, broadcast to ``[batch, heads, seq_q, seq_k]``.
    Without a mask the causal mask is top-left aligned (the flash
    kernels' and their plain forward's), with one bottom-right (the
    reference's ``_sdpa_ref``): they agree when the sequences have one
    length. Dropout in training (``dropout_p > 0``) leaves flash for
    ``_sdpa_ref``, as the reference does, and drops probabilities with a
    mask from the global key."""
    apply_dropout = dropout_p > 0.0 and training
    if attn_mask is None and not apply_dropout:
        if _flash.kernel_takes(query, key, value):
            return _flash.flash_attention_bshd(query, key, value,
                                               causal=is_causal, scale=scale)
        _flash.ROUTED["flash_attention"] += 1
        return _flash_composition(query, key, value, is_causal, scale)
    return _sdpa_ref(query, key, value, attn_mask, is_causal, scale,
                     dropout_p if apply_dropout else 0.0)


def _flash_composition(query, key, value, is_causal, scale):
    """Flash attention at a shape or type the kernels do not take:
    autograd through their plain forward (f32 softmax, p rounded to v's
    type), as the reference's Pallas kernel computes at any head_dim."""
    _flash._check_shapes(query, key, value)
    return _flash._flash_fwd_ref(query, key, value, bool(is_causal),
                                 _flash._scale_of(query, scale))[0]


def _sdpa_ref(query, key, value, attn_mask, is_causal, scale,
              dropout_p=0.0):
    """Softmax in f32; bf16/fp16 inputs accumulate both contractions in
    f32 and round once at the output. With ``dropout_p`` the
    probabilities, rounded to the value type, are multiplied by a keep
    mask drawn from the global key (the keep-mask kernel on CUDA) and
    divided by ``1 - dropout_p``, as the reference's are."""
    narrow = query.dtype in (torch.bfloat16, torch.float16)
    s = 1.0 / math.sqrt(query.shape[-1]) if scale is None else scale
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))  # [b,h,s,d]
    with op_scope(_flash.SCORES_SCOPE):
        if narrow:
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        else:
            logits = torch.matmul(q, k.transpose(-1, -2))
    logits = logits * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(diagonal=kl - ql)
        logits = logits.masked_fill(~keep, -1e30)
    if attn_mask is not None and attn_mask.dtype == torch.bool:
        logits = logits.masked_fill(~attn_mask, -1e30)
    elif attn_mask is not None:
        logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    if dropout_p > 0.0:
        keep = _keep(tuple(probs.shape), 1.0 - dropout_p, probs.dtype,
                     probs.device)
        probs = probs * keep / _scalar(1.0 - dropout_p, probs)
    with op_scope(_flash.VALUES_SCOPE):
        if narrow:
            out = torch.matmul(probs.float(), v.float()).to(query.dtype)
        else:
            out = torch.matmul(probs, v)
    return out.transpose(1, 2)


_block_mask_cache = {}          # digest key -> (block_mask, block, tables) | None
_BLOCK_MASK_CACHE_CAP = 64
_pattern_identity_memo = {}     # (id(offs), id(cols), ql, kl) -> memo entry
_PATTERN_MEMO_CAP = 256
# the pattern analysis: identity-memo hits, analyses run (cache misses)
# and their host seconds
PATTERN_STATS = {"memo_hits": 0, "analyses": 0, "analysis_s": 0.0}
_BLOCKS = (512, 256, 128, 64)


def _cache_put(cache, cap, key, value):
    if len(cache) >= cap:
        cache.pop(next(iter(cache)))   # FIFO eviction
    cache[key] = value


def _to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _csr_entries(o, c, ql):
    """(rows, columns) of one (batch, head) CSR: the entries the loop
    ``for r: c[o[r]:o[r + 1]]`` visits, in that order, vectorised."""
    n = len(c)
    start = np.clip(o[:ql].astype(np.int64), 0, n)
    stop = np.clip(o[1:ql + 1].astype(np.int64), 0, n)
    count = np.maximum(stop - start, 0)
    rows = np.repeat(np.arange(ql), count)
    first = np.repeat(start - (np.cumsum(count) - count), count)
    return rows, c[first + np.arange(len(rows))]


def _csr_token_mask(o, c, ql, kl):
    m = np.zeros((ql, kl), bool)
    rows, cols = _csr_entries(o, c, ql)
    m[rows, cols] = True
    return m


def _csr_shared_mask(offs_np, cols_np, ql, kl):
    """The single [ql, kl] token mask all (b, h) share, or None. A (b, h)
    whose CSR arrays equal the first one's shares its mask unbuilt."""
    b, h = offs_np.shape[:2]
    o0, c0 = offs_np[0, 0], cols_np[0, 0]
    base = _csr_token_mask(o0, c0, ql, kl)
    for bi in range(b):
        for hi in range(h):
            o, c = offs_np[bi, hi], cols_np[bi, hi]
            if np.array_equal(o, o0) and np.array_equal(c, c0):
                continue
            if not np.array_equal(base, _csr_token_mask(o, c, ql, kl)):
                return None
    return base


def _mask_block_aligned(base, ql, kl, block):
    """[nq, nk] block mask if `base` is exactly block-aligned, else None."""
    if ql % block or kl % block:
        return None
    n = base.reshape(ql // block, block, kl // block, block).sum(axis=(1, 3))
    if not np.all((n == 0) | (n == block * block)):
        return None
    return n == block * block


def _version(t):
    return getattr(t, "_version", None)


def _block_pattern(offs, cols, ql, kl):
    """``(block_mask, block, tables)`` when the CSR is shared across (b, h)
    and block-aligned with an active block, else None; cached by the
    CSR's digest, with an identity memo in front."""
    ident = (id(offs), id(cols), ql, kl)
    memo = _pattern_identity_memo.get(ident)
    key = None
    if memo is not None:
        # id() can be reused after GC, and in-place mutation keeps id
        # but bumps _version: the memo counts only for the same live
        # objects at the same versions
        k, r1, r2, v1, v2 = memo
        if r1() is offs and r2() is cols and v1 == _version(offs) \
                and v2 == _version(cols):
            key = k
            PATTERN_STATS["memo_hits"] += 1
    offs_np = cols_np = None
    if key is None:
        if isinstance(offs, torch.Tensor) and offs.is_cuda and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "sparse_attention: the CSR is not memoised as it is now and "
                "cannot be analysed inside a CUDA graph capture (a replay "
                "would reuse the pattern whatever the CSR then holds): keep "
                "the CSR out of the captured step's arguments")
        offs_np, cols_np = _to_np(offs), _to_np(cols)
        dig = hashlib.sha256()
        dig.update(offs_np.tobytes())
        dig.update(cols_np.tobytes())
        key = (dig.hexdigest(), ql, kl)
        try:
            _cache_put(_pattern_identity_memo, _PATTERN_MEMO_CAP, ident,
                       (key, weakref.ref(offs), weakref.ref(cols),
                        _version(offs), _version(cols)))
        except TypeError:
            pass  # plain ndarrays/lists are not weakref-able
    if key in _block_mask_cache:
        return _block_mask_cache[key]
    t0 = time.perf_counter()
    if offs_np is None:
        offs_np, cols_np = _to_np(offs), _to_np(cols)
    hit = None
    base = _csr_shared_mask(offs_np, cols_np, ql, kl)
    if base is not None:
        for block in _BLOCKS:
            bm = _mask_block_aligned(base, ql, kl, block)
            if bm is not None and bm.any():
                # all-empty patterns stay on the dense path (a defined
                # zero output, no kernel tables)
                hit = (bm, block, prepare_block_mask(bm, block, block))
                break
    _cache_put(_block_mask_cache, _BLOCK_MASK_CACHE_CAP, key, hit)
    PATTERN_STATS["analyses"] += 1
    PATTERN_STATS["analysis_s"] += time.perf_counter() - t0
    return hit


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None):
    """Attention at the positions a CSR pattern lists: q/k/v ``[batch,
    heads, seq, head_dim]``, ``sparse_csr_offset`` ``[batch, heads, seq_q
    + 1]`` and ``sparse_csr_columns`` ``[batch, heads, nnz]`` (integer
    tensors or arrays); scale 1/sqrt(head_dim). A query row with no stored
    entry gives zeros. With ``key_padding_mask`` or ``attn_mask`` given
    the block-sparse kernel is skipped and the dense CSR composition
    runs, which reads neither mask: the reference's behaviour
    (``paddle_tpu/nn/functional/transformer.py:130``), a defect both
    packages share."""
    if key_padding_mask is not None or attn_mask is not None:
        return _sparse_attention_dense(query, key, value, sparse_csr_offset,
                                       sparse_csr_columns)
    ql, kl = query.shape[2], key.shape[2]
    hit = _block_pattern(sparse_csr_offset, sparse_csr_columns, ql, kl)
    if hit is not None:
        return block_sparse_flash_attention(query, key, value, hit[2])
    return _sparse_attention_dense(query, key, value, sparse_csr_offset,
                                   sparse_csr_columns)


def _sparse_attention_dense(q, k, v, offs, cols):
    """The reference's dense fallback, in the inputs' dtype: scores
    masked to -1e30 outside the CSR pattern, softmax, and zero rows where
    the pattern stores nothing."""
    b, h, ql, d = q.shape
    kl = k.shape[2]
    offs_np, cols_np = _to_np(offs), _to_np(cols)
    m = np.zeros((b, h, ql, kl), bool)
    for bi in range(b):
        for hi in range(h):
            m[bi, hi] = _csr_token_mask(offs_np[bi, hi], cols_np[bi, hi],
                                        ql, kl)
    mask = torch.from_numpy(m).to(q.device)
    logits = torch.matmul(q, k.transpose(-1, -2)) / torch.sqrt(
        torch.tensor(float(d))).to(q.dtype)
    logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    return torch.matmul(p, v)
