"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/transformer.py``).

Without a mask and without dropout in training, attention runs the flash
kernels (:mod:`paddle_tpu_torch.ops.cuda.flash_attention`): on a CUDA
tensor they launch or raise, with no fallback; on a CPU tensor they
compute their plain version. With a mask it is the plain composition of
the reference's ``_sdpa_ref``. Serving does not run this function (its
attention goes through the engine's KV context).
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.ops.cuda.flash_attention import flash_attention_bshd

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None):
    """query/key/value ``[batch, seq, heads, head_dim]``, scaled by
    ``scale`` (default 1/sqrt(head_dim)). ``attn_mask``: bool (True
    keeps) or additive, broadcast to ``[batch, heads, seq_q, seq_k]``.
    The flash path's causal mask is top-left aligned, the composition's
    bottom-right (as in the reference): they agree when the sequences
    have one length."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout in training is not ported yet")
    if attn_mask is None:
        return flash_attention_bshd(query, key, value, causal=is_causal,
                                    scale=scale)
    return _sdpa_ref(query, key, value, attn_mask, is_causal, scale)


def _sdpa_ref(query, key, value, attn_mask, is_causal, scale):
    """Softmax in f32; bf16/fp16 inputs accumulate both contractions in
    f32 and round once at the output."""
    narrow = query.dtype in (torch.bfloat16, torch.float16)
    s = 1.0 / math.sqrt(query.shape[-1]) if scale is None else scale
    q, k, v = (t.transpose(1, 2) for t in (query, key, value))  # [b,h,s,d]
    if narrow:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * s
    else:
        logits = torch.matmul(q, k.transpose(-1, -2)) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(ql, kl, dtype=torch.bool,
                          device=logits.device).tril(diagonal=kl - ql)
        logits = logits.masked_fill(~keep, -1e30)
    if attn_mask.dtype == torch.bool:
        logits = logits.masked_fill(~attn_mask, -1e30)
    else:
        logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    if narrow:
        out = torch.matmul(probs.float(), v.float()).to(query.dtype)
    else:
        out = torch.matmul(probs, v)
    return out.transpose(1, 2)
