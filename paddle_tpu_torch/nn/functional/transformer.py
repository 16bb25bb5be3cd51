"""Attention functionals (counterpart of
``paddle_tpu/nn/functional/transformer.py``).

This is the plain composition of the reference's ``_sdpa_ref``. The
flash-attention kernels (``paddle_tpu/ops/pallas/flash_attention.py``)
are ported with the training path; serving does not run this function
(its attention goes through the engine's KV context).
"""
from __future__ import annotations

import math

import torch

__all__ = ["scaled_dot_product_attention"]


def scaled_dot_product_attention(query, key, value, is_causal=False):
    """query/key/value ``[batch, seq, heads, head_dim]``, scaled by
    1/sqrt(head_dim); softmax in f32; bf16/fp16 inputs accumulate both
    contractions in f32 and round once at the output."""
    narrow = query.dtype in (torch.bfloat16, torch.float16)
    s = 1.0 / math.sqrt(query.shape[-1])
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
    probs = torch.softmax(logits.float(), dim=-1).to(query.dtype)
    if narrow:
        out = torch.matmul(probs.float(), v.float()).to(query.dtype)
    else:
        out = torch.matmul(probs, v)
    return out.transpose(1, 2)
