"""Quantized KV-cache pages: per-page-scaled int8 / fp8 paged pools
(counterpart of ``paddle_tpu/quantization/kv_cache.py``).

Storage, as in the reference:

- code pools ``[num_pages, n_head, page_size, head_dim]`` in the code
  type (int8, float8_e4m3fn or float8_e5m2);
- scale pools ``[num_pages, n_head]`` f32, one scale per (page, head);
- value ~ code * scale, ``scale = absmax / qmax`` over the page's real
  tokens.

A pool is a ``(codes, scales)`` pair written in place at fixed shapes,
as the port's plain pools are (``incubate/nn/paged_attention.py``), so
the engine's programs stay CUDA graphs. Prefill quantizes each
(row-page, head) block against the absmax of its real tokens (padding
masked out) and scatters codes token-wise and scales page-wise, padding
routed to the garbage page 0. Decode appends one token a row with
rescale-on-append: the page's scale grows monotonically and the page's
codes are re-gridded by ``old / new``, exactly 1.0 when it does not
grow, so those codes stay bit-identical; a page at offset 0 is fresh
(its previous owner's scale is ignored). Attention dequantizes the
gathered pages (codes * scale in f32) and accumulates both contractions
in f32, rounding once to the query's type.

The reference's functions are plain XLA (no ``pallas_call``), so these
are torch compositions; the codes and scales equal the reference's bit
for bit (``torch.round`` and ``jnp.round`` both round half to even, and
the fp8 casts after the clip round alike). fp8 codes are moved through
their uint8 view: a copy of the same bits whichever index kernels the
build has for the fp8 types.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = [
    "KVQuantSpec",
    "KV_CACHE_DTYPES",
    "dequantize_codes",
    "encode_int_codes",
    "kv_bytes_per_token",
    "quantize_block",
    "quantized_attend",
    "quantized_decode_step",
    "quantized_prefill_append",
    "resolve_kv_cache_dtype",
]


@dataclass(frozen=True)
class KVQuantSpec:
    """One supported code type of the quantized KV pools."""

    name: str            # the config string ("int8", "fp8_e4m3", ...)
    code_dtype: torch.dtype
    qmax: float          # the largest magnitude on the code grid
    is_int: bool         # int codes round and clip; fp8 codes cast

    @property
    def code_bytes(self):
        return self.code_dtype.itemsize


KV_CACHE_DTYPES = {
    "int8": KVQuantSpec("int8", torch.int8, 127.0, True),
    "fp8_e4m3": KVQuantSpec("fp8_e4m3", torch.float8_e4m3fn,
                            float(torch.finfo(torch.float8_e4m3fn).max),
                            False),
    "fp8_e5m2": KVQuantSpec("fp8_e5m2", torch.float8_e5m2,
                            float(torch.finfo(torch.float8_e5m2).max), False),
}


def resolve_kv_cache_dtype(name):
    """Config string -> :class:`KVQuantSpec` (None and a spec pass
    through); ValueError naming the supported set otherwise."""
    if name is None or isinstance(name, KVQuantSpec):
        return name
    spec = KV_CACHE_DTYPES.get(str(name))
    if spec is None:
        raise ValueError(
            f"kv_cache_dtype {name!r} is not supported here; choose None "
            f"or one of {sorted(KV_CACHE_DTYPES)}")
    return spec


def kv_bytes_per_token(num_heads, head_dim, page_size, spec=None,
                       dtype=torch.float32):
    """Pool bytes per token of KV capacity for one layer (K + V): a
    quantized pool pays ``code_bytes`` an element plus its f32 scale
    spread over the page's tokens."""
    if spec is None:
        return 2 * num_heads * head_dim * dtype.itemsize
    per_head = head_dim * spec.code_bytes + 4.0 / page_size
    return 2 * num_heads * per_head


# ----------------------------------------------------------- primitives
def encode_int_codes(scaled, qmax, key=None, dtype=torch.int8):
    """Round half to even, clip to +-qmax, cast. Stochastic rounding
    (``key``) serves the quantized collectives, not ported yet."""
    if key is not None:
        raise NotImplementedError(
            "encode_int_codes(key=...): stochastic rounding comes with the "
            "quantized collectives")
    return torch.clamp(torch.round(scaled), -qmax, qmax).to(dtype)


def _grid(scaled, spec):
    """Scaled values (value / scale) -> their codes' values, in f32."""
    if spec.is_int:
        return torch.clamp(torch.round(scaled), -spec.qmax, spec.qmax)
    # fp8: the cast is the rounding; the clip keeps outliers finite
    return torch.clamp(scaled, -spec.qmax, spec.qmax).to(
        spec.code_dtype).float()


def _encode(scaled, spec):
    """Scaled values -> codes on the spec's grid."""
    if spec.is_int:
        return encode_int_codes(scaled, spec.qmax, dtype=spec.code_dtype)
    return torch.clamp(scaled, -spec.qmax, spec.qmax).to(spec.code_dtype)


def _bits(codes):
    """The codes as a type every index kernel takes (fp8 as uint8)."""
    return codes if codes.dtype == torch.int8 else codes.view(torch.uint8)


def quantize_block(values, spec, axes):
    """``(codes, scales)`` with one scale per block, ``axes`` the ones
    reduced into a scale (kept as size 1). An all-zero block gets scale 0
    and zero codes."""
    v = values.float()
    absmax = torch.amax(torch.abs(v), dim=axes, keepdim=True)
    scales = absmax / spec.qmax
    safe = torch.where(scales > 0, scales, 1.0)
    return _encode(v / safe, spec), scales


def dequantize_codes(codes, scales, spec=None):
    """``codes * scales`` in f32 (``scales`` shaped to broadcast)."""
    del spec
    return codes.float() * scales


# ------------------------------------------------------------- prefill
def quantized_prefill_append(k_new, v_new, kq, vq, tables, lens,
                             page_size, spec):
    """Batched prompt write into quantized pools, in place.

    k_new/v_new ``[b, h, S, d]``; kq/vq ``(codes, scales)``; tables
    ``[b, P]``; lens ``[b]`` (0: the row is not prefilled). Each
    (row-page, head) block is scaled by the absmax of the real tokens
    landing in it; codes scatter token-wise, scales page-wise, masked
    positions and slots to the garbage page 0. Returns ``(kq, vq)``."""
    b, h, S, d = k_new.shape
    lens = lens.long()
    tables = tables.long()
    t = torch.arange(S, device=k_new.device)
    page_idx = torch.clamp(t // page_size, max=tables.shape[1] - 1)
    offs = t % page_size
    valid = t[None, :] < lens[:, None]
    flat_pages = torch.where(valid, tables[:, page_idx], 0).reshape(-1)
    flat_offs = offs.repeat(b)
    n_slots = -(-S // page_size)          # row-page slots covering S
    pad = n_slots * page_size - S
    slot_start = torch.arange(n_slots, device=k_new.device) * page_size
    slot_ids = torch.where(slot_start[None, :] < lens[:, None],
                           tables[:, :n_slots], 0).reshape(-1)

    def write(pool, vals):
        codes_pool, scales_pool = pool
        vv = torch.where(valid[:, None, :, None], vals.float(), 0.0)
        blocks = F.pad(vv, (0, 0, 0, pad)).reshape(b, h, n_slots,
                                                   page_size, d)
        scales = torch.amax(torch.abs(blocks), dim=(3, 4)) / spec.qmax
        safe = torch.where(scales > 0, scales, 1.0)             # [b, h, n]
        per_tok = safe.repeat_interleave(page_size, dim=2)[:, :, :S]
        codes = _encode(vv / per_tok[..., None], spec)
        ct = codes.transpose(1, 2).reshape(b * S, h, d)
        _bits(codes_pool)[flat_pages, :, flat_offs] = _bits(ct)
        scales_pool[slot_ids] = scales.transpose(1, 2).reshape(
            b * n_slots, h)
        return pool

    return write(kq, k_new), write(vq, v_new)


# -------------------------------------------------------------- decode
def _append_token(pool, tok, page_ids, offs, spec):
    """Rescale-on-append of one token a row into its page, in place.

    pool ``(codes [N, h, p, d], scales [N, h])``; tok ``[b, h, d]``;
    page_ids/offs ``[b]``."""
    codes_pool, scales_pool = pool
    p = codes_pool.shape[2]
    page = _bits(codes_pool)[page_ids].view(codes_pool.dtype)  # [b,h,p,d]
    old_scale = torch.where(offs[:, None] == 0, 0.0,
                            scales_pool[page_ids])             # [b, h]
    tok32 = tok.float()
    tok_scale = torch.amax(torch.abs(tok32), dim=-1) / spec.qmax
    new_scale = torch.maximum(old_scale, tok_scale)
    safe = torch.where(new_scale > 0, new_scale, 1.0)
    ratio = old_scale / safe
    regrid = dequantize_codes(page, ratio[..., None, None])
    here = (torch.arange(p, device=tok.device)[None, None, :, None]
            == offs[:, None, None, None])
    # the select in f32, on values the code type holds exactly
    page = torch.where(here, _grid(tok32 / safe[..., None], spec)[:, :, None],
                       _grid(regrid, spec)).to(codes_pool.dtype)
    _bits(codes_pool)[page_ids] = _bits(page)
    scales_pool[page_ids] = new_scale
    return pool


def quantized_decode_step(q, k_new, v_new, kq, vq, tables, lens,
                          page_size, spec, scale=None):
    """Write each row's new token at position ``lens[b]`` (rescale on
    append, in place) and attend over ``lens[b] + 1`` tokens. Returns
    ``(out, kq, vq)``; the caller owns the lens update."""
    lens = lens.long()
    tables = tables.long()
    page_ids = tables.gather(1, (lens // page_size)[:, None])[:, 0]   # [b]
    offs = lens % page_size
    _append_token(kq, k_new.transpose(1, 2)[:, 0], page_ids, offs, spec)
    _append_token(vq, v_new.transpose(1, 2)[:, 0], page_ids, offs, spec)
    out = quantized_attend(q, kq, vq, tables, lens + 1, page_size, spec,
                           scale)
    return out, kq, vq


# -------------------------------------------------------------- attend
def quantized_attend(q, kq, vq, tables, lens, page_size, spec, scale=None):
    """``[b, h, 1, d]`` queries over the rows' dequantized pages, masked
    at ``lens``; both contractions in f32, one rounding to q's type."""
    del spec
    b, h, _one, d = q.shape
    sc = scale if scale is not None else 1.0 / float(d) ** 0.5
    tables = tables.long()
    P = tables.shape[1]

    def seq(pool):
        # gathered in the codes' type and dequantized straight into the
        # [b, h, P, p, d] layout: int8 codes in one pass (fp8 codes do
        # not promote, so they convert first), the same values as
        # scaling first and transposing after
        codes, scales = pool
        pages = _bits(codes)[tables].view(codes.dtype).transpose(1, 2)
        if codes.dtype != torch.int8:
            pages = pages.float()
        x = torch.empty(pages.shape, dtype=torch.float32, device=q.device)
        torch.mul(pages, scales[tables].transpose(1, 2)[..., None, None],
                  out=x)
        return x.reshape(b, h, P * page_size, d)

    k_seq, v_seq = seq(kq), seq(vq)
    pos = torch.arange(P * page_size, device=q.device)
    mask = pos[None, None, None, :] < lens.long()[:, None, None, None]
    s = torch.matmul(q.float() * sc, k_seq.transpose(-1, -2))
    s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v_seq).to(q.dtype)               # [b, h, 1, d]
