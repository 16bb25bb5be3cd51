"""Transformer layers (counterpart of ``paddle_tpu/nn/layer/transformer.py``).

:class:`MultiHeadAttention` keeps Paddle's API, the incremental-decode
caches included, and runs its attention through
:func:`paddle_tpu_torch.nn.functional.scaled_dot_product_attention`:
flash (the port's kernels) without a mask or dropout, the composition
otherwise. The post-LN joins of the encoder and decoder layers take the
LayerNorm kernels' y-only entry under ``fused_ln=True``
(:func:`paddle_tpu_torch.nn.functional.norm.fused_add_layer_norm`).

Weights keep the reference's names and layouts (``q_proj.weight [in,
out]``, ``norm1.weight``, ``layers.0...``), so a reference state dict
loads by name; they are drawn from Normal(0, sqrt(2 / (in + out))), the
reference's Xavier normal, with an explicit generator (None: one seeded
0, which the module and the layers it clones draw all their parameters
from in turn).
``bias_attr=False`` drops the biases of every projection; any other
ParamAttr comes with ``nn/initializer.py`` (ROADMAP A.7).

Shared with the reference, as it behaves:

- ``need_weights`` is stored and never read;
- :meth:`MultiHeadAttention.gen_cache` starts the self-attention cache
  as f32 zeros, so under bf16 the concatenated keys and values are f32
  while the queries are bf16;
- :class:`TransformerEncoder` / :class:`TransformerDecoder` clone their
  first layer with :func:`_clone_args`, which carries neither
  ``weight_attr`` nor ``bias_attr``: layer 0 of
  ``TransformerEncoder(TransformerEncoderLayer(..., bias_attr=False),
  6)`` has no biases and layers 1-5 have them.
"""
from __future__ import annotations

import collections
import math

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import norm as F_norm
from paddle_tpu_torch.nn.layer.common import (Dropout, Linear,
                                             module_generator, param_attrs)
from paddle_tpu_torch.nn.layer.norm import LayerNorm
from paddle_tpu_torch.observability.profile import layer_scope

__all__ = ["MultiHeadAttention", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]


def _linear(n_in, n_out, bias, factory):
    return Linear(n_in, n_out, math.sqrt(2.0 / (n_in + n_out)), bias,
                  **factory)


class MultiHeadAttention(nn.Module):
    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        bias = param_attrs("MultiHeadAttention",
                           weight_attr=weight_attr, bias_attr=bias_attr)
        factory = dict(device=device, dtype=dtype,
                       generator=module_generator(generator, device))
        self.q_proj = _linear(embed_dim, embed_dim, bias, factory)
        self.k_proj = _linear(self.kdim, embed_dim, bias, factory)
        self.v_proj = _linear(self.vdim, embed_dim, bias, factory)
        self.out_proj = _linear(embed_dim, embed_dim, bias, factory)

    def _heads(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.num_heads,
                         self.head_dim)

    def _prepare_qkv(self, query, key, value, cache=None):
        q = self._heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value))
        if isinstance(cache, self.Cache):
            k = torch.cat([cache.k, k], dim=1)
            v = torch.cat([cache.v, v], dim=1)
            cache = self.Cache(k, v)
        return q, k, v, cache

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """``StaticCache`` (with ``type=MultiHeadAttention.StaticCache``):
        ``key`` and ``value`` projected once, for cross-attention over a
        fixed memory. Otherwise an empty ``Cache``: f32 zeros ``[b, 0,
        heads, head_dim]`` on key's device, grown a step at a time."""
        if type == MultiHeadAttention.StaticCache:
            k = self._heads(self.k_proj(key))
            v = self._heads(self.v_proj(value if value is not None
                                        else key))
            return self.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(
            torch.zeros(shape, dtype=torch.float32, device=key.device),
            torch.zeros(shape, dtype=torch.float32, device=key.device))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = query if value is None else value
        q, k, v, cache = self._prepare_qkv(query, key, value, cache)
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training)
        out = self.out_proj(out.reshape(out.shape[0], out.shape[1],
                                        self.embed_dim))
        return out if cache is None else (out, cache)


def _residual_ln(norm, residual, delta, fused, scope_name):
    """The post-LN join ``norm(residual + delta)``. With ``fused`` (and a
    weight) it is the LayerNorm kernel's y-only entry, under the norm's
    scope name, as the reference's Pallas join is."""
    if fused and norm.weight is not None:
        with layer_scope(scope_name):
            return F_norm.fused_add_layer_norm(delta, residual, norm.weight,
                                               norm.bias, norm._epsilon)
    return norm(residual + delta)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 fused_ln=False, device=None, dtype=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self._fused_ln = fused_ln
        self._factory = dict(device=device, dtype=dtype,
                             generator=module_generator(generator, device))
        bias = param_attrs("TransformerEncoderLayer",
                           weight_attr=weight_attr, bias_attr=bias_attr)
        self.self_attn = MultiHeadAttention(
            d_model, nhead, attn_dropout, weight_attr=weight_attr,
            bias_attr=bias_attr, **self._factory)
        self.linear1 = _linear(d_model, dim_feedforward, bias, self._factory)
        self.dropout = Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, bias, self._factory)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = activation

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        if not self.normalize_before:
            src = _residual_ln(self.norm1, residual, self.dropout1(src),
                               self._fused_ln, "norm1")
        else:
            src = residual + self.dropout1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(getattr(F, self.activation)(
            self.linear1(src))))
        if not self.normalize_before:
            src = _residual_ln(self.norm2, residual, self.dropout2(src),
                               self._fused_ln, "norm2")
        else:
            src = residual + self.dropout2(src)
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 fused_ln=False, device=None, dtype=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self._fused_ln = fused_ln
        self._factory = dict(device=device, dtype=dtype,
                             generator=module_generator(generator, device))
        bias = param_attrs("TransformerDecoderLayer",
                           weight_attr=weight_attr, bias_attr=bias_attr)
        attn = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                    **self._factory)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **attn)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **attn)
        self.linear1 = _linear(d_model, dim_feedforward, bias, self._factory)
        self.dropout = Dropout(act_dropout)
        self.linear2 = _linear(dim_feedforward, d_model, bias, self._factory)
        self.norm1 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm2 = LayerNorm(d_model, device=device, dtype=dtype)
        self.norm3 = LayerNorm(d_model, device=device, dtype=dtype)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = activation

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
            incremental_cache = None
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        if not self.normalize_before:
            tgt = _residual_ln(self.norm1, residual, self.dropout1(tgt),
                               self._fused_ln, "norm1")
        else:
            tgt = residual + self.dropout1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
            static_cache = None
        else:
            tgt, static_cache = self.cross_attn(tgt, memory, memory,
                                                memory_mask, cache[1])
        if not self.normalize_before:
            tgt = _residual_ln(self.norm2, residual, self.dropout2(tgt),
                               self._fused_ln, "norm2")
        else:
            tgt = residual + self.dropout2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(getattr(F, self.activation)(
            self.linear1(tgt))))
        if not self.normalize_before:
            tgt = _residual_ln(self.norm3, residual, self.dropout3(tgt),
                               self._fused_ln, "norm3")
        else:
            tgt = residual + self.dropout3(tgt)
        if cache is None:
            return tgt
        return tgt, (incremental_cache, static_cache)

    def gen_cache(self, memory):
        incremental = self.self_attn.gen_cache(memory)
        static = self.cross_attn.gen_cache(memory, memory,
                                           MultiHeadAttention.StaticCache)
        return incremental, static


def _clone_args(layer):
    """The arguments that build a layer like ``layer``, as the
    reference's ``_clone_args`` gives them: without ``weight_attr`` and
    ``bias_attr`` (a defect both packages share), with its device, dtype
    and generator."""
    if not isinstance(layer, (TransformerEncoderLayer,
                              TransformerDecoderLayer)):
        raise TypeError(type(layer))
    return dict(
        d_model=layer.self_attn.embed_dim, nhead=layer.self_attn.num_heads,
        dim_feedforward=layer.linear1.weight.shape[1],
        dropout=layer.dropout1.p, activation=layer.activation,
        attn_dropout=layer.self_attn.dropout, act_dropout=layer.dropout.p,
        normalize_before=layer.normalize_before, fused_ln=layer._fused_ln,
        **layer._factory)


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([encoder_layer] + [
            type(encoder_layer)(**_clone_args(encoder_layer))
            for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList([decoder_layer] + [
            type(decoder_layer)(**_clone_args(decoder_layer))
            for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        caches = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*caches)) if do_zip else caches


class Transformer(nn.Module):
    """An encoder and a decoder at the defaults of Vaswani et al. 2017's
    base model (512 wide, 8 heads, 6 + 6 layers, an FFN of 2048, dropout
    0.1, post-LN); ``custom_encoder`` / ``custom_decoder`` replace
    them."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype,
                       generator=module_generator(generator, device))
        layer_args = (d_model, nhead, dim_feedforward, dropout, activation,
                      attn_dropout, act_dropout, normalize_before,
                      weight_attr, bias_attr)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            norm = LayerNorm(d_model, device=device, dtype=dtype) \
                if normalize_before else None
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*layer_args, **factory),
                num_encoder_layers, norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            norm = LayerNorm(d_model, device=device, dtype=dtype) \
                if normalize_before else None
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*layer_args, **factory),
                num_decoder_layers, norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The f32 ``[length, length]`` additive causal mask: 0 on and
        below the diagonal, -inf above."""
        return torch.triu(torch.full((length, length), float("-inf"),
                                     device=device), diagonal=1)
