"""Vision Transformer (counterpart of ``paddle_tpu/models/vit.py``).

The reference's configuration, module names and layouts: the patch
embedding is one Conv2D (kernel and stride the patch size, NCHW input),
the blocks are pre-LN with tanh GELU, ``cls_token`` ``[1, 1, hidden]``
and ``pos_embed`` ``[1, patches + 1, hidden]`` are parameters of the
model, and the head reads the class token. At ViT-B/16's widths
attention runs the flash kernels at head_dim 64 over 197 tokens (14^2
patches and the class token).
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.core.device import model_factory
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import (Conv2D, Dropout, LayerList, LayerNorm,
                                       Linear)

__all__ = ["PatchEmbed", "ViT", "ViTBlock", "ViTConfig", "VisionTransformer",
           "vit_b_16", "vit_l_16", "vit_tiny"]


class ViTConfig:
    def __init__(self, image_size=224, patch_size=16, in_channels=3,
                 hidden_size=768, num_layers=12, num_heads=12,
                 ffn_hidden_size=None, num_classes=1000, dropout=0.0,
                 attention_dropout=0.0, drop_path=0.0,
                 layer_norm_epsilon=1e-6, representation_size=None):
        self.image_size = image_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.num_classes = num_classes
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.drop_path = drop_path
        self.layer_norm_epsilon = layer_norm_epsilon
        self.representation_size = representation_size
        self.num_patches = (image_size // patch_size) ** 2


def vit_b_16(**kw):
    return ViTConfig(**kw)


def vit_l_16(**kw):
    cfg = dict(hidden_size=1024, num_layers=24, num_heads=16)
    cfg.update(kw)
    return ViTConfig(**cfg)


def vit_tiny(**kw):
    cfg = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
               num_heads=4, num_classes=10)
    cfg.update(kw)
    return ViTConfig(**cfg)


def _ln(config, factory):
    return LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon,
                     device=factory.get("device"), dtype=factory.get("dtype"))


class PatchEmbed(nn.Module):
    def __init__(self, config, **factory):
        super().__init__()
        self.proj = Conv2D(config.in_channels, config.hidden_size,
                           kernel_size=config.patch_size,
                           stride=config.patch_size, **factory)

    def forward(self, x):
        x = self.proj(x)                               # [b, hid, gh, gw]
        return x.flatten(2).transpose(1, 2)            # [b, n, hid]


class ViTBlock(nn.Module):
    """Pre-LN encoder block (GPT's residual form, bidirectional)."""

    def __init__(self, config, **factory):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        h, f = config.hidden_size, config.ffn_hidden_size
        self.ln1 = _ln(config, factory)
        self.qkv = Linear(h, 3 * h, **factory)
        self.proj = Linear(h, h, **factory)
        self.ln2 = _ln(config, factory)
        self.fc1 = Linear(h, f, **factory)
        self.fc2 = Linear(f, h, **factory)
        self.dropout = Dropout(config.dropout)
        self.attn_dropout_p = config.attention_dropout

    def forward(self, x):
        b, n = x.shape[0], x.shape[1]
        qkv = self.qkv(self.ln1(x)).reshape(b, n, self.num_heads,
                                            3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        attn = F.scaled_dot_product_attention(
            q, k, v, dropout_p=self.attn_dropout_p if self.training else 0.0,
            training=self.training)
        attn = attn.reshape(b, n, self.num_heads * self.head_dim)
        x = x + self.dropout(self.proj(attn))
        return x + self.dropout(self.fc2(F.gelu(self.fc1(self.ln2(x)),
                                                approximate=True)))


class VisionTransformer(nn.Module):
    """Built on ``device`` (default CUDA; RuntimeError without it unless
    ``device="cpu"``); ``cls_token`` and ``pos_embed`` drawn from the
    reference's truncated normal (std 0.02, cut at two std)."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        factory = model_factory(device, dtype, generator)
        self.config = config
        self.patch_embed = PatchEmbed(config, **factory)
        self.cls_token = self._trunc_normal((1, 1, config.hidden_size),
                                            factory)
        self.pos_embed = self._trunc_normal(
            (1, config.num_patches + 1, config.hidden_size), factory)
        self.pos_drop = Dropout(config.dropout)
        self.blocks = LayerList([ViTBlock(config, **factory)
                                 for _ in range(config.num_layers)])
        self.norm = _ln(config, factory)
        self.head = Linear(config.hidden_size, config.num_classes,
                           **factory) if config.num_classes > 0 else None

    @staticmethod
    def _trunc_normal(shape, factory):
        t = torch.empty(shape, device=factory.get("device"),
                        dtype=factory.get("dtype"))
        with torch.no_grad():
            torch.nn.init.trunc_normal_(t, 0.0, 0.02, -0.04, 0.04,
                                        generator=factory["generator"])
        return nn.Parameter(t)

    def forward(self, x):
        x = self.patch_embed(x)
        cls = self.cls_token.expand(x.shape[0], 1, self.config.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = self.pos_drop(x)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x if self.head is None else self.head(x[:, 0])


ViT = VisionTransformer
