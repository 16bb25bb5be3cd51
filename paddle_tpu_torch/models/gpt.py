"""GPT-3-style causal LM (counterpart of ``paddle_tpu/models/gpt.py``).

Same configuration, module names and weight layouts as the reference,
so a state dict crosses between the two packages by name
(:mod:`paddle_tpu_torch.framework.io`). The LM head is tied to the word
embedding, or, with ``tie_word_embeddings=False``, its own
``lm_head_weight [hidden, vocab]``. Weights are drawn from
``Normal(0, initializer_range)`` with one explicit ``torch.Generator``
in construction order. Dropout draws its masks from the global key in
the reference's order: the embeddings', then per layer the attention
probabilities' and the two residual dropouts'. With ``use_recompute``,
or under ``to_static(remat=...)``, each decoder block in training is a
recompute region (:mod:`paddle_tpu_torch.distributed.recompute`).
With ``moe_num_experts > 0`` every ``moe_every``-th block's FFN is a
GShard MoE, and :meth:`GPTModel.moe_aux_loss` gives its balance losses.
"""
from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.amp.policy import remat_active
from paddle_tpu_torch.core.device import model_factory
from paddle_tpu_torch.distributed.fleet.meta_parallel import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
from paddle_tpu_torch.distributed.moe import MoELayer, StackedExpertFFN
from paddle_tpu_torch.distributed.recompute import recompute
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import Dropout, Embedding, LayerNorm
from paddle_tpu_torch.nn.layer.common import normal_parameter
from paddle_tpu_torch.observability.profile import layer_scope, scope_name

__all__ = ["GPTAttention", "GPTConfig", "GPTDecoderLayer", "GPTEmbeddings",
           "GPTForCausalLM", "GPTMLP", "GPTModel", "GPTPretrainingCriterion",
           "gpt3_1p3b", "gpt3_tiny"]


class GPTConfig:
    """Model hyperparameters (GPT-3 naming, as in the reference)."""

    def __init__(self, vocab_size=50304, hidden_size=2048, num_layers=24,
                 num_heads=16, ffn_hidden_size=None, max_seq_len=2048,
                 dropout=0.1, attention_dropout=0.1, initializer_range=0.02,
                 layer_norm_epsilon=1e-5, use_recompute=False,
                 tie_word_embeddings=True, fused_ln=False,
                 moe_num_experts=0, moe_top_k=2, moe_every=2,
                 moe_gate="gshard", moe_ep_axis="ep",
                 moe_capacity_factor=(2.0, 2.0)):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.max_seq_len = max_seq_len
        self.dropout = dropout
        self.attention_dropout = attention_dropout
        self.initializer_range = initializer_range
        self.layer_norm_epsilon = layer_norm_epsilon
        self.use_recompute = use_recompute
        self.tie_word_embeddings = tie_word_embeddings
        # fused_ln=True routes ln2 and the attention residual through the
        # fused residual+LN kernel; every other LN takes the LN kernel
        # whenever its input is on CUDA (fused=None)
        self.fused_ln = fused_ln
        self.moe_num_experts = moe_num_experts
        self.moe_top_k = moe_top_k
        self.moe_every = moe_every
        self.moe_gate = moe_gate
        self.moe_ep_axis = moe_ep_axis
        self.moe_capacity_factor = moe_capacity_factor


def gpt3_1p3b(**kw):
    """GPT-3 1.3B."""
    cfg = dict(vocab_size=50304, hidden_size=2048, num_layers=24,
               num_heads=16, max_seq_len=2048)
    cfg.update(kw)
    return GPTConfig(**cfg)


def gpt3_tiny(**kw):
    """Tiny config for tests."""
    cfg = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               max_seq_len=128, dropout=0.0, attention_dropout=0.0)
    cfg.update(kw)
    return GPTConfig(**cfg)


def _ln(config, factory):
    return LayerNorm(config.hidden_size, epsilon=config.layer_norm_epsilon,
                     fused=config.fused_ln or None, **factory)


class GPTEmbeddings(nn.Module):
    """Word (vocab-parallel) + learned position embeddings."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        init = dict(std=config.initializer_range, device=device,
                    dtype=dtype, generator=generator)
        self.word_embeddings = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, **init)
        self.position_embeddings = Embedding(
            config.max_seq_len, config.hidden_size, **init)
        self.dropout = Dropout(config.dropout)

    def forward(self, input_ids, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1],
                                        device=input_ids.device)
        h = self.word_embeddings(input_ids) + self.position_embeddings(
            position_ids)
        return self.dropout(h)


class GPTAttention(nn.Module):
    """Causal self-attention: fused qkv projection whose columns are
    laid out ``[head, 3 * head_dim]``, then the output projection."""

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        init = dict(std=config.initializer_range, device=device,
                    dtype=dtype, generator=generator)
        self.qkv_proj = ColumnParallelLinear(
            config.hidden_size, 3 * config.hidden_size, gather_output=False,
            **init)
        self.out_proj = RowParallelLinear(
            config.hidden_size, config.hidden_size, input_is_parallel=True,
            **init)
        self.attn_dropout_p = config.attention_dropout

    def forward(self, hidden, kv_ctx=None):
        b, s = hidden.shape[0], hidden.shape[1]
        qkv = self.qkv_proj(hidden)
        qkv = qkv.reshape(b, s, self.num_heads, 3 * self.head_dim)
        q, k, v = qkv.split(self.head_dim, dim=-1)
        if kv_ctx is not None:
            # serving hook: the context owns KV residency (paged pools)
            # and attention over the cached history
            out = kv_ctx.attend(q, k, v)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, is_causal=True,
                dropout_p=self.attn_dropout_p if self.training else 0.0,
                training=self.training)
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return self.out_proj(out)


class GPTMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        init = dict(std=config.initializer_range, device=device,
                    dtype=dtype, generator=generator)
        self.fc1 = ColumnParallelLinear(
            config.hidden_size, config.ffn_hidden_size, gather_output=False,
            **init)
        self.fc2 = RowParallelLinear(
            config.ffn_hidden_size, config.hidden_size,
            input_is_parallel=True, **init)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=True))


class GPTDecoderLayer(nn.Module):
    """Pre-LN transformer decoder block. With ``moe_num_experts`` set and
    this block selected by ``moe_every`` (``(layer_idx + 1) % moe_every
    == 0``), the dense FFN is a GShard MoE over stacked experts
    (:mod:`paddle_tpu_torch.distributed.moe`), as in the reference."""

    def __init__(self, config, layer_idx=0, device=None, dtype=None,
                 generator=None):
        super().__init__()
        factory = dict(device=device, dtype=dtype)
        self._fused_ln = config.fused_ln
        self.ln1 = _ln(config, factory)
        self.attn = GPTAttention(config, generator=generator, **factory)
        self.ln2 = _ln(config, factory)
        if (config.moe_num_experts > 0
                and (layer_idx + 1) % config.moe_every == 0):
            self.mlp = MoELayer(
                config.hidden_size,
                StackedExpertFFN(config.moe_num_experts, config.hidden_size,
                                 config.ffn_hidden_size,
                                 ep_axis=config.moe_ep_axis,
                                 generator=generator, **factory),
                gate={"type": config.moe_gate, "top_k": config.moe_top_k},
                ep_axis=config.moe_ep_axis,
                capacity_factor=config.moe_capacity_factor,
                generator=generator, **factory)
        else:
            self.mlp = GPTMLP(config, generator=generator, **factory)
        self.dropout = Dropout(config.dropout)

    def forward(self, x, kv_ctx=None):
        if self._fused_ln:
            # the attention residual add and ln2 in one kernel, which
            # returns both the new stream and ln2's output, under ln2's
            # scope name (the profiler's rows keep their pre-fusion names)
            a = self.dropout(self.attn(self.ln1(x), kv_ctx=kv_ctx))
            with layer_scope(scope_name(self.ln2, self)):
                x, h2 = F.fused_ln_residual(a, x, self.ln2.weight,
                                            self.ln2.bias, self.ln2._epsilon,
                                            fused=True)
            return x + self.dropout(self.mlp(h2))
        x = x + self.dropout(self.attn(self.ln1(x), kv_ctx=kv_ctx))
        return x + self.dropout(self.mlp(self.ln2(x)))


class GPTModel(nn.Module):
    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        self.config = config
        factory = dict(device=device, dtype=dtype)
        self.embeddings = GPTEmbeddings(config, generator=generator,
                                        **factory)
        self.layers = nn.ModuleList(
            [GPTDecoderLayer(config, layer_idx=i, generator=generator,
                             **factory)
             for i in range(config.num_layers)])
        self.final_ln = _ln(config, factory)

    def forward(self, input_ids, position_ids=None, kv_ctx=None):
        h = self.embeddings(input_ids, position_ids)
        # the model's recompute units are its decoder blocks:
        # config.use_recompute turns them on, an ambient
        # to_static(remat=...) policy for that step alone
        use_rc = (self.config.use_recompute or bool(remat_active())) \
            and self.training
        if kv_ctx is not None and use_rc:
            raise RuntimeError(
                "kv_ctx serving forward requires eval mode (recompute "
                "is active): call model.eval() before serving")
        for layer in self.layers:
            h = recompute(layer, h) if use_rc else layer(h, kv_ctx=kv_ctx)
        return self.final_ln(h)

    def moe_aux_loss(self):
        """The sum of the MoE gates' balance losses from the last forward
        (cleared on read); a zero scalar for a model without MoE
        blocks."""
        total = None
        for layer in self.layers:
            gate = getattr(layer.mlp, "gate", None)
            if gate is not None and hasattr(gate, "get_loss"):
                loss = gate.get_loss()
                if loss is not None:
                    total = loss if total is None else total + loss
        if total is None:
            return torch.zeros((), device=self.final_ln.weight.device)
        return total


class GPTForCausalLM(nn.Module):
    """GPT with the LM head tied to the word embedding (``logits = h @
    W_emb^T``), or untied (``logits = h @ lm_head_weight``, a ``[hidden,
    vocab]`` weight drawn after the model's).

    Trains with f32 master weights under ``to_static(amp_policy="bf16")``
    (bf16 activations, f32 gradients).

    Built on ``device`` (default CUDA; RuntimeError without it unless
    ``device="cpu"``) in ``dtype`` (default float32), its weights drawn
    with ``generator`` (default: a generator on ``device`` seeded 0).
    """

    def __init__(self, config, device=None, dtype=None, generator=None):
        super().__init__()
        factory = model_factory(device, dtype, generator)
        self.config = config
        self.gpt = GPTModel(config, **factory)
        if not config.tie_word_embeddings:
            self.lm_head_weight = normal_parameter(
                (config.hidden_size, config.vocab_size),
                config.initializer_range, **factory)

    def _head_weight(self):
        """The head as ``[hidden, vocab]``."""
        if self.config.tie_word_embeddings:
            return self.gpt.embeddings.word_embeddings.weight.t()
        return self.lm_head_weight

    def forward(self, input_ids, position_ids=None, kv_ctx=None):
        h = self.gpt(input_ids, position_ids, kv_ctx=kv_ctx)
        if self.config.tie_word_embeddings:
            w = self.gpt.embeddings.word_embeddings.weight
            return F.matmul(h, w, transpose_y=True)
        return F.matmul(h, self.lm_head_weight)

    def loss_with_fused_head(self, input_ids, labels, position_ids=None,
                             chunk_size=8192):
        """The mean cross entropy of the head's logits against ``labels``
        with the head and the loss fused and chunked
        (:func:`~paddle_tpu_torch.nn.functional.fused_linear_cross_entropy`):
        the ``[tokens, vocab]`` logits never exist whole."""
        h = self.gpt(input_ids, position_ids)
        return F.fused_linear_cross_entropy(h, self._head_weight(), labels,
                                            chunk_size=chunk_size)


class GPTPretrainingCriterion(nn.Module):
    """The masked LM loss: per-token cross entropy, averaged over the
    tokens ``loss_mask`` keeps (all of them without one)."""

    def forward(self, logits, labels, loss_mask=None):
        loss = F.cross_entropy(logits, labels, reduction="none")
        if loss_mask is not None:
            mask = loss_mask.reshape(loss.shape).to(loss.dtype)
            return (loss * mask).sum() / mask.sum().clamp(min=1.0)
        return loss.mean()
