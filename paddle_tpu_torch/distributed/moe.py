"""Mixture-of-Experts (counterpart of ``paddle_tpu/distributed/moe.py``).

The reference's GShard/Switch formulation, on one device: every routing
decision becomes a static-shape one-hot ``dispatch`` mask ``[tokens,
experts, capacity]`` and a differentiable ``combine`` tensor of gate
weights; dispatch and combine are products (:func:`~paddle_tpu_torch.
tensor.einsum`), tokens over an expert's capacity are dropped (the
residual carries them), and the experts' weights are stacked on a
leading expert axis so their FFN is one batched product.

The reference's numerics are part of the result: the routing runs in
the probabilities' dtype (a bf16 model's ``cumsum`` rounds ranks past
256 to bf16, as ``jnp.cumsum`` does), top-k breaks ties toward the lower
index (:func:`~paddle_tpu_torch.tensor.topk`), and the random draws of
GShard's second-expert routing and Switch's jitter come from the global
key (:func:`~paddle_tpu_torch.tensor.rand`), the reference's values for
the same seed. Nothing reads a tensor on the host, so a CUDA graph
captures a MoE forward and backward whole.

The reference constrains the dispatched ``[E, C, d]`` activations to the
``ep`` mesh axis; on one device that constraint does nothing
(``paddle_tpu/distributed/fleet/meta_parallel.py:35-36``), so the port
keeps the ``ep_axis`` and ``moe_group`` arguments and does nothing with
them.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer.common import Linear, normal_parameter
from paddle_tpu_torch.tensor import einsum, rand, topk

__all__ = [
    "BaseGate", "NaiveGate", "GShardGate", "SwitchGate",
    "MoELayer", "StackedExpertFFN", "dispatch_combine",
    "gshard_dispatch_combine",
]


def _capacity(num_tokens, num_experts, top_k, capacity_factor):
    """GShard per-expert capacity: each expert takes its fair share of
    the top_k routed tokens, scaled by the capacity factor."""
    return max(1, math.ceil(capacity_factor * num_tokens * top_k
                            / num_experts))


def dispatch_combine(probs, top_k, capacity, keep_last=None):
    """Static-shape GShard routing tensors from router probabilities
    ``probs [n, E]``; ``keep_last`` (optional ``[n]`` 0/1) gates each
    token's last (lowest-priority) choice. Returns ``(combine, dispatch)``,
    both ``[n, E, C]``: dispatch the 0/1 routing mask (top_k choices,
    position in the expert below ``capacity``, every top-1 pick claiming
    capacity before any top-2 pick), combine the gate weights at the
    same positions, differentiable in ``probs`` through the top-k
    values."""
    return gshard_dispatch_combine(probs, top_k, capacity, keep_last)


def gshard_dispatch_combine(p, top_k, capacity, kl=None):
    """The GShard routing core on ``p [n, E]``, in ``p``'s dtype."""
    n, e = p.shape
    vals, idx = topk(p, top_k)                      # [n, K]
    onehot = F.one_hot(idx, e, dtype=p.dtype)       # [n, K, E]
    if kl is not None:
        last = onehot[:, top_k - 1:] * kl.to(p.dtype)[:, None, None]
        onehot = torch.cat([onehot[:, :top_k - 1], last], dim=1)
    # rank of each token within its chosen expert; the top-1 column
    # fills before the top-2 one (GShard section 3.2)
    offset = torch.zeros(e, dtype=p.dtype, device=p.device)
    keep_k, pos_k = [], []
    for k in range(top_k):
        mk = onehot[:, k, :]                        # [n, E]
        pos = torch.cumsum(mk, dim=0) - mk + offset
        offset = offset + mk.sum(dim=0)
        keep_k.append(mk * (pos < capacity))
        pos_k.append(pos)
    keep = torch.stack(keep_k, 1)                   # [n, K, E]
    pos = torch.stack(pos_k, 1)
    slot = F.one_hot(torch.clamp(pos, 0, capacity - 1).to(torch.int32),
                     capacity, dtype=p.dtype)       # [n, K, E, C]
    disp_k = keep[..., None] * slot
    dispatch = disp_k.sum(dim=1)
    combine = (vals[:, :, None, None] * disp_k).sum(dim=1)
    return combine, dispatch


class BaseGate(nn.Module):
    """Gates stash their auxiliary (load-balancing) loss; the training
    loop reads it with :meth:`get_loss` and adds it to the task loss."""

    def __init__(self, num_expert, world_size=1):
        super().__init__()
        self.world_size = world_size
        self.num_expert = num_expert
        self.tot_expert = num_expert * world_size
        self.loss = None

    def set_loss(self, loss):
        self.loss = loss

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class NaiveGate(BaseGate):
    """Linear router and a softmax over the top-k logits."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 device=None, dtype=None, generator=None):
        super().__init__(num_expert, world_size)
        self.top_k = topk
        self.gate = Linear(d_model, self.tot_expert, std=0.02, device=device,
                           dtype=dtype, generator=generator)

    def scores(self, x):
        """Router probabilities ``[n, E]`` (differentiable)."""
        return F.softmax(self.gate(x), axis=-1)

    def forward(self, x, return_all_scores=False):
        logits = self.gate(x)
        vals, idx = topk(logits, self.top_k)
        vals = F.softmax(vals, axis=-1)
        if return_all_scores:
            return vals, idx, logits
        return vals, idx


class GShardGate(NaiveGate):
    """Top-2 gate with GShard's balance loss ``mean(c_e * m_e) * E^2``
    and stochastic second-expert routing."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None,
                 device=None, dtype=None, generator=None):
        if topk != 2:
            raise ValueError("topk should be 2 in gshard")
        super().__init__(d_model, num_expert, world_size, topk=topk,
                         device=device, dtype=dtype, generator=generator)
        self.capacity_factor = capacity
        self.random_routing = random_routing

    def aux_loss(self, probs, top1_idx):
        c_e = F.one_hot(top1_idx, self.tot_expert).mean(dim=0)
        m_e = probs.mean(dim=0)
        loss = (c_e * m_e).mean() * (self.tot_expert ** 2)
        self.set_loss(loss)
        return loss


class SwitchGate(NaiveGate):
    """Top-1 gate with multiplicative jitter of its logits in training
    and Switch's balance loss ``sum(f_e * p_e) * E``."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None,
                 device=None, dtype=None, generator=None):
        if topk != 1:
            raise ValueError("topk should be 1 in switch")
        super().__init__(d_model, num_expert, world_size, topk=1,
                         device=device, dtype=dtype, generator=generator)
        self.switch_eps = switch_eps
        self.capacity_factor = capacity

    def scores(self, x):
        logits = self.gate(x)
        if self.training and self.switch_eps:
            noise = rand(logits.shape, device=logits.device)
            logits = logits * (noise * (2 * self.switch_eps)
                               + (1.0 - self.switch_eps))
        return F.softmax(logits, axis=-1)

    def aux_loss(self, probs, top1_idx):
        f_e = F.one_hot(top1_idx, self.tot_expert).mean(dim=0)
        p_e = probs.mean(dim=0)
        loss = (f_e * p_e).sum() * self.tot_expert
        self.set_loss(loss)
        return loss


class StackedExpertFFN(nn.Module):
    """Every expert's FFN weights stacked on a leading expert axis:
    ``w1 [E, d, h]``, ``b1 [E, h]``, ``w2 [E, h, d]``, ``b2 [E, d]`` (the
    reference's names and layouts), so the experts run as one batched
    product over the dispatched ``[E, C, d]`` tokens. ``w1`` and ``w2``
    are drawn from ``Normal(0, 0.02)`` with ``generator``, in that
    order; the biases start at zero."""

    def __init__(self, num_experts, d_model, d_hidden, ep_axis="ep",
                 activation="gelu", device=None, dtype=None, generator=None):
        super().__init__()
        self.num_experts = num_experts
        self.ep_axis = ep_axis
        self.activation = activation
        self.w1 = normal_parameter((num_experts, d_model, d_hidden), 0.02,
                                   device, dtype, generator)
        self.b1 = nn.Parameter(torch.zeros(num_experts, d_hidden,
                                           device=device, dtype=dtype))
        self.w2 = normal_parameter((num_experts, d_hidden, d_model), 0.02,
                                   device, dtype, generator)
        self.b2 = nn.Parameter(torch.zeros(num_experts, d_model,
                                           device=device, dtype=dtype))

    def forward(self, x):
        h = einsum("ecd,edh->ech", x, self.w1) + self.b1.unsqueeze(1)
        h = F.gelu(h, approximate=True) if self.activation == "gelu" \
            else torch.relu(h)
        return einsum("ech,ehd->ecd", h, self.w2) + self.b2.unsqueeze(1)


class MoELayer(nn.Module):
    """Mixture-of-experts layer. ``experts`` is a
    :class:`StackedExpertFFN` or a list of modules (each ``[C, d] -> [C,
    d]``); ``gate`` a dict (``{"type": "gshard" | "switch" | "naive",
    "top_k": k}``, built on ``device`` / ``dtype`` with ``generator``) or
    a :class:`BaseGate`. The capacity factor is ``(training, eval)``.
    Tokens routed past an expert's capacity contribute zero."""

    def __init__(self, d_model, experts, gate=None, moe_group=None,
                 mp_group=None, ep_axis="ep", capacity_factor=(1.2, 2.4),
                 recompute_interval=0, recompute_ctx=None, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.d_model = d_model
        self.ep_axis = ep_axis if moe_group is None else moe_group
        if isinstance(experts, StackedExpertFFN):
            self.experts = experts
            self.num_expert = experts.num_experts
        else:
            self.experts = nn.ModuleList(list(experts))
            self.num_expert = len(self.experts)

        if gate is None or isinstance(gate, dict):
            gate = dict(gate or {})
            top_k = gate.get("top_k", 2)
            kind = gate.get("type", "gshard")
            factory = dict(device=device, dtype=dtype, generator=generator)
            if kind in (None, "naive"):
                gate = NaiveGate(d_model, self.num_expert, topk=top_k,
                                 **factory)
            elif kind == "gshard":
                gate = GShardGate(d_model, self.num_expert, topk=top_k,
                                  capacity=capacity_factor, **factory)
            elif kind == "switch":
                gate = SwitchGate(d_model, self.num_expert,
                                  capacity=capacity_factor, **factory)
            else:
                raise ValueError(f"unknown gate type {kind!r}")
        elif not isinstance(gate, BaseGate):
            raise TypeError("gate must be a dict config or a BaseGate")
        self.gate = gate
        self.top_k = gate.top_k
        self.capacity_factor = getattr(gate, "capacity_factor",
                                       capacity_factor)

    def _run_experts(self, xin):
        if isinstance(self.experts, StackedExpertFFN):
            return self.experts(xin)
        return torch.stack([self.experts[e](xin[e])
                            for e in range(self.num_expert)], dim=0)

    def forward(self, x):
        orig_shape = x.shape
        n = math.prod(orig_shape[:-1])
        xf = x.reshape(n, self.d_model)

        probs = self.gate.scores(xf)                        # [n, E]
        _, top_idx = topk(probs, self.top_k)
        if hasattr(self.gate, "aux_loss"):
            self.gate.aux_loss(probs, top_idx[:, 0])

        cap_rate = self.capacity_factor[0 if self.training else 1]
        capacity = _capacity(n, self.num_expert, self.top_k, cap_rate)
        # GShard's stochastic second-expert routing: keep the second
        # choice with probability min(1, 2 * its gate value)
        keep_last = None
        if (self.training and self.top_k == 2
                and getattr(self.gate, "random_routing", False)):
            vals2, _ = topk(probs, 2)
            r = rand([n], device=probs.device)
            keep_last = (vals2[:, 1] * 2.0 > r).float()
        combine, dispatch = dispatch_combine(probs, self.top_k, capacity,
                                             keep_last=keep_last)

        xin = einsum("nec,nd->ecd", dispatch, xf)
        out = self._run_experts(xin)                        # [E, C, d]
        y = einsum("nec,ecd->nd", combine, out)
        return y.reshape(orig_shape)
