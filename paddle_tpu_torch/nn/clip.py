"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

An optimizer's ``grad_clip`` is called with its ``(parameter,
gradient)`` pairs before the update and returns them, each gradient
clipped in place: :class:`ClipGradByValue` to ``[min, max]``,
:class:`ClipGradByNorm` each to an L2 norm of at most ``clip_norm``,
:class:`ClipGradByGlobalNorm` all together to a global L2 norm of at
most ``clip_norm`` (parameters with ``need_clip = False`` are left out
of the norm and unscaled). The norms and scales are device tensors: no
clip reads a value back to the host, so a captured step clips on the
card. :func:`clip_grad_norm_` and :func:`clip_grad_value_` clip the
``.grad`` of parameters directly.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        with torch.no_grad():
            return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip(self, params_grads):
        for _, g in params_grads:
            if g is not None:
                g.clamp_(self.min, self.max)
        return params_grads


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        for _, g in params_grads:
            if g is None:
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            g.mul_(torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                               max=1.0))
        return params_grads


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def _clip(self, params_grads):
        grads = [g for p, g in params_grads
                 if g is not None and getattr(p, "need_clip", True)]
        if not grads:
            return params_grads
        sq = [torch.linalg.vector_norm(g, dtype=torch.float32).square()
              for g in grads]
        gn = torch.sqrt(torch.stack([s.to(sq[0].device) for s in sq]).sum())
        scale = self.clip_norm / torch.clamp(gn, min=self.clip_norm)
        for g in grads:
            if g.dtype == torch.float32:
                g.mul_(scale.to(g.device))
            else:
                g.copy_(g.float() * scale.to(g.device))
        return params_grads


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the gradients of ``parameters`` (a tensor or an iterable)
    by ``min(max_norm / (total + 1e-6), 1)``, ``total`` their joint
    ``norm_type`` norm, which is returned (a device tensor; None when no
    parameter has a gradient)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return None
    with torch.no_grad():
        if norm_type == float("inf"):
            total = torch.stack([g.abs().max() for g in grads]).max()
        else:
            total = torch.stack([torch.sum(g.abs() ** norm_type)
                                 for g in grads]).sum() ** (1.0 / norm_type)
        scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)
    return total


def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients of ``parameters`` to ``[-clip_value,
    clip_value]`` in place."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    with torch.no_grad():
        for p in parameters:
            if p.grad is not None:
                p.grad.clamp_(-clip_value, clip_value)
