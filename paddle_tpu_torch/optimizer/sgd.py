"""SGD, Momentum and LarsMomentum (counterpart of
``paddle_tpu/optimizer/sgd.py``).

Each update is the reference's f32 arithmetic in its order, on the lr
tensor (``Optimizer._lr``): nothing a step reads is a Python number that
changes between steps. LARS's trust ratio, its "``||p||`` or the
denominator is 0 -> 1" case included, is ``torch.where`` on the device,
so a captured step reads no norm back to the host.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["LarsMomentum", "LarsMomentumOptimizer", "Momentum", "SGD"]


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, guard=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         guard=guard)

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        p.copy_(p.float() - lr * g.float())


class LarsMomentum(Optimizer):
    """Layer-wise adaptive rate scaling with momentum:
    ``local_lr = lr * lars_coeff * ||p|| / (||g|| + wd * ||p|| + eps)``,
    ``v = mu * v + local_lr * (g + wd * p)``, ``p -= v``; ``wd`` is 0 for
    a parameter whose name holds a token of
    ``exclude_from_weight_decay``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 exclude_from_weight_decay=None, epsilon=0.0,
                 rescale_grad=1.0):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._exclude = list(exclude_from_weight_decay or [])
        self._epsilon = epsilon
        self._rescale_grad = rescale_grad

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        pv = p.float()
        g = g.float() * self._rescale_grad
        wd = self._lars_weight_decay
        name = self._names[id(p)] or ""
        if any(tok in name for tok in self._exclude):
            wd = 0.0
        p_norm = torch.sqrt(torch.sum(pv * pv))
        g_norm = torch.sqrt(torch.sum(g * g))
        denom = g_norm + wd * p_norm + self._epsilon
        trust = torch.where((p_norm > 0.0) & (denom > 0.0),
                            self._lars_coeff * p_norm /
                            torch.where(denom > 0.0, denom, 1.0), 1.0)
        vel = self._acc("velocity", p)
        vel.copy_(self._momentum * vel + (lr * trust) * (g + wd * pv))
        p.copy_(pv - vel)


LarsMomentumOptimizer = LarsMomentum     # the reference's other spelling


class Momentum(Optimizer):
    """``v = mu * v + g``; ``p -= lr * v``, or with ``use_nesterov``
    ``p -= lr * (g + mu * v)``. ``rescale_grad`` scales the gradient
    first."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 rescale_grad=1.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rescale_grad = rescale_grad

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        g = g.float() * self._rescale_grad
        vel = self._acc("velocity", p)
        vel.copy_(self._momentum * vel + g)
        update = g + self._momentum * vel if self._use_nesterov else vel
        p.copy_(p.float() - lr * update)
