"""RMSProp, Adagrad and Adadelta (counterpart of
``paddle_tpu/optimizer/rmsprop.py``): the reference's f32 arithmetic in
its order, the lr read from the lr tensor on the device."""
from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Adadelta", "Adagrad", "RMSProp"]


class RMSProp(Optimizer):
    """``ms = rho * ms + (1 - rho) * g^2``; with ``centered`` also
    ``mg = rho * mg + (1 - rho) * g`` and the denominator
    ``sqrt(ms - mg^2 + eps)``, else ``sqrt(ms + eps)``;
    ``mom = momentum * mom + lr * g / denom``; ``p -= mom``."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        g = g.float()
        ms = self._acc("mean_square", p)
        mom = self._acc("momentum", p)
        ms.copy_(self._rho * ms + (1 - self._rho) * g * g)
        if self._centered:
            mg = self._acc("mean_grad", p)
            mg.copy_(self._rho * mg + (1 - self._rho) * g)
            denom = torch.sqrt(ms - mg * mg + self._epsilon)
        else:
            denom = torch.sqrt(ms + self._epsilon)
        mom.copy_(self._momentum * mom + lr * g / denom)
        p.copy_(p.float() - mom)


class Adagrad(Optimizer):
    """``acc += g^2`` (from ``initial_accumulator_value``);
    ``p -= lr * g / (sqrt(acc) + eps)``."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        g = g.float()
        acc = self._acc("moment", p, init=self._init_acc)
        acc.add_(g * g)
        p.copy_(p.float() - lr * g / (torch.sqrt(acc) + self._epsilon))


class Adadelta(Optimizer):
    """``asg = rho * asg + (1 - rho) * g^2``;
    ``u = -sqrt((asu + eps) / (asg + eps)) * g``;
    ``asu = rho * asu + (1 - rho) * u^2``; ``p += lr * u``."""

    def __init__(self, learning_rate=0.001, epsilon=1e-06, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        g = g.float()
        asg = self._acc("avg_squared_grad", p)
        asu = self._acc("avg_squared_update", p)
        asg.copy_(self._rho * asg + (1 - self._rho) * g * g)
        update = -torch.sqrt((asu + self._epsilon) /
                             (asg + self._epsilon)) * g
        asu.copy_(self._rho * asu + (1 - self._rho) * update * update)
        p.copy_(p.float() + lr * update)
