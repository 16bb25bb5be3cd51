"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/adam.py``).

The update is the reference's unfused loop, step for step: moments in
f32, the bias correction divides (``mhat = m / (1 - beta1^t)``), eps is
added to ``sqrt(vhat)``, and AdamW's decoupled decay
``p *= 1 - lr * coeff`` comes before the Adam update, gated by
``apply_decay_param_fun``. ``torch.optim.AdamW`` puts eps elsewhere, so
it is not a substitute. The fused single-pass kernel (``fused=True``,
``paddle_tpu/ops/pallas/optim.py``) is not ported yet.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, fused=False):
        if fused:
            raise NotImplementedError(
                "the fused AdamW kernel (fused=True) is not ported yet")
        super().__init__(learning_rate, parameters)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update_param(self, p, g):
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1p = self._acc("beta1_pow", p, init=1.0, shape=())
        b2p = self._acc("beta2_pow", p, init=1.0, shape=())
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)
        g = g.float()
        m.mul_(self._beta1).add_(g, alpha=1 - self._beta1)
        v.mul_(self._beta2).add_((1 - self._beta2) * g * g)
        upd = (m / (1 - b1p)).mul_(self._lr)                # lr * mhat
        upd.div_((v / (1 - b2p)).sqrt_().add_(self._epsilon))
        p.copy_(p.float() - upd)


class AdamW(Adam):
    """Adam with decoupled weight decay ``weight_decay`` (0.01 unless a
    float is given), applied to the parameters for whose name
    ``apply_decay_param_fun`` is true (all of them when it is None)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, fused=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         fused)
        self._coeff = weight_decay if isinstance(weight_decay, float) \
            else 0.01
        if apply_decay_param_fun is not None and \
                None in self._names.values():
            raise ValueError("apply_decay_param_fun needs named parameters "
                             "(pass module.named_parameters())")
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_param(self, p, g):
        fun = self._apply_decay_param_fun
        if fun is None or fun(self._names[id(p)]):
            p.copy_(p.float() * (1.0 - self._lr * self._coeff))
        super()._update_param(p, g)
