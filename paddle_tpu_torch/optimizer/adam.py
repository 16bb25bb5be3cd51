"""Adam, AdamW, Adamax and Lamb (counterpart of
``paddle_tpu/optimizer/adam.py``).

The unfused update is the reference's loop, step for step: moments in
f32 math, the bias correction divides (``mhat = m / (1 - beta1^t)``),
eps is added to ``sqrt(vhat)``, and AdamW's decoupled decay
``p *= 1 - lr * coeff`` comes before the Adam update, gated by
``apply_decay_param_fun``. ``torch.optim.AdamW`` puts eps elsewhere, so
it is not a substitute.

``fused=True`` sends every rank-2 parameter through the single-pass
kernel (:func:`paddle_tpu_torch.ops.cuda.optim.fused_adam_update`,
kernel #9 of the reference, ``paddle_tpu/ops/pallas/optim.py``), which
folds the decoupled decay in; rank-1 parameters keep the loop, as in the
reference. ``moment_dtype="bfloat16"`` stores the moments in bf16 (the
math stays f32). Every update reads the lr from the optimizer's lr
tensor on the device, and AdamW's factor ``1 - lr * coeff`` is f32 math
on it, made once a step, as the reference computes it from its f32 lr.
A parameter's lr multiplier (its ``optimize_attr["learning_rate"]``,
times AdamW's ``lr_ratio(p)``) scales that lr on every path, the fused
kernel's ``sc`` and the decay factor included, as the reference passes
``lr_mult``.

Adamax and Lamb are the reference's loops, with their beta powers in
registered device tensors. Lamb's trust ratio ``||p|| / ||update||``
(1 where either norm is 0) is ``torch.where`` on the device.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.ops.cuda.optim import fused_adam_update
from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Adamax", "Lamb"]

_MOMENT_DTYPES = {None: torch.float32, "float32": torch.float32,
                  "bfloat16": torch.bfloat16}


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None, moment_dtype=None, fused=False,
                 guard=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         guard=guard)
        if moment_dtype not in _MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be float32 or bfloat16, "
                             f"got {moment_dtype!r}")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._moment_dtype = _MOMENT_DTYPES[moment_dtype]
        self._fused = bool(fused)

    def _fused_decay(self, p):
        """(decoupled coefficient, gate) the fused kernel applies: plain
        Adam has none."""
        return 0.0, True

    def _update_param(self, p, g, lr_mult=1.0):
        mdt = self._moment_dtype
        m = self._acc("moment1", p, dtype=mdt)
        v = self._acc("moment2", p, dtype=mdt)
        b1p = self._acc("beta1_pow", p, init=1.0, shape=())
        b2p = self._acc("beta2_pow", p, init=1.0, shape=())
        lr = self._lr(lr_mult)
        if self._will_fuse(p):
            self._fused_update(p, g, m, v, b1p, b2p, lr)
            return
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)
        g = g.float()
        mf = m if m.dtype == torch.float32 else m.float()
        vf = v if v.dtype == torch.float32 else v.float()
        mf.mul_(self._beta1).add_(g, alpha=1 - self._beta1)
        vf.mul_(self._beta2).add_((1 - self._beta2) * g * g)
        upd = (mf / (1 - b1p)).mul_(lr)                     # lr * mhat
        upd.div_((vf / (1 - b2p)).sqrt_().add_(self._epsilon))
        if mf is not m:
            m.copy_(mf)
            v.copy_(vf)
        p.copy_(p.float() - upd)

    def _fused_update(self, p, g, m, v, b1p, b2p, lr):
        """Kernel #9 on one rank-2 parameter. The bias-correction powers
        advance only on a committed step: under guard their update is
        gated on this parameter's whole-parameter verdict, while the
        kernel gates each row block. When only some blocks are bad, the
        good blocks commit with this step's corrections while the powers
        hold: a bounded one-step correction offset on those blocks,
        always finite, which the sentinel's rollback erases (the common
        anomaly, a NaN loss, makes every gradient NaN and gates every
        block: an exact zero update)."""
        coeff, decay_on = self._fused_decay(p)
        b1_new = b1p * self._beta1
        b2_new = b2p * self._beta2
        sc = torch.stack([lr, 1 - b1_new, 1 - b2_new,
                          torch.full((), float(decay_on), device=p.device)])
        parts = fused_adam_update(
            p, g, m, v, sc, beta1=self._beta1, beta2=self._beta2,
            eps=self._epsilon, weight_decay=coeff, guard=self._guard)
        if self._guard:
            total = parts.sum()
            good = torch.isfinite(total)
            self._guard_parts.append(total)
            self._guard_bad.append(
                torch.logical_not(torch.isfinite(parts)).float().sum())
            self._guard_regions += parts.numel()
            torch.where(good, b1_new, b1p, out=b1p)
            torch.where(good, b2_new, b2p, out=b2p)
        else:
            b1p.copy_(b1_new)
            b2p.copy_(b2_new)


class AdamW(Adam):
    """Adam with decoupled weight decay ``weight_decay`` (0.01 unless a
    float is given), applied to the parameters for whose name
    ``apply_decay_param_fun`` is true (all of them when it is None).
    ``lr_ratio`` (a function of the parameter) multiplies each
    parameter's lr, decay included."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 moment_dtype=None, fused=False, guard=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, moment_dtype, fused, guard)
        self._coeff = weight_decay if isinstance(weight_decay, float) \
            else 0.01
        self._lr_ratio = lr_ratio
        if apply_decay_param_fun is not None and \
                None in self._names.values():
            raise ValueError("apply_decay_param_fun needs named parameters "
                             "(pass module.named_parameters())")
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decays(self, p):
        fun = self._apply_decay_param_fun
        return fun is None or bool(fun(self._names[id(p)]))

    def _fused_decay(self, p):
        return self._coeff, self._decays(p)

    def _begin_step(self):
        self._decay_factor = 1.0 - self._lr_tensor * self._coeff

    def _update_param(self, p, g, lr_mult=1.0):
        if self._lr_ratio is not None:
            lr_mult = lr_mult * self._lr_ratio(p)
        if not self._will_fuse(p) and self._decays(p):
            # the fused kernel folds the decay in, in the same order
            factor = self._decay_factor if lr_mult == 1.0 else \
                1.0 - self._lr(lr_mult) * self._coeff
            p.copy_(p.float() * factor)
        super()._update_param(p, g, lr_mult)


class Adamax(Optimizer):
    """``m = beta1 * m + (1 - beta1) * g``, ``u = max(beta2 * u, |g|)``,
    ``p -= lr * m / ((1 - beta1^t) * (u + eps))``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-08, parameters=None, weight_decay=None,
                 grad_clip=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        g = g.float()
        m = self._acc("moment", p)
        u = self._acc("inf_norm", p)
        b1p = self._acc("beta1_pow", p, init=1.0, shape=())
        b1p.mul_(self._beta1)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        u.copy_(torch.maximum(self._beta2 * u, torch.abs(g)))
        upd = lr * m / ((1 - b1p) * (u + self._epsilon))
        p.copy_(p.float() - upd)


class _Named:
    """A parameter as the reference's ``exclude_from_weight_decay_fn``
    sees it: the tensor's attributes, and its ``name`` (a torch tensor's
    own ``name`` is a read-only None)."""

    __slots__ = ("name", "_tensor")

    def __init__(self, tensor, name):
        self.name = name
        self._tensor = tensor

    def __getattr__(self, attr):
        return getattr(self._tensor, attr)


class Lamb(Optimizer):
    """Adam's moments and bias correction, then ``r = mhat / (sqrt(vhat)
    + eps) + wd * p`` scaled by the trust ratio ``||p|| / ||r||``:
    ``p -= lr * trust * r``. ``wd`` is 0 for a parameter for which
    ``exclude_from_weight_decay_fn`` is true; it is given the parameter
    with its name as ``.name``, as the reference's parameters carry
    theirs."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-06, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None):
        super().__init__(learning_rate, parameters, None, grad_clip)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lamb_wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr_mult=1.0):
        lr = self._lr(lr_mult)
        g = g.float()
        m = self._acc("moment1", p)
        v = self._acc("moment2", p)
        b1p = self._acc("beta1_pow", p, init=1.0, shape=())
        b2p = self._acc("beta2_pow", p, init=1.0, shape=())
        b1p.mul_(self._beta1)
        b2p.mul_(self._beta2)
        m.copy_(self._beta1 * m + (1 - self._beta1) * g)
        v.copy_(self._beta2 * v + (1 - self._beta2) * g * g)
        mhat = m / (1 - b1p)
        vhat = v / (1 - b2p)
        r = mhat / (torch.sqrt(vhat) + self._epsilon)
        fn = self._exclude_fn
        wd = 0.0 if fn is not None and fn(_Named(p, self._names[id(p)])) \
            else self._lamb_wd
        pf = p.float()
        update = r + wd * pf
        w_norm = torch.sqrt(torch.sum(torch.square(pf)))
        u_norm = torch.sqrt(torch.sum(torch.square(update)))
        trust = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            1.0)
        p.copy_(pf - lr * trust * update)
