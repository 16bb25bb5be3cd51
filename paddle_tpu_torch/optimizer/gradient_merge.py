"""k-step gradient accumulation (counterpart of
``paddle_tpu/optimizer/gradient_merge.py``).

Every step takes one path, so one ``to_static`` capture serves the
accumulating steps and the firing ones: the merged gradient of each
parameter is accumulated in a registered f32 device tensor (``gm_acc``),
a device int32 counter (``gm_count``) decides ``fire = (count % k ==
0)``, the inner optimizer's update always runs on the merged gradient
(``/ k`` with ``avg``), and the parameter and every accumulator the
update wrote, those it made in this step included, are committed with
``torch.where(fire, new, old)``. Updates write in place (the fused
kernel too), so each parameter's state is copied before its update. The
clip measures the merged gradient, as the reference's does.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["GradientMergeOptimizer"]


class GradientMergeOptimizer:
    """Wraps ``inner_optimizer``: its update lands every ``k_steps``-th
    step, on the sum (``avg=False``) or mean of the gradients since the
    last one. Everything else (lr, state dict, ...) is the inner
    optimizer's."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if not isinstance(inner_optimizer, Optimizer):
            raise TypeError("GradientMergeOptimizer wraps an Optimizer")
        self._inner = inner_optimizer
        self._k = int(k_steps)
        self._avg = bool(avg)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)

    @torch.no_grad()
    def step(self):
        from paddle_tpu_torch.distributed import elastic
        elastic.notify_progress()   # an accumulate step is progress too
        inner = self._inner
        if self._k <= 1:
            inner.step()
            return
        counter = inner._acc("gm_count", inner._lr_tensor, shape=(),
                             dtype=torch.int32)
        new_count = counter + 1
        fire = (new_count % self._k) == 0
        accs = {}
        pg_eff = []
        for p, g in inner._params_grads():
            acc = inner._acc("gm_acc", p)
            new_acc = acc + g.float()
            accs[id(p)] = (acc, new_acc)
            # a copy either way: the clip scales its gradients in place
            pg_eff.append((p, new_acc / self._k if self._avg
                           else new_acc.clone()))
        if inner._grad_clip is not None:
            pg_eff = inner._grad_clip(pg_eff)
        inner._begin_step()
        for p, g in pg_eff:
            acc, new_acc = accs[id(p)]
            lr_mult = getattr(p, "optimize_attr", {}).get("learning_rate",
                                                          1.0)
            before = {k: t.clone() for k, t in inner._param_state(p)
                      if k is None or k[0] != "gm_acc"}
            inner._update_param(p, inner._apply_decay(p, g), lr_mult)
            for k, t in inner._param_state(p):
                if k is not None and k[0] == "gm_acc":
                    continue
                old = before.get(k)
                if old is None:
                    # made by this update: its prior value is its init
                    old = inner._init_like(k, t)
                torch.where(fire, t, old, out=t)
            acc.copy_(new_acc.masked_fill_(fire, 0.0))
        counter.copy_(new_count)

    @torch.no_grad()
    def clear_grad(self):
        self._inner.clear_grad()

    clear_gradients = clear_grad
