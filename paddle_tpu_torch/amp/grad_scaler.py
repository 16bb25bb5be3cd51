"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``).

The reference's semantics, eager: :meth:`GradScaler.scale` multiplies
the loss by the scale, :meth:`GradScaler.unscale_` divides every
gradient of an optimizer by it in place and notes whether any is not
finite, :meth:`GradScaler.step` runs the optimizer only when all are,
and :meth:`GradScaler.update` halves the scale after
``decr_every_n_nan_or_inf`` bad steps and doubles it after
``incr_every_n_steps`` good ones. The verdict is a host read (the
reference's ``bool(found)``), so a step that scales cannot be captured:
``unscale_`` raises inside a CUDA graph capture, as the reference cannot
trace it either. For a step that must stay on the device, the guarded
optimizer (``guard=True``) skips non-finite updates there.

The scale is a registered 0-d f32 tensor on the device of the first
loss it scales (a CPU one until then), written in place.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.framework.state import register_state_tensor

__all__ = ["GradScaler"]


class GradScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = bool(enable)
        self._scale = self._new_scale(
            init_loss_scaling if enable else 1.0, torch.device("cpu"))
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    @staticmethod
    def _new_scale(value, device):
        t = torch.tensor(float(value), dtype=torch.float32, device=device)
        register_state_tensor(t)
        return t

    def _scale_on(self, device):
        if self._scale.device != device:
            self._scale = self._new_scale(self._scale.item(), device)
        return self._scale

    def scale(self, var):
        """``var`` times the loss scale (``var`` itself when disabled)."""
        if not self._enable:
            return var
        return var * self._scale_on(var.device)

    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer`` by the scale in place
        and note whether any of them is not finite (a host read)."""
        if not self._enable:
            return
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "GradScaler.unscale_ reads its verdict on the host and "
                "cannot run inside a captured step: call it eagerly, or "
                "use the guarded optimizer (guard=True) in a to_static "
                "step")
        found = None
        with torch.no_grad():
            for p in optimizer._params():
                if p.grad is None:
                    continue
                g = p.grad * (1.0 / self._scale_on(p.grad.device))
                p.grad.copy_(g)
                bad = torch.logical_not(torch.isfinite(g).all())
                found = bad if found is None else found | bad.to(found.device)
        self._found_inf = bool(found) if found is not None else False

    def step(self, optimizer):
        """Unscale, step ``optimizer`` unless a gradient is not finite,
        and update the scale."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self.update()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)

    def update(self):
        """The dynamic scale's update after a step."""
        if not self._dynamic:
            return
        with torch.no_grad():
            if self._found_inf:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every:
                    self._scale.copy_(torch.clamp(
                        self._scale * self._decr_ratio, min=1.0))
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every:
                    self._scale.mul_(self._incr_ratio)
                    self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        """The scale now (a host read)."""
        return float(self._scale)

    def state_dict(self):
        return {"scale": self._scale.detach().cpu().numpy(),
                "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        with torch.no_grad():
            self._scale.copy_(torch.as_tensor(sd["scale"],
                                              dtype=torch.float32))
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
