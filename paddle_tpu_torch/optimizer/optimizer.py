"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Paddle's imperative API over torch parameters: ``opt.clear_grad()``,
``loss.backward()``, ``opt.step()``. Accumulators (moments, powers) are
tensors on each parameter's device, made at its first update.

``guard=True`` arms the training sentinel's probe and skip gate
(:mod:`paddle_tpu_torch.resilience.sentinel`): every step reduces each
gradient region's f32 sum of squares on the device and commits no
update for a region whose gradient is not finite. A region is a row
block of a parameter on the fused path (the kernel gates it) and a
whole parameter otherwise (:meth:`Optimizer._guarded_update` gates any
update rule). The step's verdict lands in a ``(4,)`` f32 device tensor
``[good, grad_sumsq, bad_regions, regions]``, read back only by
:meth:`Optimizer.guard_summary`: the update itself never waits for the
host. Unlike the reference, which skips the select when an eager step's
verdict is concretely good, the port always selects on the device, as
the reference's traced step does: reading the verdict would cost a host
sync per parameter.

A step runs the reference's order (``paddle_tpu/optimizer/
optimizer.py:170-192``): the fault hooks, ``grad_clip`` over every
``(parameter, gradient)`` pair, then per parameter the gradient raised
to f32 (unless the fused kernel takes it as it is), the coupled decay
(the parameter's own ``regularizer`` first, else ``weight_decay``: a
float or an :class:`~paddle_tpu_torch.regularizer.L2Decay` adds
``coeff * p``, an :class:`~paddle_tpu_torch.regularizer.L1Decay`
``coeff * sign(p)``), and the update at ``lr`` times the parameter's
``optimize_attr["learning_rate"]`` (1 without one). The update runs in
an ``optimizer.step`` span (``cls=`` the optimizer's class) and the
roofline profiler's ``optimizer.step`` scope, as the reference's.

Everything a step changes lives in tensors that it changes in place and
that register with :mod:`paddle_tpu_torch.framework.state`: the
parameters, the accumulators (each with its init), the learning rate (a
0-d f32 tensor on the parameters' device, which :meth:`Optimizer.set_lr`,
a bound :class:`~paddle_tpu_torch.optimizer.lr.LRScheduler` and the
sentinel's cooldown write in place) and the guard summary. So a step
that ``to_static`` captured as a CUDA graph reads the values of the
call it replays for, not those of the call it was captured in.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.framework.state import register_state_tensor
from paddle_tpu_torch.observability import span
from paddle_tpu_torch.observability.profile import layer_scope
from paddle_tpu_torch.ops.cuda.optim import supports_fused
from paddle_tpu_torch.resilience import faultinject

__all__ = ["Optimizer"]


class Optimizer:
    """``parameters``: tensors, or ``(name, tensor)`` pairs as
    ``module.named_parameters()`` gives them (names are what
    ``AdamW``'s ``apply_decay_param_fun`` sees, and what the state dict
    and fault targets are keyed by; an unnamed parameter is
    ``param_<i>`` by its position). ``learning_rate`` is a float or an
    :class:`~paddle_tpu_torch.optimizer.lr.LRScheduler`, which then owns
    the lr."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, guard=False):
        from paddle_tpu_torch.optimizer.lr import LRScheduler
        if parameters is None:
            raise ValueError("optimizer constructed without parameters")
        self._parameter_list = []
        self._names = {}
        self._keys = {}
        for i, item in enumerate(parameters):
            name, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_list.append(p)
            self._names[id(p)] = name
            self._keys[id(p)] = name if name is not None else f"param_{i}"
            register_state_tensor(p)
        dev = self._parameter_list[0].device if self._parameter_list \
            else torch.device("cpu")
        self._lr_scheduler = None
        if isinstance(learning_rate, LRScheduler):
            self._lr_scheduler = learning_rate
            learning_rate = learning_rate()
        self._lr_tensor = torch.tensor(float(learning_rate),
                                       dtype=torch.float32, device=dev)
        register_state_tensor(self._lr_tensor)
        # the key of accumulators made for the lr tensor (the gradient
        # merge's counter), the reference's name for it
        self._keys[id(self._lr_tensor)] = "learning_rate"
        if self._lr_scheduler is not None:
            self._lr_scheduler._bind(self._lr_tensor)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._accumulators = {}
        self._inits = {}
        self._acc_keys = {}         # id(p) -> its accumulators' keys
        # subclasses with a fused single-pass update kernel set this
        self._fused = False
        self._guard = bool(guard)
        # [good, grad_sumsq, bad_regions, regions] of the last guarded
        # step, written in place; None from guard_summary() until then
        self._guard_summary_t = None
        self._guard_committed = False
        if self._guard:
            self._guard_summary_t = torch.zeros(4, device=dev)
            register_state_tensor(self._guard_summary_t, init=0.0)
        self._guard_parts = []      # per-parameter device sum-of-squares
        self._guard_bad = []        # per-parameter f32 device bad-region counts
        self._guard_regions = 0

    def _will_fuse(self, p):
        """True when this parameter's update runs the fused single-pass
        kernel (:mod:`paddle_tpu_torch.ops.cuda.optim`)."""
        return self._fused and supports_fused(p.shape)

    # ---- lr ----
    def get_lr(self):
        """The lr: the scheduler's when one owns it, else the lr tensor's
        value (a host read)."""
        if self._lr_scheduler is not None:
            return self._lr_scheduler()
        return float(self._lr_tensor)

    def set_lr(self, value):
        """Write ``value`` into the lr tensor in place; RuntimeError when
        an LRScheduler owns the lr."""
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when LRScheduler is used")
        with torch.no_grad():
            self._lr_tensor.fill_(float(value))

    # ---- accumulators ----
    def _acc(self, name, p, init=0.0, shape=None, dtype=torch.float32):
        """The accumulator ``name`` of ``p`` (p's shape unless ``shape``
        is given), filled with ``init`` when first asked for."""
        key = (name, id(p))
        if key not in self._accumulators:
            shape = tuple(p.shape) if shape is None else tuple(shape)
            t = torch.full(shape, init, dtype=dtype, device=p.device)
            register_state_tensor(t, init=init)
            self._accumulators[key] = t
            self._inits[key] = init
            self._acc_keys.setdefault(id(p), []).append(key)
        return self._accumulators[key]

    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    def _params_grads(self):
        return [(p, p.grad) for p in self._params() if p.grad is not None]

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        from paddle_tpu_torch.distributed import elastic
        elastic.notify_progress()   # the launcher's watchdog heartbeat
        # chaos hooks: `exception` faults at optimizer.step; `bitflip`
        # and `nan_grad` corrupt one gradient element before the update
        faultinject.fire("optimizer.step")
        spec = faultinject.fire("optimizer.grads")
        if spec is not None and spec.kind in ("bitflip", "nan_grad"):
            self._inject_grad_fault(spec)
        # under to_static this span fires as the reference's trace-time
        # span does (jit/api.py); eagerly it times every update pass's
        # launches. The scope books the update's work under
        # "optimizer.step" in the profiler's attribution
        with span("optimizer.step", cls=type(self).__name__), \
                layer_scope("optimizer.step"):
            pg = self._params_grads()
            if self._grad_clip is not None:
                pg = self._grad_clip(pg)
            if self._guard:
                self._guard_parts = []
                self._guard_bad = []
                self._guard_regions = 0
            self._begin_step()
            for p, g in pg:
                lr_mult = getattr(p, "optimize_attr", {}).get(
                    "learning_rate", 1.0)
                if g.dtype != p.dtype and not self._will_fuse(p):
                    # the fused kernel reads a narrow gradient itself
                    g = g.float()
                g = self._apply_decay(p, g)
                if self._guard and not self._will_fuse(p):
                    self._guarded_update(p, g, lr_mult)
                else:
                    self._update_param(p, g, lr_mult)
            if self._guard:
                self._commit_guard_summary()

    def _apply_decay(self, p, g):
        """The gradient with the coupled decay added: the parameter's own
        ``regularizer`` wins, applied even without ``weight_decay``."""
        from paddle_tpu_torch.regularizer import L1Decay, L2Decay
        reg = getattr(p, "regularizer", None)
        if reg is None:
            reg = self._weight_decay
        if reg is None:
            return g
        if isinstance(reg, float):
            return g + reg * p
        if isinstance(reg, L2Decay):
            return g + reg._coeff * p
        if isinstance(reg, L1Decay):
            return g + reg._coeff * torch.sign(p)
        return g

    def _lr(self, lr_mult):
        """The lr tensor times a parameter's multiplier (the tensor
        itself at 1)."""
        if lr_mult == 1.0:
            return self._lr_tensor
        return self._lr_tensor * lr_mult

    def _begin_step(self):
        """Device scalars a step's updates share, made once a step."""

    def _update_param(self, p, g, lr_mult=1.0):
        raise NotImplementedError

    def clear_grad(self):
        """Drop every parameter's gradient (the next backward makes new
        ones)."""
        for p in self._params():
            p.grad = None

    # ---- sentinel guard ----
    def _inject_grad_fault(self, spec):
        """Apply a bitflip/nan_grad fault to the target gradient
        (``payload["param"]`` names it; default: the first parameter
        with a gradient), deterministically from (plan seed, spec)."""
        plan = faultinject.active_plan()
        seed = plan.seed if plan is not None else 0
        target = spec.payload.get("param")
        for p, g in self._params_grads():
            if target is not None and self._keys[id(p)] != target:
                continue
            g.copy_(faultinject.corrupt_array(spec, g, seed=seed))
            return

    def guard_summary(self):
        """The last guarded step's probe as a
        :class:`~paddle_tpu_torch.resilience.sentinel.GuardSummary`
        (None before the first guarded step): the one host read of a
        guarded step."""
        if not self._guard_committed:
            return None
        from paddle_tpu_torch.resilience.sentinel import GuardSummary
        return GuardSummary.from_array(self._guard_summary_t.cpu().numpy())

    def _param_state(self, p):
        """(key, tensor) of p and of every accumulator of p."""
        return [(None, p)] + [(k, self._accumulators[k])
                              for k in self._acc_keys.get(id(p), ())]

    def _guarded_update(self, p, g, lr_mult=1.0):
        """Zero-update gate around any update rule: the gradient's f32
        sum of squares (one reduction serves the finite verdict and the
        grad-norm probe), the update, then every tensor it changed
        selected back to its prior value where the verdict is bad
        (``torch.where``, not a multiply, so NaNs cannot leak)."""
        gsq = g.float().square().sum()
        good = torch.isfinite(gsq)
        self._guard_parts.append(gsq)
        self._guard_bad.append(torch.logical_not(good).float())
        self._guard_regions += 1
        before = {k: t.clone() for k, t in self._param_state(p)}
        self._update_param(p, g, lr_mult)
        for k, t in self._param_state(p):
            old = before.get(k)
            if old is None:
                # made during this update: its prior value is its init
                old = self._init_like(k, t)
            torch.where(good, t, old, out=t)

    def _init_like(self, key, t):
        """The init of the accumulator ``key`` as a tensor like ``t``."""
        init = self._inits[key]
        if isinstance(init, torch.Tensor):
            return init.to(t.device, copy=True)
        return torch.full_like(t, init)

    def _commit_guard_summary(self):
        """Fold the step's per-region probes into the (4,) summary
        ``[good, grad_sumsq, bad_regions, regions]``, written in place
        on the device."""
        dev = self._guard_summary_t.device
        if self._guard_parts:
            total = torch.stack(self._guard_parts).sum()
            bad = torch.stack(self._guard_bad).sum()
        else:
            total = torch.zeros((), device=dev)
            bad = torch.zeros((), device=dev)
        self._guard_summary_t.copy_(torch.stack([
            torch.isfinite(total).float(), total, bad,
            torch.full((), float(self._guard_regions), device=dev)]))
        self._guard_committed = True

    # ---- state ----
    def state_dict(self):
        """``{"<parameter key>_<accumulator>": tensor}`` of every
        accumulator made so far, and, where a scheduler owns the lr,
        ``"LR_Scheduler": {"last_epoch", "last_lr"}`` as in the
        reference (which keeps an empty entry without one)."""
        sd = {f"{self._keys[pid]}_{name}": t
              for (name, pid), t in self._accumulators.items()}
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = {"last_epoch": self._lr_scheduler.last_epoch,
                                  "last_lr": self._lr_scheduler.last_lr}
        return sd

    def set_state_dict(self, state_dict):
        """Copy the accumulators that appear in ``state_dict`` (tensors or
        arrays) back in, each in its own type and device, and a bound
        scheduler's ``last_epoch`` (the reference restores only that:
        the lr follows at the scheduler's next step). As in the
        reference, an entry whose accumulator is not made yet (a fresh
        optimizer before its first step) is dropped."""
        with torch.no_grad():
            for (name, pid), t in self._accumulators.items():
                key = f"{self._keys[pid]}_{name}"
                if key in state_dict:
                    v = state_dict[key]
                    if not isinstance(v, torch.Tensor):
                        v = torch.from_numpy(np.asarray(v))
                    t.copy_(v)
        sched = state_dict.get("LR_Scheduler")
        if sched and self._lr_scheduler is not None:
            self._lr_scheduler.last_epoch = sched.get("last_epoch", 0)
