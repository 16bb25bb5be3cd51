"""Activation recomputation (counterpart of
``paddle_tpu/distributed/recompute.py``).

:func:`recompute` runs a region (a module, a bound method of one, or any
callable) without keeping its activations: the forward keeps only the
region's tensor inputs, and the backward runs the region again, with
gradients, from those inputs, then pulls the output's gradient through
that re-run. Compute is traded for memory, as ``jax.checkpoint`` does
in the reference. The parameters of the region's owner (the module, or
the module a bound method belongs to) are lifted to inputs of the
region, as the reference lifts them, so they get their gradients
through it; a callable without an owner gets gradients for its tensor
arguments only.

Three things the reference keeps by tracing the region once are kept
here by hand:

- **The RNG key.** The forward keeps a device copy of the global key
  (:mod:`paddle_tpu_torch.framework.state`) as it enters the region;
  the re-run starts from that copy, so every dropout mask it draws is
  the forward's, and afterwards the key goes back to where the forward
  left it: the key advances once per draw, as without recompute. These
  are device copies, so a captured step does the same at every replay.
  (``torch.utils.checkpoint``'s ``preserve_rng_state`` knows nothing of
  this key.)
- **The mixed-precision policy.** Autograd runs a backward on its own
  thread, where the step's thread-local policy and autocast are not
  set; the re-run enters the ones its forward ran under.
- **``remat="bf16"``.** Under a policy with that mode the saved f32
  boundaries are stored in bf16 and raised back to their type for the
  re-run (:meth:`~paddle_tpu_torch.amp.policy.ActivationPolicy.
  cast_saved`); the forward's own output comes from the unrounded
  inputs.

Nested regions are not wrapped again: the outermost region wins
(:func:`recompute_active`). ``recompute_hybrid`` comes with the
distributed slice.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from paddle_tpu_torch.amp.auto_cast import amp_state, auto_cast
from paddle_tpu_torch.amp.policy import (activation_residency,
                                         current_policy, remat_active)
from paddle_tpu_torch.framework import state

__all__ = ["enable_recompute", "recompute", "recompute_active",
           "recompute_sequential"]

_tls = threading.local()


def recompute_active():
    """True while a region's forward, or its backward's re-run, runs on
    this thread."""
    return getattr(_tls, "depth", 0) > 0


@contextlib.contextmanager
def _region():
    _tls.depth = getattr(_tls, "depth", 0) + 1
    try:
        yield
    finally:
        _tls.depth -= 1


def _owner_params(function):
    """The trainable parameters of ``function``'s owner module(s)."""
    owners = getattr(function, "_recompute_owners", None)
    if owners is None:
        owner = function if isinstance(function, nn.Module) \
            else getattr(function, "__self__", None)
        owners = [owner] if isinstance(owner, nn.Module) else []
    params = {}
    for owner in owners:
        for p in owner.parameters():
            if p.requires_grad:
                params[id(p)] = p
    return list(params.values())


def _autocast_args():
    """``auto_cast``'s arguments for this thread's autocast, or None when
    it is off."""
    st = amp_state()
    if not st.enabled:
        return None
    return dict(custom_white_list=st.custom_white,
                custom_black_list=st.custom_black, level=st.level,
                dtype="bfloat16" if st.dtype == torch.bfloat16 else "float16")


@contextlib.contextmanager
def _amp(policy, autocast):
    """The policy and autocast (``auto_cast``'s arguments, or None) a
    region's forward ran under, entered on the re-run's thread."""
    with contextlib.ExitStack() as stack:
        if policy is not None:
            stack.enter_context(activation_residency(policy))
        if autocast is not None and (policy is None or policy.dtype is None):
            stack.enter_context(auto_cast(**autocast))
        yield


class _Recompute(torch.autograd.Function):
    """The region as one autograd node: inputs ``(*args, *params)``."""

    @staticmethod
    def forward(ctx, function, kwargs, n_args, *inputs):
        args, params = inputs[:n_args], inputs[n_args:]
        ctx.function, ctx.kwargs, ctx.params = function, kwargs, params
        ctx.policy = current_policy()
        ctx.autocast = _autocast_args()
        ctx.key = state._rng.key
        ctx.key_start = None if ctx.key is None else ctx.key.clone()
        ctx.args = [a.detach() if isinstance(a, torch.Tensor) else a
                    for a in args]
        ctx.saved = [ctx.policy.cast_saved(a) if ctx.policy is not None
                     and isinstance(a, torch.Tensor) else a
                     for a in ctx.args]
        ctx.needs = [isinstance(a, torch.Tensor) and a.requires_grad
                     for a in args]
        with _region():
            return function(*args, **kwargs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        args = []
        for a, saved, need in zip(ctx.args, ctx.saved, ctx.needs):
            if isinstance(a, torch.Tensor):
                saved = saved.to(a.dtype).detach().requires_grad_(need)
            args.append(saved)
        key = ctx.key
        if key is not None:
            left = key.clone()
            key.copy_(ctx.key_start)
        with torch.enable_grad(), _amp(ctx.policy, ctx.autocast), _region():
            out = ctx.function(*args, **ctx.kwargs)
        if key is not None:
            key.copy_(left)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if isinstance(o, torch.Tensor) and o.requires_grad
                 and g is not None]
        wrt = [a for a, need in zip(args, ctx.needs) if need] + \
            list(ctx.params)
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wrt, [g for _, g in pairs],
            allow_unused=True) if pairs and wrt else [None] * len(wrt))
        arg_grads = [next(got) if need else None for need in ctx.needs]
        return (None, None, None, *arg_grads, *got)


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)`` as a recompute region when
    gradients are on and no region is running on this thread, else
    called as it is. Keyword arguments are passed through as they are
    (not differentiated); ``preserve_rng_state`` and ``use_reentrant``
    are accepted and ignored (the global key is always kept)."""
    kwargs.pop("preserve_rng_state", None)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled() or recompute_active():
        return function(*args, **kwargs)
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  None)
    state.key_tensor(device)        # the key a re-run must start from
    params = _owner_params(function)
    return _Recompute.apply(function, kwargs, len(args), *args, *params)


class _Chain:
    """A run of callables, each fed the last one's output, as one region
    whose owners are the members' modules."""

    def __init__(self, functions):
        self._functions = list(functions)
        self._recompute_owners = [
            f if isinstance(f, nn.Module) else getattr(f, "__self__", None)
            for f in self._functions]
        self._recompute_owners = [o for o in self._recompute_owners
                                  if isinstance(o, nn.Module)]

    def __call__(self, *args, **kwargs):
        x = self._functions[0](*args, **kwargs)
        for f in self._functions[1:]:
            x = f(x)
        return x


def recompute_sequential(ctx, functions, *args, **kwargs):
    """A sequence of callables (an ``nn.Sequential`` or a list) cut into
    ``ctx["segments"]`` recompute regions, chained (reference
    ``recompute_sequential``: the first member takes the arguments, each
    next one the last one's output)."""
    segments = max(int(dict(ctx or {}).get("segments", 1)), 1)
    if isinstance(functions, nn.Sequential):
        functions = list(functions.children())
    functions = list(functions)
    seg = max(len(functions) // segments, 1)
    out, pos = args, 0
    while pos < len(functions):
        end = min(pos + seg, len(functions))
        if len(functions) - end < seg:
            end = len(functions)
        out = recompute(_Chain(functions[pos:end]),
                        *(out if isinstance(out, tuple) else (out,)),
                        **kwargs)
        pos = end
    return out


def enable_recompute(layer, mode=True):
    """Per-module recompute (the reference's ``Layer.enable_recompute``):
    ``True`` makes the module's forward a recompute region whenever it
    trains with gradients on, ``"auto"`` only while an ambient remat
    policy is active (``to_static(remat=...)``), ``False`` turns it off.
    Returns the module."""
    if mode not in (True, False, "auto"):
        raise ValueError(f"mode must be True, False or 'auto', got {mode!r}")
    layer._remat_mode = mode
    if "_remat_inner" not in layer.__dict__:
        inner = layer.forward
        layer.__dict__["_remat_inner"] = inner

        def forward(*args, **kwargs):
            m = layer._remat_mode
            if m and layer.training and (m is True or remat_active()):
                return recompute(inner, *args, **kwargs)
            return inner(*args, **kwargs)

        layer.forward = forward
    return layer
