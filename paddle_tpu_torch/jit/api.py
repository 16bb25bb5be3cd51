"""``to_static`` (counterpart of ``paddle_tpu/jit/api.py:to_static``).

The reference traces the wrapped step into one XLA program. PyTorch runs
eagerly, so the port runs the function as it is, under the step's
activation policy (``amp_policy="bf16"``: bf16 activation residency with
f32 master weights, see :mod:`paddle_tpu_torch.amp.policy`).

``guard=True`` adds the training sentinel's loss probe: after the step,
each scalar float output becomes ``(value, isfinite)``, read back in one
host transfer, kept on the wrapper's ``last_guard`` (``values``,
``finite``, ``loss``, ``loss_finite``: the first output's) and handed to
the ambient :class:`~paddle_tpu_torch.resilience.sentinel.TrainingSentinel`'s
``note_probe``. Capturing the step in a CUDA graph and ``remat`` are not
ported yet.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from paddle_tpu_torch.amp.policy import ActivationPolicy, activation_residency

__all__ = ["to_static"]


def _leaves(out):
    """The tensors of a step's output (nested tuples, lists, dicts), in
    order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _leaves(o)]
    return []


def _guard_probe(out):
    """``last_guard`` of a step's output: (value, isfinite) of each
    scalar float tensor in it, stacked on the device and read in one
    transfer."""
    probes = [t.detach().reshape(()).float() for t in _leaves(out)
              if t.numel() == 1 and t.is_floating_point()]
    pairs = torch.stack([torch.stack([v, torch.isfinite(v).float()])
                         for v in probes]).tolist() if probes else []
    values = [v for v, _ in pairs]
    finite = [f >= 0.5 for _, f in pairs]
    return {"values": values, "finite": finite,
            "loss": values[0] if values else None,
            "loss_finite": finite[0] if finite else True}


def to_static(function=None, amp_policy=None, remat=None, guard=False):
    """Wrap a train step: a bare decorator, a decorator with options, or
    ``to_static(fn, ...)``. ``amp_policy`` is None or "bf16"; ``remat``
    raises NotImplementedError until it is ported; ``guard=True`` keeps
    the step's loss probe on ``fn.last_guard`` (None before the first
    call)."""
    if remat:
        raise NotImplementedError("to_static(remat=...) is not ported yet")
    policy = None if amp_policy is None else ActivationPolicy(amp_policy)

    def wrap(fn):
        if policy is None and not guard:
            return fn

        @functools.wraps(fn)
        def step(*args, **kwargs):
            with activation_residency(policy) if policy is not None \
                    else contextlib.nullcontext():
                out = fn(*args, **kwargs)
            if guard:
                from paddle_tpu_torch.resilience import sentinel
                step.last_guard = _guard_probe(out)
                ambient = sentinel.current()
                if ambient is not None:
                    ambient.note_probe(step.__name__, step.last_guard)
            return out

        step.last_guard = None
        return step

    return wrap(function) if function is not None else wrap
