"""``to_static`` (counterpart of ``paddle_tpu/jit/api.py:to_static``).

The reference traces the wrapped step into one XLA program. PyTorch runs
eagerly, so the port runs the function as it is, under the step's
activation policy (``amp_policy="bf16"``: bf16 activation residency with
f32 master weights, see :mod:`paddle_tpu_torch.amp.policy`). Capturing
the step in a CUDA graph, ``remat`` and ``guard`` are not ported yet.
"""
from __future__ import annotations

import functools

from paddle_tpu_torch.amp.policy import ActivationPolicy, activation_residency

__all__ = ["to_static"]


def to_static(function=None, amp_policy=None, remat=None, guard=False):
    """Wrap a train step: a bare decorator, a decorator with options, or
    ``to_static(fn, ...)``. ``amp_policy`` is None or "bf16"; ``remat``
    and ``guard`` raise NotImplementedError until they are ported."""
    if remat:
        raise NotImplementedError("to_static(remat=...) is not ported yet")
    if guard:
        raise NotImplementedError("to_static(guard=True) is not ported yet")
    policy = None if amp_policy is None else ActivationPolicy(amp_policy)

    def wrap(fn):
        if policy is None:
            return fn

        @functools.wraps(fn)
        def step(*args, **kwargs):
            with activation_residency(policy):
                return fn(*args, **kwargs)
        return step

    return wrap(function) if function is not None else wrap
