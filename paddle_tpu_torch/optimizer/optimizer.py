"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Paddle's imperative API over torch parameters: ``opt.clear_grad()``,
``loss.backward()``, ``opt.step()``. Accumulators (moments, powers) are
tensors on each parameter's device, made at its first update.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer"]


class Optimizer:
    """``parameters``: tensors, or ``(name, tensor)`` pairs as
    ``module.named_parameters()`` gives them (names are what
    ``AdamW``'s ``apply_decay_param_fun`` sees)."""

    def __init__(self, learning_rate=0.001, parameters=None):
        if parameters is None:
            raise ValueError("optimizer constructed without parameters")
        self._parameter_list = []
        self._names = {}
        for item in parameters:
            name, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_list.append(p)
            self._names[id(p)] = name
        self._lr = float(learning_rate)
        self._accumulators = {}

    def _acc(self, name, p, init=0.0, shape=None):
        """The f32 accumulator ``name`` of ``p`` (p's shape unless
        ``shape`` is given), filled with ``init`` when first asked for."""
        key = (name, id(p))
        if key not in self._accumulators:
            shape = tuple(p.shape) if shape is None else tuple(shape)
            self._accumulators[key] = torch.full(
                shape, init, dtype=torch.float32, device=p.device)
        return self._accumulators[key]

    def _params(self):
        return [p for p in self._parameter_list if p.requires_grad]

    @torch.no_grad()
    def step(self):
        """One update of every parameter that has a gradient."""
        for p in self._params():
            if p.grad is not None:
                self._update_param(p, p.grad)

    def _update_param(self, p, g):
        raise NotImplementedError

    def clear_grad(self):
        """Drop every parameter's gradient (the next backward makes new
        ones)."""
        for p in self._params():
            p.grad = None
