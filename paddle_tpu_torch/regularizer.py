"""Weight-decay regularizers (counterpart of ``paddle_tpu/regularizer.py``).

Coupled decay: the optimizer adds ``coeff * p`` (:class:`L2Decay`) or
``coeff * sign(p)`` (:class:`L1Decay`) to a parameter's gradient before
its update. A parameter's own ``regularizer`` attribute takes
precedence over the optimizer's ``weight_decay``.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
