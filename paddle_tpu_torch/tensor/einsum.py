"""Einstein summation (counterpart of ``paddle_tpu/tensor/einsum.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs

__all__ = ["einsum"]


def einsum(equation, *operands):
    """``torch.einsum``; under autocast its f32 operands are cast to
    bf16 first (``einsum`` is on the reference's white list)."""
    return torch.einsum(equation, *downcast_inputs(*operands,
                                                   opname="einsum"))
