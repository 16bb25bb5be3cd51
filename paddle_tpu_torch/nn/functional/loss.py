"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``)."""
from __future__ import annotations

import torch

from paddle_tpu_torch.amp.auto_cast import downcast_inputs

__all__ = ["cross_entropy"]


def cross_entropy(input, label, ignore_index=-100):
    """Softmax cross entropy over the last axis with hard labels
    (``label`` of input's shape without the class axis, or with a
    trailing 1), averaged over the labels that are not
    ``ignore_index``. Under autocast narrow logits are raised to f32
    first, as the reference's ``downcast_inputs`` does."""
    (logits,) = downcast_inputs(input, opname="cross_entropy")
    logp = torch.log_softmax(logits, dim=-1)
    if label.dim() == logits.dim():
        label = label.squeeze(-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label))
    per = -logp.gather(-1, safe.unsqueeze(-1).long()).squeeze(-1)
    per = torch.where(valid, per, torch.zeros_like(per))
    return per.sum() / valid.sum().to(per.dtype).clamp(min=1e-12)
