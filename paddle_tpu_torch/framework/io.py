"""Weight bridge between the reference package and the port.

Both packages name and lay out their weights alike (Linear ``[in, out]``,
embeddings ``[vocab, hidden]``, the same dotted keys), so a state dict
crosses as ``{name: numpy array}``: from the reference with
``{k: np.asarray(t._value) for k, t in model.state_dict().items()}``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_numpy_state_dict", "numpy_grads", "numpy_state_dict"]


def load_numpy_state_dict(module, arrays):
    """Copy ``{name: array}`` into ``module``'s parameters and buffers,
    converting to each one's dtype and device. Raises KeyError on a
    missing or extra key and ValueError on a shape mismatch, before
    anything is copied."""
    own = module.state_dict()
    missing = sorted(set(own) - set(arrays))
    extra = sorted(set(arrays) - set(own))
    if missing or extra:
        raise KeyError(f"state dict mismatch: missing {missing}, "
                       f"extra {extra}")
    values = {}
    for name, t in own.items():
        a = np.asarray(arrays[name])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"shape mismatch for {name}: {a.shape} vs "
                             f"{tuple(t.shape)}")
        if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)      # numpy has no bf16 of its own
        values[name] = torch.tensor(a)
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(values[name])


def numpy_state_dict(module):
    """``{name: numpy array}`` of ``module``'s state; bf16 tensors come
    out as float32 (numpy has no bf16 of its own)."""
    out = {}
    for name, t in module.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy()
    return out


def numpy_grads(module):
    """``{name: numpy array}`` of the gradients ``module``'s parameters
    hold (parameters without one are left out), by the state dict's
    names; bf16 gradients come out as float32."""
    out = {}
    for name, p in module.named_parameters():
        if p.grad is not None:
            g = p.grad.detach().cpu()
            out[name] = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
    return out
