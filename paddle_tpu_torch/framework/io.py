"""Weight bridge between the reference package and the port, and the
port's one durable-write choke point (:func:`write_atomic`).

Both packages name and lay out their weights alike (Linear ``[in, out]``,
embeddings ``[vocab, hidden]``, the same dotted keys), so a state dict
crosses as ``{name: numpy array}``: from the reference with
``{k: np.asarray(t._value) for k, t in model.state_dict().items()}``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["load_numpy_state_dict", "numpy_grads", "numpy_state_dict",
           "to_numpy", "write_atomic"]


def to_numpy(obj):
    """``obj`` with every tensor in it (dicts, lists, tuples) replaced by
    a numpy copy on the host; bf16 comes out as float32 (numpy has no
    bf16 of its own)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def write_atomic(path, data, site="io.save"):
    """Durably write the bytes ``data`` to ``path``: a temp file in the
    target directory, fsync, then an atomic ``os.replace``, so a reader
    never sees a half-written file and a crash mid-write leaves the
    previous one intact (``paddle_tpu/framework/io.py:write_atomic``
    for bytes).

    Fault site ``io.save`` (kind ``torn_write``): ``keep_fraction``
    truncates the payload before the rename (only a content digest
    catches it)."""
    from paddle_tpu_torch.resilience import faultinject
    spec = faultinject.fire(site, path=path, size=len(data))
    torn = spec is not None and spec.kind == "torn_write"
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        if torn:
            f.flush()
            keep = float(spec.payload.get("keep_fraction", 0.5))
            f.truncate(max(0, int(f.tell() * keep)))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


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
    return to_numpy(dict(module.state_dict()))


def numpy_grads(module):
    """``{name: numpy array}`` of the gradients ``module``'s parameters
    hold (parameters without one are left out), by the state dict's
    names; bf16 gradients come out as float32."""
    return {name: to_numpy(p.grad) for name, p in module.named_parameters()
            if p.grad is not None}
