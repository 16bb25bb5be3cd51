"""Extension functionals (counterpart of
``paddle_tpu/nn/functional/extension.py``)."""
from __future__ import annotations

import torch

__all__ = ["diag_embed", "sequence_mask", "temporal_shift"]

_DTYPES = {"bool": torch.bool, "int32": torch.int32, "int64": torch.int64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32, "float64": torch.float64}


def _dtype(dtype):
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def sequence_mask(x, maxlen=None, dtype="int64"):
    """``arange(maxlen) < x[..., None]`` in ``dtype``. ``maxlen`` None
    is x's largest value, read on the host."""
    if maxlen is None:
        maxlen = int(x.max())
    elif isinstance(maxlen, torch.Tensor):
        maxlen = int(maxlen)
    steps = torch.arange(maxlen, device=x.device)
    return (steps < x[..., None]).to(_dtype(dtype))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    """TSM's shift over ``[N T, C, H, W]`` (or NHWC): the first
    ``C * shift_ratio`` channels take the next segment's values, the next
    as many the previous segment's, zeros at the ends."""
    if data_format == "NHWC":
        x = x.permute(0, 3, 1, 2)
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    fold = int(c * shift_ratio)
    zero = torch.zeros_like(v[:, :1, :fold])
    left = torch.cat([v[:, 1:, :fold], zero], dim=1)
    right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                       v[:, :-1, fold:2 * fold]], dim=1)
    out = torch.cat([left, right, v[:, :, 2 * fold:]], dim=2)
    out = out.reshape(nt, c, h, w)
    return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out


def diag_embed(input, offset=0, dim1=-2, dim2=-1):  # noqa: A002
    """The last axis of ``input`` on the ``offset`` diagonal of new
    ``(dim1, dim2)`` square axes."""
    return torch.diag_embed(input, offset, dim1, dim2)
