"""Device resolution for the port's entry points.

The entry points run on CUDA unless the caller asks for the CPU. With
no CUDA device they raise rather than carry on quietly on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["device_name", "model_factory", "resolve_device"]


def resolve_device(device=None):
    """``torch.device`` for ``device`` (default ``"cuda"``). Raises
    RuntimeError for CUDA when no CUDA device is available, ValueError
    for a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: paddle_tpu_torch runs on a CUDA "
                "device by default; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"paddle_tpu_torch runs on cuda or cpu, not {dev}")
    return dev


def model_factory(device=None, dtype=None, generator=None):
    """A model's construction arguments: the resolved device (see
    :func:`resolve_device`), the dtype, and one generator on that device
    that draws every weight in construction order (seeded 0 when none is
    given)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return dict(device=device, dtype=dtype, generator=generator)


def device_name(device):
    """The card's name for a CUDA device, ``"cpu"`` for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
