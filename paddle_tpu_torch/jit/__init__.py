"""``to_static`` of the port (counterpart of ``paddle_tpu/jit``)."""
from paddle_tpu_torch.jit.api import to_static

__all__ = ["to_static"]
