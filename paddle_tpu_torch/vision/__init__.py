"""Vision models of the port (counterpart of ``paddle_tpu/vision``)."""
from paddle_tpu_torch.vision import models

__all__ = ["models"]
