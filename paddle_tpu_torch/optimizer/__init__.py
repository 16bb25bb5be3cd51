"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.adam import Adam, AdamW
from paddle_tpu_torch.optimizer.optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "lr"]
