"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu."""
from paddle_tpu_torch import amp, jit, nn, optimizer

__all__ = ["amp", "jit", "nn", "optimizer"]
