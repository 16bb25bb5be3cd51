"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu."""
from paddle_tpu_torch import (amp, distributed, framework, jit, nn,
                              optimizer, quantization, regularizer)
from paddle_tpu_torch.framework.state import (get_rng_state, seed,
                                              set_rng_state)

__all__ = ["amp", "distributed", "framework", "get_rng_state", "jit", "nn",
           "optimizer", "quantization", "regularizer", "seed",
           "set_rng_state"]
