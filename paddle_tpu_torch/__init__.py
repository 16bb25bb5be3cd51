"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu."""
from paddle_tpu_torch import (amp, distributed, framework, jit, nn,
                              optimizer, quantization, regularizer, tensor)
from paddle_tpu_torch.framework.state import (get_rng_state, seed,
                                              set_rng_state)
from paddle_tpu_torch.tensor import einsum, rand, topk

__all__ = ["amp", "distributed", "einsum", "framework", "get_rng_state",
           "jit", "nn", "optimizer", "quantization", "rand", "regularizer",
           "seed", "set_rng_state", "tensor", "topk"]
