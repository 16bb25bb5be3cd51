"""Models of the port."""
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         gpt3_1p3b, gpt3_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt3_1p3b", "gpt3_tiny"]
