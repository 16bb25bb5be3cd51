"""Distributed layers of the port (single-device forms for now) and
activation recomputation."""
from paddle_tpu_torch.distributed.recompute import (enable_recompute,
                                                    recompute,
                                                    recompute_sequential)

__all__ = ["enable_recompute", "recompute", "recompute_sequential"]
