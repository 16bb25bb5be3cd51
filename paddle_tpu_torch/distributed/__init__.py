"""Distributed layers of the port (single-device forms for now),
activation recomputation, the multi-process launcher
(``distributed/launch``: ``python -m paddle_tpu_torch.distributed.launch``,
with its coordination store) and elastic supervision
(``distributed/elastic.py``)."""
from paddle_tpu_torch.distributed.recompute import (enable_recompute,
                                                    recompute,
                                                    recompute_sequential)

__all__ = ["enable_recompute", "recompute", "recompute_sequential"]
