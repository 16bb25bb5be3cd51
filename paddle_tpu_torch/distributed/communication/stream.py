"""``paddle.distributed.communication.stream`` (counterpart of
``paddle_tpu/distributed/communication/stream.py``): the stream-targeted
collectives are the same eager collectives; a store round trip has no
stream to choose."""
from paddle_tpu_torch.distributed.collective import (
    all_gather, all_reduce, all_to_all_single, alltoall, alltoall_single,
    broadcast, recv, reduce, reduce_scatter, scatter, send)

__all__ = ["all_gather", "all_reduce", "all_to_all_single", "alltoall",
           "alltoall_single", "broadcast", "recv", "reduce",
           "reduce_scatter", "scatter", "send"]
