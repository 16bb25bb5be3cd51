"""``paddle.distributed.communication`` (counterpart of
``paddle_tpu/distributed/communication/``): the collectives of
:mod:`paddle_tpu_torch.distributed.collective` re-exported, and their
``stream`` forms. The reference's int8 ``quantized_all_reduce_*`` run
over a mesh axis only and come with it (ROADMAP A.4)."""
from paddle_tpu_torch.distributed.collective import (
    Group, P2POp, ReduceOp, all_gather, all_reduce, all_to_all_single,
    alltoall, alltoall_single, barrier, batch_isend_irecv, broadcast,
    destroy_process_group, get_group, irecv, isend, recv, reduce,
    reduce_scatter, scatter, send)
from paddle_tpu_torch.distributed.communication import stream

__all__ = ["Group", "P2POp", "ReduceOp", "all_gather", "all_reduce",
           "all_to_all_single", "alltoall", "alltoall_single", "barrier",
           "batch_isend_irecv", "broadcast", "destroy_process_group",
           "get_group", "irecv", "is_initialized", "isend", "recv",
           "reduce", "reduce_scatter", "scatter", "send", "stream"]


def is_initialized():
    """True once this process has joined a multi-process fleet (the
    launcher installed its store client)."""
    from paddle_tpu_torch.resilience import fleet
    return fleet.get_client() is not None
