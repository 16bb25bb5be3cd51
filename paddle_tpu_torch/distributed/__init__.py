"""Distributed layers of the port (single-device forms for now),
activation recomputation, Mixture-of-Experts (``distributed/moe.py``),
the eager collectives over the fleet's store
(``distributed/collective.py``, re-exported here and in
``distributed/communication``), the multi-process launcher
(``distributed/launch``: ``python -m paddle_tpu_torch.distributed.launch``,
with its coordination store) and elastic supervision
(``distributed/elastic.py``)."""
from paddle_tpu_torch.distributed.collective import (
    Group, P2POp, ReduceOp, all_gather, all_gather_object, all_reduce,
    all_to_all_single, alltoall, alltoall_single, barrier,
    batch_isend_irecv, broadcast, destroy_process_group, get_group,
    get_rank, get_world_size, gloo_barrier, gloo_init_parallel_env,
    gloo_release, irecv, isend, new_group, ppermute, recv, reduce,
    reduce_scatter, scatter, send, shift, wait)
from paddle_tpu_torch.distributed import communication
from paddle_tpu_torch.distributed.elastic import Command
from paddle_tpu_torch.distributed.recompute import (enable_recompute,
                                                    recompute,
                                                    recompute_sequential)

__all__ = ["Command", "Group", "P2POp", "ReduceOp", "all_gather", "all_gather_object",
           "all_reduce", "all_to_all_single", "alltoall", "alltoall_single",
           "barrier", "batch_isend_irecv", "broadcast", "communication",
           "destroy_process_group", "enable_recompute", "get_group",
           "get_rank", "get_world_size", "gloo_barrier",
           "gloo_init_parallel_env", "gloo_release", "irecv", "isend",
           "new_group", "ppermute", "recompute", "recompute_sequential",
           "recv", "reduce", "reduce_scatter", "scatter", "send", "shift",
           "wait"]
