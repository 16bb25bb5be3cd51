"""Eager collectives (counterpart of ``paddle_tpu/distributed/collective.py``).

The reference's collectives have three paths: mesh-axis collectives
inside a ``shard_map`` body, an eager multi-process path, and a world
of one. The port has no mesh yet (ROADMAP A.4), so a group bound to a
mesh axis raises NotImplementedError. The eager multi-process path is
the reference's CPU-backend one: values travel through the fleet's
coordination store (the launcher's TCPStore client,
:func:`paddle_tpu_torch.resilience.fleet.get_client`) as an allgather
(every member sets its value, then gets every member's) or a broadcast
(the source sets, every member gets). Each get is timeout-bounded and
aborts with :class:`~paddle_tpu_torch.resilience.fleet.CollectiveTimeout`
naming the awaited rank once the fleet watchdog holds it DEAD. A CUDA
tensor is staged through the host and the result comes back on its
own device. In a world of one every operation is the reference's
identity.

Only what the reference's eager path does across processes is done
across processes here: ``all_reduce`` (and ``reduce``), ``all_gather``,
``broadcast`` and ``barrier``. The reference's ``reduce_scatter``,
``scatter``, ``alltoall``, ``all_to_all_single`` and
``all_gather_object`` act on the local values only, on every path
outside a mesh axis, and so do the port's; ``send`` / ``recv`` /
``isend`` / ``irecv`` / ``batch_isend_irecv`` need a mesh axis in the
reference and raise here as there.
"""
from __future__ import annotations

import pickle

import torch

__all__ = [
    "Group", "P2POp", "ReduceOp", "all_gather", "all_gather_object",
    "all_reduce", "all_to_all_single", "alltoall", "alltoall_single",
    "barrier", "batch_isend_irecv", "broadcast", "destroy_process_group",
    "get_group", "get_rank", "get_world_size", "gloo_barrier",
    "gloo_init_parallel_env", "gloo_release", "irecv", "isend",
    "new_group", "ppermute", "recv", "reduce", "reduce_scatter",
    "reset_coord_rounds", "scatter", "send", "shift", "wait",
]

_MESH = ("collectives over a mesh axis (a group with axis=, shard_map) "
         "are not ported: the port has no mesh yet (ROADMAP A.4)")


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Group:
    """A communication group: the fleet's world, or (not ported yet) a
    mesh axis."""

    def __init__(self, axis=None, ranks=None, id=0):
        self.axis = axis
        self.ranks = ranks or []
        self.id = id

    @property
    def nranks(self):
        if self.axis is not None:
            raise NotImplementedError(_MESH)
        return get_world_size()

    @property
    def world_size(self):
        return self.nranks

    def get_group_rank(self, rank):
        return rank

    @property
    def rank(self):
        return get_rank()


_default_group = Group()


def new_group(ranks=None, backend=None, axis=None):
    return Group(axis=axis, ranks=ranks, id=1)


def get_group(gid=0):
    return _default_group


def _check_axis(group):
    if group is not None and getattr(group, "axis", None):
        raise NotImplementedError(_MESH)


def get_rank(group=None):
    """The fleet rank: contiguous within the survivor set after an
    elastic reconfigure."""
    _check_axis(group)
    from paddle_tpu_torch.resilience import fleet
    return fleet.world().rank


def get_world_size(group=None):
    _check_axis(group)
    from paddle_tpu_torch.resilience import fleet
    return fleet.world().size


# A per-process round counter names each store collective: every member
# issues the same collectives in the same order, so one round id names
# one collective fleet-wide. Keys live under the fleet's namespace (launch
# id + generation), which finalize and reconfigure reap whole;
# _COORD_REAPED is the newest round proven complete everywhere and swept.
_COORD_ROUND = [0]
_COORD_REAPED = [0]
_REAP_BATCH = 64     # most rounds swept in one allgather


def reset_coord_rounds():
    """Fresh round counters for a fresh key namespace: called by
    :func:`paddle_tpu_torch.resilience.fleet.reconfigure` after the
    generation bump (every survivor resets alike)."""
    _COORD_ROUND[0] = 0
    _COORD_REAPED[0] = 0


def _coord_client():
    from paddle_tpu_torch.resilience import fleet
    client = fleet.get_client()
    if client is None:
        raise RuntimeError(
            "no coordination store: multi-process collectives need the "
            "launcher (python -m paddle_tpu_torch.distributed.launch)")
    return client


def _multi_process():
    from paddle_tpu_torch.resilience import fleet
    return fleet.get_client() is not None and fleet.world().size > 1


def _coord_get(client, key, missing_rank, rnd):
    """One peer's contribution under the collective deadline, aborted
    as soon as the watchdog holds ``missing_rank`` DEAD."""
    from paddle_tpu_torch.resilience import fleet
    mon = fleet.get_monitor()
    abort_if = (None if mon is None
                else (lambda: mon.is_dead(missing_rank)))
    return fleet.kv_get_bytes(
        client, key, fleet.get_config().collective_timeout_s,
        site="fleet.kv_get", missing_rank=missing_rank,
        abort_if=abort_if, seed=rnd)


def _host(value):
    """A tensor on the CPU, detached, for the store."""
    return value.detach().to("cpu")


def _coord_allgather(value):
    """Every member's ``value`` (a tensor) stacked on a new leading axis
    in fleet member order, on the CPU."""
    from paddle_tpu_torch.resilience import fleet
    client = _coord_client()
    wv = fleet.world()
    _COORD_ROUND[0] += 1
    rnd = _COORD_ROUND[0]
    prefix = f"{fleet.coord_namespace()}/allgather/{rnd}"
    fleet.kv_set_bytes(client, f"{prefix}/{wv.global_rank}",
                       pickle.dumps(_host(value)))
    parts = [pickle.loads(_coord_get(client, f"{prefix}/{r}", r, rnd))
             for r in wv.members]
    _coord_reap(client, wv.rank, rnd)
    return torch.stack(parts)


def _coord_reap(client, rank, rnd):
    """Fleet rank 0 deletes the rounds before ``rnd``, at most
    ``_REAP_BATCH`` of them. Safe inside an allgather whose every member
    key has arrived: each member sets its key of round ``rnd`` on
    entering it, so every member has finished every earlier round,
    broadcasts included (nothing else proves a broadcast's readers are
    done). Round ``rnd`` itself is left: peers may still read it."""
    if rank != 0:
        return
    from paddle_tpu_torch.resilience import fleet
    ns = fleet.coord_namespace()
    sweep = range(_COORD_REAPED[0] + 1,
                  min(rnd, _COORD_REAPED[0] + 1 + _REAP_BATCH))
    for old in sweep:
        for prefix in (f"{ns}/allgather", f"{ns}/bcast"):
            try:
                client.key_value_delete(f"{prefix}/{old}")
            except Exception:
                pass
    if sweep:
        _COORD_REAPED[0] = sweep[-1]


def _coord_broadcast(value, src):
    """Fleet rank ``src``'s ``value``, on the CPU: one set by the
    source, one get by every member."""
    from paddle_tpu_torch.resilience import fleet
    client = _coord_client()
    wv = fleet.world()
    src_global = wv.members[int(src)]
    _COORD_ROUND[0] += 1
    rnd = _COORD_ROUND[0]
    key = f"{fleet.coord_namespace()}/bcast/{rnd}/{src_global}"
    if wv.global_rank == src_global:
        fleet.kv_set_bytes(client, key, pickle.dumps(_host(value)))
    return pickle.loads(_coord_get(client, key, src_global, rnd))


def _set_value(tensor, value):
    """Give ``tensor`` the value ``value`` on its own device: in place
    where shape and dtype agree, else by replacing its data (the
    reference replaces the value)."""
    value = value.to(tensor.device)
    with torch.no_grad():
        if value.shape == tensor.shape and value.dtype == tensor.dtype:
            tensor.copy_(value)
        else:
            tensor.data = value
    return tensor


_REDUCE = {ReduceOp.SUM: lambda g: g.sum(dim=0),
           ReduceOp.MAX: lambda g: g.amax(dim=0),
           ReduceOp.MIN: lambda g: g.amin(dim=0),
           ReduceOp.PROD: lambda g: g.prod(dim=0),
           ReduceOp.AVG: lambda g: (g if g.is_floating_point()
                                    else g.float()).mean(dim=0)}


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    _check_axis(group)
    if op not in _REDUCE:
        raise ValueError(f"unsupported ReduceOp {op!r}")
    if _multi_process():
        _set_value(tensor, _REDUCE[op](_coord_allgather(tensor)))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    _check_axis(group)
    if _multi_process():
        g = _coord_allgather(tensor).to(tensor.device)
        tensor_list.extend(g[i] for i in range(g.shape[0]))
        return tensor_list
    tensor_list.append(tensor.clone())
    return tensor_list


def all_gather_object(object_list, obj, group=None):
    object_list.append(obj)
    return object_list


def reduce_scatter(tensor, tensor_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    _check_axis(group)
    stacked = torch.cat(list(tensor_list), dim=0) \
        if isinstance(tensor_list, (list, tuple)) else tensor_list
    return _set_value(tensor, stacked)


def broadcast(tensor, src=0, group=None, sync_op=True):
    _check_axis(group)
    if _multi_process():
        _set_value(tensor, _coord_broadcast(tensor, src))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    return all_reduce(tensor, op, group, sync_op)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    _check_axis(group)
    if tensor_list is None:
        return tensor
    return _set_value(tensor, tensor_list[0])


def alltoall(in_tensor_list, out_tensor_list=None, group=None,
             sync_op=True):
    _check_axis(group)
    if out_tensor_list is not None:
        out_tensor_list.extend(t.clone() for t in in_tensor_list)
        return out_tensor_list
    if isinstance(in_tensor_list, (list, tuple)):
        return torch.stack(list(in_tensor_list), dim=0)
    return in_tensor_list


def all_to_all_single(out_tensor, in_tensor, group=None, sync_op=True):
    _check_axis(group)
    return _set_value(out_tensor, in_tensor)


alltoall_single = all_to_all_single     # the reference exports both


def send(tensor, dst=0, group=None, sync_op=True):
    _check_axis(group)
    raise RuntimeError("send/recv require a mesh axis (pipeline context)")


def recv(tensor, src=0, group=None, sync_op=True):
    return send(tensor, src, group, sync_op)


def ppermute(tensor, perm, axis=None, group=None):
    """Permute values along a mesh axis ring: needs a mesh."""
    raise NotImplementedError(_MESH)


def barrier(group=None):
    """A one-byte allgather round: timeout-bounded and aware of the
    fleet's membership, as the reference's CPU barrier."""
    _check_axis(group)
    if _multi_process():
        _coord_allgather(torch.zeros(1, dtype=torch.int8))


def wait(tensor, group=None, use_calc_stream=True):
    if tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


class shift:
    """A static peer pattern for :func:`batch_isend_irecv`: every rank r
    talks to ``(r + offset) % world_size``."""

    def __init__(self, offset):
        self.offset = int(offset)


class P2POp:
    """One point-to-point op for :func:`batch_isend_irecv`: ``op`` is
    :func:`isend` or :func:`irecv`, ``peer`` a :class:`shift`."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("op must be distributed.isend or "
                             "distributed.irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def isend(tensor, dst=0, group=None):
    raise RuntimeError(
        "isend/irecv cannot run standalone (no one-sided p2p): wrap them "
        "in P2POp(...) and run batch_isend_irecv([...]) over a mesh axis")


def irecv(tensor, src=0, group=None):
    isend(tensor, src, group)


def batch_isend_irecv(p2p_op_list):
    """Matched isend/irecv pairs as one permute over a mesh axis: a
    group bound to an axis is needed, as in the reference."""
    g = p2p_op_list[0].group if p2p_op_list else None
    if g is None or not getattr(g, "axis", None):
        raise RuntimeError("batch_isend_irecv needs a mesh axis: run "
                           "inside shard_map/collective_axis or pass a "
                           "group bound to an axis")
    raise NotImplementedError(_MESH)


def destroy_process_group(group=None):
    """The reference drops its installed mesh; the port has none."""
    return None


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """Join the fleet through the launcher's store at
    ``server_endpoint`` (the reference bootstraps its coordinator the
    same way); a no-op once a store client is installed."""
    from paddle_tpu_torch.distributed.launch import launch
    from paddle_tpu_torch.resilience import fleet
    if fleet.get_client() is None and int(rank_num) > 1:
        launch(server_endpoint, int(rank_num), int(rank_id))


def gloo_barrier():
    barrier()


def gloo_release():
    return None
