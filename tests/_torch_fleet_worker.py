"""Worker script of the port's multi-process collective proofs
(``tests/test_torch_collective.py``; ``chip_smoke.py``'s collectives
phase runs it with its tensors on the card). It imports torch and
``paddle_tpu_torch`` only.

Launched as N processes through ``python -m
paddle_tpu_torch.distributed.launch`` (which installs the store client
and pins the fleet world)::

    _torch_fleet_worker.py OUT_DIR DEVICE ops
    _torch_fleet_worker.py OUT_DIR DEVICE chaos|baseline CKPT_DIR \\
        KILL_RANK KILL_STEP CKPT_STEP TOTAL_STEPS

``ops``: every eager collective once, the result written as
``ops-rank<R>.json``.

``chaos`` (3 ranks): each rank trains a closed-form linear regression
whose only cross-rank traffic is one eager AVG ``all_reduce`` of [loss,
grad] a step, beating a ``HeartbeatPublisher`` and watched by a
``FleetMonitor``; a quorum ``DistributedCheckpointer.save`` after step
``CKPT_STEP`` (replicated weights, a sharded per-rank marker); a
``rank_kill`` fault SIGKILLs rank ``KILL_RANK`` at the top of step
``KILL_STEP``; the survivors catch the ``CollectiveTimeout`` naming it,
wait for the DEAD verdict, ``reconfigure`` to 2, reload the checkpoint
resharded and rerun steps ``CKPT_STEP + 1 .. TOTAL_STEPS``.
``baseline`` (2 ranks): the same checkpoint loaded at world size 2 and
the same steps fault-free. The parent holds the two trajectories equal.

Workers leave through ``os._exit`` after ``fleet.finalize()`` (rank 0,
the store's host, lingers until its peers checked out).
"""
import json
import os
import sys
import time

import numpy as np
import torch

DIM = 4
SHARD_ROWS = 4
LR = 0.05


def batch(step, rank):
    """A deterministic batch of (step, fleet rank): the same for the
    survivors after a reconfigure and for the baseline."""
    rng = np.random.RandomState(1000 + 17 * step + rank)
    w_true = np.arange(1.0, DIM + 1.0, dtype=np.float64)
    X = rng.randn(8, DIM)
    return X, X @ w_true


def train_step(dist, w, step, rank, device, times):
    """Local loss and gradient, one eager AVG all_reduce of [loss, grad]
    (its ms appended to ``times``), an SGD update."""
    X, y = batch(step, rank)
    err = X @ w - y
    loss = float(np.mean(err * err))
    grad = (2.0 / X.shape[0]) * (X.T @ err)
    vec = torch.tensor(np.concatenate([[loss], grad]), dtype=torch.float64,
                       device=device)
    t0 = time.perf_counter()
    dist.all_reduce(vec, op=dist.ReduceOp.AVG)
    out = vec.cpu().numpy()
    times.append(round((time.perf_counter() - t0) * 1e3, 3))
    return float(out[0]), w - LR * out[1:]


def _listed(ts):
    return [t.cpu().tolist() for t in ts]


def run_ops(dist, rank, n, device):
    """Every collective once; the values a rank sees."""
    t = torch.tensor([float(rank + 1), 10.0 * (rank + 1)], device=device)
    res = {"rank": rank, "nprocs": n, "device": str(t.device)}
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        v = t.clone()
        dist.all_reduce(v, op=getattr(dist.ReduceOp, op))
        assert v.device == t.device
        res[f"all_reduce_{op}"] = v.cpu().tolist()
    v = t.clone()
    dist.reduce(v, dst=0)
    res["reduce"] = v.cpu().tolist()
    gathered = []
    dist.all_gather(gathered, torch.tensor([rank], dtype=torch.int32,
                                           device=device))
    res["all_gather"] = _listed(gathered)
    b = torch.tensor([100.0 + rank], device=device)
    dist.broadcast(b, src=n - 1)
    res["broadcast"] = b.cpu().tolist()
    objs = []
    dist.all_gather_object(objs, {"rank": rank})
    res["all_gather_object"] = objs
    parts = [torch.full((2,), float(10 * rank + i), device=device)
             for i in range(n)]
    out = torch.zeros(2 * n, device=device)
    dist.reduce_scatter(out, parts)
    res["reduce_scatter"] = out.cpu().tolist()
    sc = torch.zeros(2, device=device)
    dist.scatter(sc, parts, src=0)
    res["scatter"] = sc.cpu().tolist()
    outs = []
    dist.alltoall(parts, outs)
    res["alltoall"] = _listed(outs)
    single = torch.zeros(2 * n, device=device)
    dist.all_to_all_single(single, torch.cat(parts))
    res["all_to_all_single"] = single.cpu().tolist()
    dist.barrier()
    res["world"] = [dist.get_rank(), dist.get_world_size()]
    try:
        dist.send(t, dst=0)
    except RuntimeError as e:
        res["send"] = str(e)
    return res


def run_chaos(dist, fleet, faultinject, args, grank, device, result):
    ckpt_dir, kill_rank, kill_step, ckpt_step, total = args
    pub = fleet.install_publisher(fleet.HeartbeatPublisher().start())
    mon = fleet.install_monitor(fleet.FleetMonitor().start())
    ckpt = fleet.DistributedCheckpointer(ckpt_dir, keep=3)
    result["dead_after_s"] = fleet.get_config().dead_after_s
    times = result["allreduce_ms"]
    if result["mode"] == "baseline":
        got = ckpt.load(step=ckpt_step, world_size=2, rank=grank)
        assert got is not None, "baseline found no quorum checkpoint"
        w = np.asarray(got[1]["replicated"]["w"])
        for step in range(ckpt_step + 1, total + 1):
            pub.beat()
            loss, w = train_step(dist, w, step, grank, device, times)
            result["losses_resumed"].append(loss)
        return
    faultinject.install(faultinject.FaultInjector(faultinject.FaultPlan(
        [faultinject.FaultSpec("fleet.rank_kill", "rank_kill",
                               at=kill_step - 1)]
        if grank == kill_rank else [], seed=grank, name="fleet-sigkill")))
    w = np.zeros(DIM)
    step = 1
    while step <= total:
        faultinject.fire("fleet.rank_kill", step=step)
        pub.beat()
        try:
            loss, w = train_step(dist, w, step, fleet.world().rank, device,
                                 times)
        except fleet.CollectiveTimeout as exc:
            result["detection"] = exc.to_dict()
            t0 = time.monotonic()
            deadline = t0 + 30.0
            while (exc.missing_rank not in mon.dead_ranks()
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            dead = mon.dead_ranks() or [exc.missing_rank]
            for r in dead:
                if mon.dead_at(r) is not None:
                    result["verdict_s"] = round(
                        mon.dead_at(r) - mon.last_seq_at(r), 3)
            t1 = time.monotonic()
            new_wv = fleet.reconfigure(dead)
            result["reconfigure_s"] = round(time.monotonic() - t1, 3)
            result["recovery_s"] = round(time.monotonic() - t0, 3)
            result["new_world"] = new_wv.to_dict()
            got = ckpt.load(step=ckpt_step)
            assert got is not None, "no restorable quorum checkpoint"
            w = np.asarray(got[1]["replicated"]["w"])
            marker = np.asarray(got[1]["sharded"]["marker"])
            want = np.sort(np.concatenate(
                [np.full(SHARD_ROWS, m, np.int64) for m in range(3)]))
            per = want.size // new_wv.size
            mine = want[new_wv.rank * per:(new_wv.rank + 1) * per]
            result["reshard_ok"] = bool(np.array_equal(marker, mine))
            result["losses_resumed"] = []
            step = ckpt_step + 1
            continue
        if step > ckpt_step:
            result["losses_resumed"].append(loss)
        if step == ckpt_step:
            ckpt.save(step, sharded={
                "marker": np.full(SHARD_ROWS, grank, np.int64)},
                replicated={"w": w, "step": step})
        step += 1


def main():
    out_dir, device, mode = sys.argv[1], sys.argv[2], sys.argv[3]
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.resilience import faultinject, fleet

    grank = fleet.world().global_rank
    n = fleet.world().size
    if mode == "ops":
        result = run_ops(dist, grank, n, device)
        name = f"ops-rank{grank}.json"
    else:
        args = (sys.argv[4], *map(int, sys.argv[5:9]))
        result = {"mode": mode, "global_rank": grank, "launch_world": n,
                  "detection": None, "reconfigure_s": None,
                  "reshard_ok": None, "losses_resumed": [],
                  "allreduce_ms": []}
        # every rank reaches the device before any heartbeat starts: a
        # slow start must not read as a dead rank
        torch.zeros(1, device=device)
        dist.barrier()
        run_chaos(dist, fleet, faultinject, args, grank, device, result)
        result["final_world"] = fleet.world().to_dict()
        name = f"{mode}-rank{grank}.json"
    path = os.path.join(out_dir, name)
    with open(path + ".tmp", "w") as fh:
        json.dump(result, fh)
    os.replace(path + ".tmp", path)
    fleet.finalize()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
