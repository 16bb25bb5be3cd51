"""Worker script of the port's silent-corruption vote proof
(``tests/test_torch_collective.py``). It imports torch and
``paddle_tpu_torch`` only.

Launched as 3 processes through ``python -m
paddle_tpu_torch.distributed.launch``::

    _torch_sentinel_worker.py OUT_DIR SDC_RANK SDC_STEP TOTAL_STEPS

Each rank runs the closed-form loop of ``_torch_fleet_worker.py`` (one
eager AVG ``all_reduce`` of [loss, grad] a step) on its own replica of
the weights, bit-identical across ranks. At step ``SDC_STEP`` rank
``SDC_RANK``'s replica takes a silent bitflip (``corrupt_array``: a low
mantissa bit, finite). After every step the ranks vote
``sentinel.digest_vote({"w": w})`` through the store: every vote names
``SDC_RANK``; the suspect writes its result and leaves (quarantined);
the survivors ``mark_suspect`` it, ``reconfigure`` to 2 and finish with
finite, agreed losses.
"""
import json
import os
import sys
import time

import numpy as np
import torch

DIM = 4
LR = 0.05


def batch(step, rank):
    rng = np.random.RandomState(2000 + 13 * step + rank)
    w_true = np.arange(1.0, DIM + 1.0, dtype=np.float64)
    X = rng.randn(8, DIM)
    return X, X @ w_true


def train_step(dist, w, step, rank):
    X, y = batch(step, rank)
    err = X @ w - y
    loss = float(np.mean(err * err))
    grad = (2.0 / X.shape[0]) * (X.T @ err)
    vec = torch.tensor(np.concatenate([[loss], grad]), dtype=torch.float64)
    dist.all_reduce(vec, op=dist.ReduceOp.AVG)
    out = vec.numpy()
    return float(out[0]), w - LR * out[1:]


def main():
    out_dir = sys.argv[1]
    sdc_rank, sdc_step, total = map(int, sys.argv[2:5])
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.resilience import faultinject, fleet, sentinel

    grank = fleet.world().global_rank
    result = {"global_rank": grank, "launch_world": fleet.world().size,
              "vote": None, "monitor_suspects": None, "new_world": None,
              "losses_resumed": [], "exited_as_suspect": False}
    pub = fleet.install_publisher(fleet.HeartbeatPublisher().start())
    mon = fleet.install_monitor(fleet.FleetMonitor().start())
    faultinject.install(faultinject.FaultInjector(faultinject.FaultPlan(
        [faultinject.FaultSpec("optimizer.grads", "bitflip",
                               at=sdc_step - 1,
                               payload={"index": 1, "bit": 18})]
        if grank == sdc_rank else [], seed=grank, name="sentinel-sdc")))

    def qkey(rank):
        # outside the generation namespaces, which reconfigure reaps
        return f"ptpu/{fleet.world().launch_id}/quarantine/r{rank}"

    def finish(checkout=False):
        path = os.path.join(out_dir, f"vote-rank{grank}.json")
        with open(path + ".tmp", "w") as fh:
            json.dump(result, fh)
        os.replace(path + ".tmp", path)
        if checkout:
            # the quarantined rank's last act: its pid, for rank 0 (the
            # store's host) to wait on before it leaves
            fleet.kv_set_bytes(fleet.get_client(), qkey(grank),
                               str(os.getpid()).encode())
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)

    w = np.zeros(DIM)
    suspect_pids = {}
    step = 1
    while step <= total:
        pub.beat()
        loss, w = train_step(dist, w, step, fleet.world().rank)
        spec = faultinject.fire("optimizer.grads", step=step)
        if spec is not None:
            w = faultinject.corrupt_array(spec, torch.from_numpy(w),
                                          seed=grank).numpy()
        vote = sentinel.digest_vote({"w": w}, step=step, monitor=mon)
        if vote.suspects:
            result["vote"] = vote.to_dict()
            if vote.self_suspect:
                result["exited_as_suspect"] = True
                finish(checkout=True)
            # wait for the suspect's check-out before reconfigure reaps
            # the generation it may still be reading
            for s in vote.suspects:
                raw = fleet.kv_get_bytes(fleet.get_client(), qkey(s),
                                         timeout_s=20.0,
                                         site="sentinel.vote",
                                         missing_rank=s)
                suspect_pids[s] = int(raw.decode().strip("\x00"))
                mon.mark_suspect(s, reason=f"digest vote w@{step}")
            result["monitor_suspects"] = mon.suspect_ranks()
            result["new_world"] = fleet.reconfigure(
                sorted(vote.suspects)).to_dict()
            step += 1
            continue
        if step > sdc_step:
            result["losses_resumed"].append(loss)
        step += 1

    result["final_world"] = fleet.world().to_dict()
    fleet.finalize()
    if grank == 0:
        # the store's host leaves only once the quarantined process is
        # gone: its exit takes the store with it
        deadline = time.monotonic() + 15.0
        pid = suspect_pids.get(sdc_rank)
        while pid is not None and time.monotonic() < deadline:
            try:
                with open(f"/proc/{pid}/stat") as fh:
                    if fh.read().rsplit(")", 1)[1].split()[0] == "Z":
                        break
            except OSError:
                break
            time.sleep(0.05)
    finish()


if __name__ == "__main__":
    main()
