"""paddle_tpu_torch eager collectives (``distributed/collective.py``) and
the multi-process training proofs, over the port's launcher.

- In a world of one every operation is the reference's identity (the
  port against ``paddle_tpu.distributed`` on the same values, exact).
- Over 2 and 3 launcher processes (``tests/_torch_fleet_worker.py``,
  mode ``ops``) every operation gives what the reference's eager path
  gives, computed here with numpy (exact: small integers in f32); the
  2-process run holds the reference's
  ``test_two_process_all_reduce_via_launch`` contract.
- The chaos proof: 3 ranks, rank 2 SIGKILLed at step 8; the survivors'
  ``CollectiveTimeout`` names it, they reconfigure to 2 and reload the
  quorum checkpoint resharded, and the resumed losses equal a
  fault-free 2-rank run from the same checkpoint exactly.
- The digest vote names the rank that carries a silent bitflip, and the
  survivors reconfigure without it (``tests/_torch_sentinel_worker.py``).

Each multi-process test has its own 30 s deadline; every child is
killed in ``finally``.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import distributed as ref_dist

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import collective, communication
from paddle_tpu_torch.resilience import fleet

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_fleet_worker.py")
SENTINEL_WORKER = os.path.join(HERE, "_torch_sentinel_worker.py")
DEADLINE_S = 30.0
FLEET_ENV = {"PTPU_FLEET_TIMEOUT_S": "10", "PTPU_FLEET_KV_SLICE_S": "0.25",
             "PTPU_FLEET_HB_INTERVAL_S": "0.4",
             "PTPU_FLEET_RENDEZVOUS_TIMEOUT_S": "20"}
KILL_RANK, KILL_STEP, CKPT_STEP, TOTAL_STEPS = 2, 8, 5, 12
SDC_RANK, SDC_STEP, SDC_TOTAL = 2, 4, 8


# ----------------------------------------------------------- one process
def _pair(values):
    return ([torch.tensor(v) for v in values],
            [P.to_tensor(v) for v in values])


def _same(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref.numpy()))


def test_world_of_one_is_the_reference_identity():
    x = np.array([1.0, -2.0, 3.5], np.float32)
    parts = [np.full(2, float(i), np.float32) for i in range(3)]
    assert dist.get_rank() == ref_dist.get_rank() == 0
    assert dist.get_world_size() == ref_dist.get_world_size() == 1
    for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        (t,), (r,) = _pair([x])
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
        ref_dist.all_reduce(r, op=getattr(ref_dist.ReduceOp, op))
        _same(t, r)
    (t,), (r,) = _pair([x])
    _same(dist.reduce(t), ref_dist.reduce(r))
    _same(dist.broadcast(t, src=0), ref_dist.broadcast(r, src=0))
    got, want = dist.all_gather([], t), ref_dist.all_gather([], r)
    assert len(got) == len(want) == 1 and got[0] is not t
    _same(got[0], want[0])
    assert dist.all_gather_object([], {"a": 1}) == \
        ref_dist.all_gather_object([], {"a": 1}) == [{"a": 1}]
    tp, rp = _pair(parts)
    (o,), (ro,) = _pair([np.zeros(6, np.float32)])
    _same(dist.reduce_scatter(o, tp), ref_dist.reduce_scatter(ro, rp))
    (o,), (ro,) = _pair([np.zeros(2, np.float32)])
    _same(dist.scatter(o, tp), ref_dist.scatter(ro, rp))
    assert dist.scatter(o) is o
    for g, w in zip(dist.alltoall(tp, []), ref_dist.alltoall(rp, [])):
        _same(g, w)
    _same(dist.alltoall(tp), ref_dist.alltoall(rp))
    (o,), (ro,) = _pair([np.zeros(3, np.float32)])
    _same(dist.all_to_all_single(o, t), ref_dist.all_to_all_single(ro, r))
    assert dist.alltoall_single is dist.all_to_all_single
    dist.barrier()
    assert dist.wait(t) is t
    assert dist.destroy_process_group() is None
    dist.gloo_barrier()
    assert dist.gloo_release() is None
    dist.gloo_init_parallel_env(0, 1, "127.0.0.1:1")    # a world of one
    assert fleet.get_client() is None
    g = dist.new_group([0])
    assert (g.id, g.nranks, g.rank) == (1, 1, 0)
    assert dist.get_group().id == 0
    assert not communication.is_initialized()
    for fn in (communication.all_reduce, communication.stream.all_reduce):
        assert fn is dist.all_reduce


def test_p2p_and_mesh_axes_raise_as_documented():
    t = torch.zeros(2)
    for call in (lambda: dist.send(t), lambda: dist.recv(t),
                 lambda: dist.isend(t), lambda: dist.irecv(t)):
        with pytest.raises(RuntimeError):
            call()
    for call in (lambda: ref_dist.send(P.to_tensor([0.0])),
                 lambda: ref_dist.isend(P.to_tensor([0.0]))):
        with pytest.raises(RuntimeError):
            call()
    op = dist.P2POp(dist.isend, t, dist.shift(1))
    with pytest.raises(RuntimeError, match="mesh axis"):
        dist.batch_isend_irecv([op])
    with pytest.raises(ValueError):
        dist.P2POp(dist.all_reduce, t, dist.shift(1))
    axis = dist.new_group(axis="dp")
    for call in (lambda: dist.all_reduce(t, group=axis),
                 lambda: dist.get_rank(axis), lambda: axis.nranks,
                 lambda: dist.ppermute(t, [(0, 1)]),
                 lambda: dist.batch_isend_irecv(
                     [dist.P2POp(dist.isend, t, dist.shift(1), axis)])):
        with pytest.raises(NotImplementedError, match="A.4"):
            call()
    with pytest.raises(ValueError, match="ReduceOp"):
        dist.all_reduce(t, op="median")


def test_store_rounds_reap_and_reset_on_reconfigure(monkeypatch):
    """Rank 0 of a 3-member world over an in-process store, its peers'
    keys set by hand: allgathers and a broadcast read them, the third
    round's allgather reaps rounds 1 and 2 (the broadcast's too), a get
    that waits on a rank the watchdog holds DEAD raises CollectiveTimeout
    naming it, and reconfigure resets the round counters."""
    import pickle
    client = fleet.LocalKVClient()
    fleet._reset_for_tests()
    collective.reset_coord_rounds()
    monkeypatch.setattr(fleet, "_config", fleet.FleetConfig(kv_slice_s=0.05))
    try:
        fleet.install_client(client)
        fleet._set_world(fleet.WorldView(range(3), 0, launch_id="rounds"))
        ns = fleet.coord_namespace()

        def peer(key, value):
            fleet.kv_set_bytes(client, f"{ns}/{key}",
                               pickle.dumps(torch.tensor([value])))

        for rnd in (1, 3):
            peer(f"allgather/{rnd}/1", 1.0)
            peer(f"allgather/{rnd}/2", 2.0)
        peer("bcast/2/1", 7.0)
        peer("allgather/4/1", 1.0)
        t = torch.tensor([0.0])
        dist.all_reduce(t)
        assert t.tolist() == [3.0]
        b = torch.tensor([0.0])
        dist.broadcast(b, src=1)
        assert b.tolist() == [7.0]
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        assert t.tolist() == [3.0]
        assert collective._COORD_REAPED[0] == 2
        for gone in ("allgather/1/", "allgather/2/", "bcast/2/"):
            assert client.key_value_dir_get(f"{ns}/{gone}") == [], gone
        assert len(client.key_value_dir_get(f"{ns}/allgather/3/")) == 3

        class Dead:
            def is_dead(self, rank):
                return rank == 2

        fleet.install_monitor(Dead())
        with pytest.raises(fleet.CollectiveTimeout) as ei:
            dist.all_reduce(t)
        assert ei.value.missing_rank == 2
        assert ei.value.to_dict()["verdict"] == "dead-verdict"
        fleet.install_monitor(None)
        fleet.kv_set_bytes(client, "ptpu/rounds/g1/fleet/join/1", b"[0, 1]")
        fleet.reconfigure([2], client=client)
        assert collective._COORD_ROUND[0] == 0
        assert fleet.world().size == 2
    finally:
        fleet._reset_for_tests()
        collective.reset_coord_rounds()


def test_elastic_command_shares_the_reference_file():
    from paddle_tpu.distributed import elastic as ref_elastic
    name = f"torchtest{os.getpid()}"
    port, ref = dist.Command(name=name), ref_elastic.Command(name=name)
    assert port.path == ref.path
    try:
        assert port.scale_np(4) is False and ref.scale_np(4) is False
        port.set_np(3)
        assert ref._read() == {"np": 3}
        assert ref.scale_np(2) is True and port._read() == {"np": 2}
    finally:
        port.clean()
    assert not os.path.exists(ref.path)
    port.clean()                                  # idempotent


# -------------------------------------------------------- processes
def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(nnodes, script, args, launch_id, extra_env=None):
    env = {**os.environ, "PYTHONPATH": ROOT, "TORCH_CPP_LOG_LEVEL": "ERROR",
           "PADDLE_LAUNCH_ID": launch_id, **FLEET_ENV, **(extra_env or {})}
    for k in ("PADDLE_MASTER", "PADDLE_NNODES", "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    port = _free_port()
    return {r: subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--master", f"127.0.0.1:{port}", "--nnodes", str(nnodes),
         "--rank", str(r), script, *map(str, args)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(nnodes)}


def _collect(procs, expect_killed=()):
    """Every child's output under one deadline; kills them all after."""
    outs = {}
    deadline = time.monotonic() + DEADLINE_S
    try:
        for r, p in procs.items():
            try:
                outs[r] = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} still running after {DEADLINE_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in procs.items():
        want = -signal.SIGKILL if r in expect_killed else 0
        assert p.returncode == want, (r, p.returncode, outs[r][-2000:])
    return outs


def _read(path, outs, r):
    assert path.exists(), (path.name, outs[r][-2000:])
    return json.loads(path.read_text())


def _expected_ops(n):
    """What the reference's eager path gives every rank (numpy)."""
    t = np.array([[r + 1.0, 10.0 * (r + 1)] for r in range(n)], np.float32)
    return {"all_reduce_SUM": t.sum(0), "all_reduce_MAX": t.max(0),
            "all_reduce_MIN": t.min(0), "all_reduce_PROD": t.prod(0),
            "all_reduce_AVG": t.mean(0), "reduce": t.sum(0),
            "all_gather": [[r] for r in range(n)],
            "broadcast": [100.0 + n - 1]}


@pytest.mark.parametrize("nnodes", [2, 3])
def test_every_operation_across_launched_processes(tmp_path, nnodes):
    procs = _launch(nnodes, WORKER, [tmp_path, "cpu", "ops"], f"ops{nnodes}")
    outs = _collect(procs)
    want = _expected_ops(nnodes)
    for r in range(nnodes):
        res = _read(tmp_path / f"ops-rank{r}.json", outs, r)
        assert res["nprocs"] == nnodes and res["world"] == [r, nnodes]
        for key in ("all_reduce_SUM", "all_reduce_MAX", "all_reduce_MIN",
                    "all_reduce_PROD", "all_reduce_AVG", "reduce"):
            np.testing.assert_allclose(res[key], want[key], rtol=1e-6,
                                       err_msg=key)
        assert res["all_gather"] == want["all_gather"]
        assert res["broadcast"] == want["broadcast"]
        # local on the reference's eager path, and so here
        mine = [np.full(2, 10.0 * r + i) for i in range(nnodes)]
        assert res["all_gather_object"] == [{"rank": r}]
        assert res["reduce_scatter"] == list(np.concatenate(mine))
        assert res["scatter"] == list(mine[0])
        assert res["alltoall"] == [list(m) for m in mine]
        assert res["all_to_all_single"] == list(np.concatenate(mine))
        assert "mesh axis" in res["send"]
    if nnodes == 2:     # the reference's two-process contract
        for r in range(2):
            res = json.loads((tmp_path / f"ops-rank{r}.json").read_text())
            assert res["all_reduce_SUM"] == [3.0, 30.0]
            assert res["all_gather"] == [[0], [1]]
            assert res["broadcast"] == [101.0]


def test_sigkill_reconfigure_resume_equals_the_baseline(tmp_path):
    out_dir, ckpt_dir = tmp_path / "out", tmp_path / "ckpt"
    out_dir.mkdir()
    args = [ckpt_dir, KILL_RANK, KILL_STEP, CKPT_STEP, TOTAL_STEPS]
    outs = _collect(_launch(3, WORKER, [out_dir, "cpu", "chaos", *args],
                            "chaosA"), expect_killed={KILL_RANK})
    chaos = {r: _read(out_dir / f"chaos-rank{r}.json", outs, r)
             for r in (0, 1)}
    assert not (out_dir / f"chaos-rank{KILL_RANK}.json").exists()
    for res in chaos.values():
        det = res["detection"]
        assert det is not None and det["missing_rank"] == KILL_RANK, det
        assert det["waited_s"] <= float(FLEET_ENV["PTPU_FLEET_TIMEOUT_S"]) \
            + 1.0, det
        assert det["verdict"] in ("dead-verdict", "deadline"), det
        nw = res["new_world"]
        assert nw["size"] == 2 and nw["members"] == [0, 1], nw
        assert nw["generation"] == 1 and res["reshard_ok"] is True
        assert res["final_world"]["size"] == 2
        assert len(res["losses_resumed"]) == TOTAL_STEPS - CKPT_STEP
    assert chaos[0]["losses_resumed"] == chaos[1]["losses_resumed"]

    outs = _collect(_launch(2, WORKER, [out_dir, "cpu", "baseline", *args],
                            "chaosB"))
    base = {r: _read(out_dir / f"baseline-rank{r}.json", outs, r)
            for r in (0, 1)}
    assert base[0]["losses_resumed"] == base[1]["losses_resumed"]
    assert chaos[0]["losses_resumed"] == base[0]["losses_resumed"]


def test_digest_vote_names_the_corrupt_rank(tmp_path):
    outs = _collect(_launch(3, SENTINEL_WORKER,
                            [tmp_path, SDC_RANK, SDC_STEP, SDC_TOTAL],
                            "sentinelA"))
    res = {r: _read(tmp_path / f"vote-rank{r}.json", outs, r)
           for r in range(3)}
    for r in range(3):
        vote = res[r]["vote"]
        assert vote is not None, r
        assert vote["suspects"] == [SDC_RANK] and vote["step"] == SDC_STEP
        assert vote["self_suspect"] == (r == SDC_RANK)
    assert res[SDC_RANK]["exited_as_suspect"] is True
    assert res[SDC_RANK]["new_world"] is None
    for r in (0, 1):
        assert res[r]["monitor_suspects"] == [SDC_RANK]
        nw = res[r]["new_world"]
        assert nw["members"] == [0, 1] and nw["generation"] == 1
        assert res[r]["final_world"]["size"] == 2
        assert len(res[r]["losses_resumed"]) == SDC_TOTAL - SDC_STEP
        assert all(np.isfinite(v) for v in res[r]["losses_resumed"])
    assert res[0]["losses_resumed"] == res[1]["losses_resumed"]
