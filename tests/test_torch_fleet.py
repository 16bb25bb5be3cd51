"""paddle_tpu_torch.resilience.fleet, the launcher's coordination store and
the fleet's remainders, against paddle_tpu.resilience.fleet on the CPU.

Every store contract of tests/test_fleet.py runs over both coordination
clients: the in-process ``LocalKVClient`` and ``StoreKVClient`` on a
localhost ``torch.distributed.TCPStore``: blocking gets and their
deadlines, directory gets and prefix deletes, the 2-byte pad, values
past the server's 8 MiB message limit, the heartbeat ladder, the
quorum checkpoint with its reshard and torn-entry fallback, and
reconfigure. Beside them: the watchdog's verdicts equal the reference
monitor's on the same beats, the checkpoint's MANIFEST keys and shard
sha256s equal the reference's for the same numpy inputs, a digest vote
names a planted bitflip's rank with the reference's vote dict, the
clock handshake's offsets, the launcher's rendezvous (real, and its
retry), ``rank_kill`` and ``wedge`` on child processes, and the elastic
watchdog and progress beats (optimizer, gradient merge, preemption
drain).
"""
import datetime
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.resilience import fleet as ref_fleet
from paddle_tpu.resilience import sentinel as ref_sentinel

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import resilience as TR
from paddle_tpu_torch.distributed import elastic
from paddle_tpu_torch.distributed import launch as L
from paddle_tpu_torch.distributed.launch import StoreKVClient
from paddle_tpu_torch.observability import fleettrace
from paddle_tpu_torch.resilience import (faultinject, fleet, preemption,
                                         sentinel)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = ("local", "store")


@pytest.fixture(autouse=True)
def _fleet_reset():
    fleet._reset_for_tests()
    ref_fleet._reset_for_tests()
    yield
    fleet._reset_for_tests()
    ref_fleet._reset_for_tests()


def _store():
    from torch.distributed import TCPStore
    return TCPStore("127.0.0.1", 0, 1, True,
                    timeout=datetime.timedelta(seconds=30),
                    wait_for_workers=False)


def _kv(kind):
    return fleet.LocalKVClient() if kind == "local" \
        else StoreKVClient(_store())


def _cfg(**kw):
    kw.setdefault("collective_timeout_s", 0.5)
    kw.setdefault("kv_slice_s", 0.05)
    kw.setdefault("heartbeat_interval_s", 0.05)
    kw.setdefault("rendezvous_timeout_s", 1.0)
    return fleet.FleetConfig(**kw)


def _wv(members, me):
    return fleet.WorldView(members, me)


def _threads(fn, args):
    errs = []

    def run(*a):
        try:
            fn(*a)
        except BaseException as e:          # surfaced by the test
            errs.append((a, e))

    ts = [threading.Thread(target=run, args=a) for a in args]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs, errs


# ----------------------------------------------------------- the store
@pytest.mark.parametrize("kind", CLIENTS)
def test_kv_blocking_dir_delete_and_pad(kind):
    kv = _kv(kind)
    kv.key_value_set_bytes("a/x", b"hello")
    assert kv.blocking_key_value_get_bytes("a/x", 10) == b"hello"
    with pytest.raises(TimeoutError):
        kv.blocking_key_value_get_bytes("a/missing", 30)
    t = threading.Timer(0.05, lambda: kv.key_value_set_bytes("a/y", b"vv"))
    t.start()
    assert kv.blocking_key_value_get_bytes("a/y", 2000) == b"vv"
    t.join()
    kv.key_value_set("ns/hb/0", "1")
    kv.key_value_set("ns/hb/1", "2")
    with pytest.raises(ValueError):
        kv.key_value_set("ns/hb/0", "x")              # no overwrite
    kv.key_value_set("ns/hb/0", "3", allow_overwrite=True)
    assert kv.key_value_dir_get("ns/hb/") == [("ns/hb/0", "3"),
                                              ("ns/hb/1", "2")]
    assert kv.blocking_key_value_get("ns/hb/1", 10) == "2"
    kv.key_value_delete("ns")                         # directory reap
    assert kv.key_value_dir_get("ns/") == []
    assert kv.key_value_dir_get_bytes("a/") == [("a/x", b"hello"),
                                                ("a/y", b"vv")]
    fleet.kv_set_bytes(kv, "w/flag", b"k")
    assert kv.blocking_key_value_get_bytes("w/flag", 10) == b"k\x00"


def test_store_values_past_the_message_limit_round_trip():
    """TCPStore's server refuses a message over 8 MiB; a page handoff of
    a long request is ~180 MB. Chunked under the key, read back whole,
    listed once and reaped with it."""
    store = _store()
    kv = StoreKVClient(store)
    blob = np.random.default_rng(0).integers(
        0, 256, 20 << 20, dtype=np.uint8).tobytes()
    fleet.kv_set_bytes(kv, "ns/handoff/h0", blob)
    assert fleet.kv_get_bytes(kv, "ns/handoff/h0", 5.0,
                              config=_cfg()) == blob
    assert [k for k, _ in kv.key_value_dir_get_bytes("ns/")] == \
        ["ns/handoff/h0"]
    assert len(store.list_keys()) > 2                 # the chunks
    kv.key_value_delete("ns/handoff/h0")
    assert not [k for k in store.list_keys() if k.startswith("ns/")]


@pytest.mark.parametrize("kind", CLIENTS)
def test_kv_get_bytes_deadline_abort_and_late_value(kind):
    kv = _kv(kind)
    t0 = time.monotonic()
    with pytest.raises(fleet.CollectiveTimeout) as ei:
        fleet.kv_get_bytes(kv, "w/never", 0.3, missing_rank=2,
                           config=_cfg())
    assert 0.25 <= time.monotonic() - t0 < 2.0
    d = ei.value.to_dict()
    assert (d["missing_rank"], d["verdict"], d["timeout_s"], d["site"]) \
        == (2, "deadline", 0.3, "fleet.kv_get")
    assert isinstance(ei.value.__cause__, TimeoutError)
    t = threading.Timer(0.1, lambda: kv.key_value_set_bytes("w/late",
                                                            b"ok!"))
    t.start()
    assert fleet.kv_get_bytes(kv, "w/late", 5.0, config=_cfg()) == b"ok!"
    t.join()
    t0 = time.monotonic()
    with pytest.raises(fleet.CollectiveTimeout) as ei:
        fleet.kv_get_bytes(kv, "w/never", 30.0, missing_rank=1,
                           abort_if=lambda: True, config=_cfg())
    assert time.monotonic() - t0 < 1.0
    assert ei.value.verdict == "dead-verdict"
    # data a peer published before dying is still returned
    kv.key_value_set_bytes("w/posthumous", b"durable")
    assert fleet.kv_get_bytes(kv, "w/posthumous", 5.0, missing_rank=1,
                              abort_if=lambda: True,
                              config=_cfg()) == b"durable"
    plan = TR.FaultPlan([TR.FaultSpec("fleet.kv_get", "exception", at=1)])
    with TR.FaultInjector(plan) as inj:
        assert fleet.kv_get_bytes(kv, "w/late", 1.0, config=_cfg()) == \
            b"ok!"
        with pytest.raises(TR.WorkerFault):
            fleet.kv_get_bytes(kv, "w/late", 1.0, config=_cfg())
    assert [(s, o) for s, _, o in inj.injected] == [("fleet.kv_get", 1)]


# ----------------------------------------------------------- heartbeats
def _hb_key(rank):
    return f"{fleet.coord_namespace()}/fleet/hb/{rank}"


@pytest.mark.parametrize("kind", CLIENTS)
def test_publisher_beats_progress_and_fault(kind):
    kv = _kv(kind)
    pub = fleet.HeartbeatPublisher(client=kv, rank=3, interval_s=10.0)
    assert pub.publish_once()
    pub.beat()
    pub.beat()
    assert pub.publish_once()
    payload = json.loads(kv.blocking_key_value_get_bytes(_hb_key(3), 10))
    assert (payload["seq"], payload["progress"]) == (2, 2)
    plan = TR.FaultPlan([TR.FaultSpec("fleet.heartbeat", "exception",
                                      at=1)])
    with TR.FaultInjector(plan):
        assert pub.publish_once() is True
        assert pub.publish_once() is False     # skipped, thread survives
        assert pub.publish_once() is True
    assert pub.missed_beats == 1 and pub.seq == 4
    pub = fleet.HeartbeatPublisher(client=kv, rank=7,
                                   interval_s=0.02).start()
    deadline = time.monotonic() + 5.0
    while pub.seq < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    for _ in range(50):
        pub.beat()                     # progress never wakes the thread
    pub.stop()
    at_stop = pub.seq
    assert at_stop >= 3 and pub.progress == 50 and pub._thread is None
    pub.start()                        # restartable
    while pub.seq < at_stop + 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    pub.stop()
    assert pub.seq >= at_stop + 2


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _ladder(pkg, kv, beat):
    """One watchdog script: beats, silence, a stalled progress counter,
    a quarantine, a boot hold; returns every poll's states."""
    clock = _Clock()
    cfg = pkg.FleetConfig(collective_timeout_s=0.5, kv_slice_s=0.05,
                          heartbeat_interval_s=1.0, suspect_after_s=3.0,
                          dead_after_s=6.0, rendezvous_timeout_s=1.0,
                          progress_timeout_s=5.0)
    wv = pkg.WorldView((0, 1, 2, 3), 0)
    deaths = []
    mon = pkg.FleetMonitor(client=kv, config=cfg, world_fn=lambda: wv,
                           time_fn=clock, on_dead=deaths.append)
    out = [mon.poll()]                       # grace from first look
    for step in range(1, 9):
        for r in (0, 1, 2):
            if r == 2 and step > 2:
                continue                     # rank 2 goes silent
            beat(kv, pkg, r, step, progress=step if r != 1 else 1)
        clock.t += 2.0
        if step == 3:
            mon.hold_verdict(3, 5.0)
        if step == 5:
            mon.mark_suspect(0, reason="vote")
        if step == 6:
            mon.release_verdict_hold(3)
        out.append(mon.poll())
    beat(kv, pkg, 2, 99)                     # DEAD is terminal
    clock.t += 0.1
    out.append(mon.poll())
    return ([{r: s.name for r, s in st.items()} for st in out], deaths,
            mon.dead_ranks(), mon.quarantined_ranks())


def _beat(kv, pkg, rank, seq, progress=0):
    pkg.kv_set_bytes(kv, f"{pkg.coord_namespace()}/fleet/hb/{rank}",
                     json.dumps({"seq": seq, "t": 0.0,
                                 "progress": progress}).encode())


@pytest.mark.parametrize("kind", CLIENTS)
def test_monitor_ladder_equals_the_reference(kind):
    got = _ladder(fleet, _kv(kind), _beat)
    want = _ladder(ref_fleet, ref_fleet.LocalKVClient(), _beat)
    assert got == want
    states, deaths, dead, quarantined = got
    # 1 beats with frozen progress; 3 never beats but was held until
    # step 6, whose release restarts its staleness clock
    assert states[-1] == {0: "SUSPECT", 1: "SUSPECT", 2: "DEAD",
                          3: "SUSPECT"}
    assert deaths == [[2]] and dead == [2] and quarantined == [0]
    text = obs.export.prometheus_text()
    assert 'fleet_rank_state{rank="2"} 2' in text
    assert "fleet_last_heartbeat_age_s" in text


def test_monitor_outage_holds_verdicts_and_telemetry_rides():
    kv = fleet.LocalKVClient()
    clock = _Clock()
    mon = fleet.FleetMonitor(
        client=kv, config=_cfg(heartbeat_interval_s=1.0,
                               suspect_after_s=3.0, dead_after_s=6.0),
        world_fn=lambda: _wv((0, 1), 0), time_fn=clock)
    pub = fleet.HeartbeatPublisher(
        client=kv, rank=1, interval_s=10.0,
        payload_fn=lambda: {"queue_depth": 3, "health": 1})
    pub.publish_once()
    _beat(kv, fleet, 0, 1)
    mon.poll()
    assert mon.telemetry(1) == {"queue_depth": 3, "health": 1}
    assert mon.telemetry(0) is None
    real = kv.key_value_dir_get_bytes
    kv.key_value_dir_get_bytes = lambda p: (_ for _ in ()).throw(
        RuntimeError("UNAVAILABLE"))
    for _ in range(5):
        clock.t += 4.0
        states = mon.poll()
    assert set(states.values()) == {fleet.RankState.HEALTHY}
    kv.key_value_dir_get_bytes = real
    mon.start()
    time.sleep(0.05)
    mon.stop()
    assert mon._thread is None


# ------------------------------------------------ distributed checkpoints
def _save_3rank(kv, path, step=10, keep=3, pkg=fleet):
    cks = {}

    def run(r):
        ck = pkg.DistributedCheckpointer(
            str(path), keep=keep, client=kv,
            world=pkg.WorldView([0, 1, 2], r), timeout_s=10.0)
        cks[r] = ck
        ck.save(step, sharded={"rows": np.full((2, 2), r, np.int64)},
                replicated={"w": np.arange(3.0)} if r == 0 else None)

    _threads(run, [(r,) for r in range(3)])
    return cks


def _entry(path):
    man = json.load(open(os.path.join(path, "MANIFEST.json")))
    return man, [{k: v for k, v in c.items() if k != "time_utc"}
                 for c in man["checkpoints"]]


@pytest.mark.parametrize("kind", CLIENTS)
def test_quorum_checkpoint_reshards_and_equals_the_reference(kind,
                                                             tmp_path):
    cks = _save_3rank(_kv(kind), tmp_path / "port")
    _save_3rank(ref_fleet.LocalKVClient(), tmp_path / "ref",
                pkg=ref_fleet)
    man, entries = _entry(tmp_path / "port")
    ref_man, ref_entries = _entry(tmp_path / "ref")
    # the same numpy inputs give the reference's shard bytes and digests
    assert entries == ref_entries and man.keys() == ref_man.keys()
    assert man["format"] == "fleet-1"
    (entry,) = man["checkpoints"]
    assert sorted(entry) == sorted(ref_man["checkpoints"][0])
    assert len({s["sha256"] for s in entry["shards"]}) == 3
    for new_rank, want in ((0, [0, 0, 1]), (1, [1, 2, 2])):
        step, state = cks[0].load(world_size=2, rank=new_rank)
        assert step == 10 and state["world_size"] == 3
        np.testing.assert_array_equal(state["sharded"]["rows"][:, 0], want)
        np.testing.assert_array_equal(state["replicated"]["w"],
                                      np.arange(3.0))
    with pytest.raises(ValueError, match="reshard"):
        cks[0].load(world_size=4)


@pytest.mark.parametrize("kind", CLIENTS)
def test_torn_shard_falls_back_and_rounds_are_reaped(kind, tmp_path):
    kv = _kv(kind)
    cks = _save_3rank(kv, tmp_path)

    def resave(r):
        cks[r].save(20, sharded={"rows": np.full((2, 2), 10 + r,
                                                 np.int64)},
                    replicated={"w": np.arange(3.0) * 2} if r == 0
                    else None)

    _threads(resave, [(r,) for r in range(3)])
    rounds = {k.split("/fleet/ckpt/")[1].split("/")[0] for k, _ in
              kv.key_value_dir_get("ptpu/local/g0/fleet/ckpt/")}
    assert rounds == {"r2"}              # round 1's keys reaped
    shard = tmp_path / "step-00000020" / "shard-00001-of-00003.pkl"
    shard.write_bytes(shard.read_bytes()[:100])
    step, state = cks[0].load(world_size=1, rank=0)
    assert step == 10
    np.testing.assert_array_equal(state["replicated"]["w"], np.arange(3.0))
    assert cks[0].load(step=20) is None
    with pytest.raises(TR.CheckpointCorruption):
        cks[0].load(step=20, strict=True)
    ck = fleet.DistributedCheckpointer(str(tmp_path / "one"), keep=2,
                                       world=_wv([0], 0))
    ck.save(1, replicated={"v": torch.tensor([1.0])})
    with TR.FaultInjector(TR.FaultPlan([TR.FaultSpec("io.save",
                                                     "torn_write")])):
        ck.save(2, replicated={"v": 2.0})
    step, state = ck.load()
    assert step == 1 and state["replicated"]["v"].tolist() == [1.0]
    for s in (3, 4):
        ck.save(s, replicated={"s": s})
    assert ck.steps() == [3, 4]
    t0 = time.monotonic()
    with pytest.raises(fleet.CollectiveTimeout) as ei:
        fleet.DistributedCheckpointer(
            str(tmp_path / "gone"), client=kv, world=_wv([0, 1, 2, 3], 0),
            timeout_s=0.4).save(1, replicated={"v": 1.0})
    assert ei.value.missing_rank == 1 and time.monotonic() - t0 < 1.5


# --------------------------------------------------------- reconfigure
@pytest.mark.parametrize("kind", CLIENTS)
def test_reconfigure_reforms_reaps_and_refuses_split_brain(kind):
    kv = _kv(kind)
    kv.key_value_set_bytes("ptpu/local/g0/allgather/7/2", b"zz")
    out = {}

    def run(gr):
        out[gr] = fleet.reconfigure([1], client=kv, config=_cfg(),
                                    world_view=_wv([0, 1, 2], gr),
                                    install=False, reap=True)

    _threads(run, [(0,), (2,)])
    assert out[0].members == (0, 2) == out[2].members
    assert (out[0].rank, out[2].rank, out[0].generation) == (0, 1, 1)
    assert kv.key_value_dir_get("ptpu/local/g0/") == []
    assert len(kv.key_value_dir_get("ptpu/local/g1/fleet/join/")) == 2
    with pytest.raises(fleet.CollectiveTimeout) as ei:
        fleet.reconfigure([1], client=kv,
                          config=_cfg(rendezvous_timeout_s=0.3),
                          world_view=fleet.WorldView([0, 1, 2, 3], 0,
                                                     generation=3),
                          install=False)
    assert ei.value.missing_rank == 2
    errs = {}

    def diverge(gr, dead):
        try:
            fleet.reconfigure(dead, client=kv, config=_cfg(),
                              world_view=fleet.WorldView(
                                  [0, 1, 2, 3], gr, generation=5),
                              install=False)
            errs[gr] = None
        except Exception as e:
            errs[gr] = e

    _threads(diverge, [(0, [2, 3]), (1, [3]), (2, [3])])
    assert any("split-brain" in str(e) for e in errs.values()), errs
    with pytest.raises(ValueError):
        fleet.reconfigure([0], client=kv, world_view=_wv([0, 1], 0),
                          install=False)
    fleet._set_world(fleet.WorldView([0, 1, 2, 3, 4], 0))
    t0 = time.monotonic()
    fleet.finalize(timeout_s=0.4, client=kv)   # 4 dead peers, one deadline
    assert time.monotonic() - t0 < 1.5


@pytest.mark.parametrize("kind", CLIENTS)
def test_elastic_detect_reconfigure_resume_threads(kind, tmp_path):
    """3 rank-threads save a quorum checkpoint with heartbeats running;
    rank 1's publisher dies, the survivors reach a DEAD verdict,
    reconfigure to world size 2 and reload the checkpoint resharded."""
    kv = _kv(kind)
    cfg = _cfg(heartbeat_interval_s=0.03, suspect_after_s=0.12,
               dead_after_s=0.25, rendezvous_timeout_s=5.0,
               collective_timeout_s=5.0)
    results = {}
    barrier = threading.Barrier(3, timeout=20)

    def run(gr):
        wv = _wv([0, 1, 2], gr)
        pub = fleet.HeartbeatPublisher(
            client=kv, rank=gr, interval_s=cfg.heartbeat_interval_s).start()
        ck = fleet.DistributedCheckpointer(str(tmp_path), client=kv,
                                           world=wv, timeout_s=5.0)
        ck.save(3, sharded={"m": np.full((2,), gr, np.int64)},
                replicated={"w": np.arange(4.0)} if gr == 0 else None)
        barrier.wait()
        if gr == 1:
            pub.stop()                  # the dying rank
            return
        mon = fleet.FleetMonitor(client=kv, config=cfg,
                                 world_fn=lambda: wv)
        deadline = time.monotonic() + 15.0
        while 1 not in mon.dead_ranks():
            assert time.monotonic() < deadline, "no DEAD verdict"
            mon.poll()
            time.sleep(0.02)
        new_wv = fleet.reconfigure(mon.dead_ranks(), client=kv,
                                   config=cfg, world_view=wv,
                                   install=False)
        results[gr] = (new_wv, *ck.load(world_size=new_wv.size,
                                        rank=new_wv.rank))
        pub.stop()

    _threads(run, [(gr,) for gr in range(3)])
    assert set(results) == {0, 2}
    for new_wv, step, state in results.values():
        assert new_wv.members == (0, 2) and step == 3
        np.testing.assert_array_equal(state["replicated"]["w"],
                                      np.arange(4.0))
        np.testing.assert_array_equal(
            state["sharded"]["m"], [0, 0, 1] if new_wv.rank == 0
            else [1, 2, 2])


# ------------------------------------------- digest vote, clock handshake
def test_digest_vote_names_the_bitflip_rank_as_the_reference():
    rng = np.random.default_rng(5)
    grads = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    spec = TR.FaultSpec("optimizer.grads", "bitflip")
    bad = {"w": faultinject.corrupt_array(spec, torch.tensor(grads["w"]),
                                          seed=0).numpy()}
    trees = {0: grads, 1: grads, 2: bad}

    def votes(pkg, sent, client, to_tree):
        out = {}
        mons = {}

        def run(gr):
            wv = pkg.WorldView([0, 1, 2], gr)
            mons[gr] = pkg.FleetMonitor(client=client, config=pkg.FleetConfig(
                collective_timeout_s=5.0, heartbeat_interval_s=1.0),
                world_fn=lambda: wv)
            out[gr] = sent.digest_vote(to_tree(trees[gr]), step=4,
                                       client=client, world_view=wv,
                                       monitor=mons[gr])

        _threads(run, [(gr,) for gr in range(3)])
        return ({gr: v.to_dict() for gr, v in out.items()},
                {gr: m.quarantined_ranks() for gr, m in mons.items()})

    got, quarantined = votes(fleet, sentinel, StoreKVClient(_store()),
                             lambda t: {k: torch.tensor(v)
                                        for k, v in t.items()})
    want, _ = votes(ref_fleet, ref_sentinel, ref_fleet.LocalKVClient(),
                    lambda t: t)
    assert got == want
    for gr in range(3):
        assert got[gr]["suspects"] == [2]
        assert got[gr]["self_suspect"] == (gr == 2)
        assert quarantined[gr] == [2]
    with pytest.raises(RuntimeError, match="client"):
        sentinel.digest_vote("abc", step=1, world_view=_wv([0, 1], 0))


@pytest.mark.parametrize("kind", CLIENTS)
def test_clock_handshake_offsets_and_armed_spool(kind, tmp_path):
    kv = _kv(kind)
    evs = {}
    _threads(lambda r: evs.__setitem__(r, fleettrace.clock_handshake(
        kv, r, namespace="ns")), [(1,), (0,), (2,)])
    assert evs[0]["offset_ns"] == 0 and evs[0]["rtt_ms"] == 0.0
    for r in (1, 2):
        # one process, one perf clock and one wall clock: the offset is
        # their drift between the two anchors, well under a millisecond
        assert abs(evs[r]["offset_ns"]) < 1e6
        assert evs[r]["ref_rank"] == 0 and evs[r]["rtt_ms"] >= 0
    assert sorted(evs[1]) == sorted(
        ref_fleettrace_event(tmp_path))
    spool = fleettrace.arm_spool(str(tmp_path / "spool"), rank=1,
                                 client=kv, namespace="ns")
    try:
        with obs.span("fleet.test"):
            pass
    finally:
        fleettrace.disarm()
    (proc,) = fleettrace.merge_spools(str(tmp_path / "spool")).processes
    assert proc.clock["offset_ns"] is not None and proc.rank == 1
    assert spool.rank == 1


def ref_fleettrace_event(tmp_path):
    from paddle_tpu.observability import fleettrace as ref_ft
    return ref_ft.clock_handshake(ref_fleet.LocalKVClient(), 0,
                                  namespace="ns")


# -------------------------------------------------------- the launcher
def test_launcher_rendezvous_real_and_retried(monkeypatch):
    from torch.distributed import TCPStore
    probe = TCPStore("127.0.0.1", 0, 1, True, wait_for_workers=False)
    port = probe.port
    del probe
    stores = {}
    _threads(lambda r: stores.__setitem__(
        r, L._rendezvous(f"127.0.0.1:{port}", 2, r)), [(0,), (1,)])
    kv = StoreKVClient(stores[1])
    kv.key_value_set("x/y", "z")
    assert StoreKVClient(stores[0]).key_value_dir_get("x/") == \
        [("x/y", "z")]
    calls = []

    def refuse(*a):
        calls.append(a)
        raise RuntimeError("connection refused")

    monkeypatch.setattr(L, "_connect", refuse)
    monkeypatch.setenv("PTPU_RENDEZVOUS_ATTEMPTS", "2")
    monkeypatch.setenv("PTPU_RENDEZVOUS_TIMEOUT_S", "30")
    with pytest.raises(RuntimeError, match="configuration error"):
        L._rendezvous("127.0.0.1:1", 2, 1)
    assert len(calls) == 2
    monkeypatch.setenv("PTPU_RENDEZVOUS_TIMEOUT_S", "0.5")
    with pytest.raises(fleet.CollectiveTimeout) as ei:
        L._rendezvous("127.0.0.1:1", 2, 1)
    assert (ei.value.site, ei.value.key) == ("launch.rendezvous",
                                             "127.0.0.1:1")
    with pytest.raises(ValueError, match="nnodes"):
        L.launch("127.0.0.1:1", 1, 0)
    assert L.launch() == (0, 1) and fleet.world().size == 1


# ----------------------------------------------- rank_kill and wedge
def _child(kind, at):
    code = (
        "from paddle_tpu_torch.resilience import faultinject as FI\n"
        "FI.install(FI.FaultInjector(FI.FaultPlan([FI.FaultSpec("
        f"'fleet.rank_kill', {kind!r}, at={at})])))\n"
        "for step in range(3):\n"
        "    FI.fire('fleet.rank_kill', step=step)\n"
        "    print('alive after step', step, flush=True)\n"
        "print('completed', flush=True)\n")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env={**os.environ,
                                            "PYTHONPATH": ROOT})


def _state(pid):
    with open(f"/proc/{pid}/stat") as f:
        return f.read().rsplit(")", 1)[1].split()[0]


def test_rank_kill_and_wedge_act_on_a_child_process():
    procs = [_child("rank_kill", 1), _child("wedge", 1)]
    try:
        out, _ = procs[0].communicate(timeout=60)
        assert procs[0].returncode == -9
        assert "alive after step 0" in out and "step 1" not in out
        deadline = time.monotonic() + 60
        while _state(procs[1].pid) != "T":       # stopped by SIGSTOP
            assert time.monotonic() < deadline, "wedge never stopped"
            time.sleep(0.05)
        procs[1].kill()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# ------------------------------------------ elastic beats and watchdog
def test_progress_beats_reach_the_publisher_and_watchdog():
    from paddle_tpu_torch import nn, optimizer
    kv = fleet.LocalKVClient()
    pub = fleet.install_publisher(
        fleet.HeartbeatPublisher(client=kv, rank=0, interval_s=10.0))
    stalls = []
    mgr = elastic.install_manager(elastic.ElasticManager(
        timeout=60.0, abort_on_stall=False))
    try:
        for _ in range(3):
            elastic.notify_progress()
        assert pub.progress == 3
        model = nn.Linear(4, 2, device="cpu")
        gm = optimizer.GradientMergeOptimizer(
            optimizer.SGD(learning_rate=0.1,
                          parameters=model.parameters()), k_steps=4)
        x = torch.randn(2, 4)
        for _ in range(4):
            gm.clear_grad()
            (model(x) ** 2).sum().backward()
            gm.step()
        assert pub.progress == 3 + 4           # one beat a merge step
        handler = TR.PreemptionHandler()
        before = pub.progress
        handler.drain(7)
        assert pub.progress == before + 2      # around the final save
    finally:
        mgr.stop()
        elastic.install_manager(None)
        preemption.uninstall()      # the handler installed itself
    wd = elastic.Watchdog(timeout=0.05, poll_interval=0.01,
                          on_stall=lambda idle, step: stalls.append(step))
    wd.beat(5)
    deadline = time.monotonic() + 5.0
    while not stalls and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert stalls == [5]
