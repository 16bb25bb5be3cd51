"""paddle_tpu_torch.serving.fleet against the reference engine on shared
weights (gpt3_tiny, f32, CPU).

- the wire: an ordered lane whose consumed keys are deleted, typed errors
  raised again on the controller, the trace context in the envelope,
  ``SamplingParams`` across, and ``pack_state`` bit-exact (bf16 carried
  as its 16-bit patterns, int8 codes, f32 scales);
- the page handoff between two port engines over plain f32, int8 and
  bf16 pools: a request exported after its first token and imported
  finishes with the reference ``LLMEngine.generate``'s tokens (bf16:
  the port's own monolithic run), its stream exactly once, no program
  built on either side; a geometry or length mismatch raises, and a
  full decode side refuses with the state left retryable;
- rank-per-thread fleets (``ReplicaServer`` threads over
  ``StoreKVClient`` on a localhost TCPStore): remote serving and the
  disaggregated split equal the reference, ``age_s`` survives adoption,
  an expired deadline fires on the adopter, the ``ServingFleet``'s
  tokens equal the reference's through a mid-stream failover (exactly
  once) and through a parked replica's DEAD verdict with a warm respawn
  on the spare, the worker's traffic mode over two remote replicas, and
  the factory's claim bookkeeping;
- one real multi-process fleet: 4 fresh processes through
  ``python -m paddle_tpu_torch.distributed.launch`` (controller, two
  replicas, a spare; ``device: "cpu"``), ``rank_kill`` on a replica
  mid-decode: every request equals the monolithic port run and the
  reference engine, the respawn boots warm on the spare, the
  disaggregated run is exact, the spools merge onto rank 0's clock and
  the post-mortem names the dead rank's requests.

The reference's fleet (its AOT cache does not serialize on this CPU
backend) is never run; its plain engine is the yardstick.
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

import paddle_tpu as P
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny

from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed.launch import StoreKVClient
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import fleettrace
from paddle_tpu_torch.resilience import faultinject as R
from paddle_tpu_torch.resilience import fleet
from paddle_tpu_torch.serving.fleet import (DisaggregatedEngine,
                                            FleetServingConfig,
                                            RemoteEngineClient,
                                            RemoteReplicaError,
                                            ReplicaServer, ServingFleet,
                                            wire)
from paddle_tpu_torch.serving.router import RouterConfig
from paddle_tpu_torch.serving.scheduler import AdmissionRejected

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 16, 32))


@pytest.fixture(autouse=True)
def _fleet_reset():
    fleet._reset_for_tests()
    yield
    fleet._reset_for_tests()


@pytest.fixture(scope="module")
def models():
    P.seed(0)
    ref = RefGPT(ref_tiny())
    sd = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(), device="cpu")
    load_numpy_state_dict(port, sd)
    half = GPTForCausalLM(gpt3_tiny(), device="cpu", dtype=torch.bfloat16)
    load_numpy_state_dict(half, sd)
    return ref, port, half, sd


@pytest.fixture(scope="module")
def warm_cache(models, tmp_path_factory):
    """The port's AOT cache, filled once: replica boots load from it."""
    d = str(tmp_path_factory.mktemp("fleet_cache"))
    e = _engine(models[1], cache=d)
    e.warmup()
    e.shutdown()
    return d


def _engine(model, cache=None, **kw):
    return serving.LLMEngine(model, serving.EngineConfig(
        **{**ENGINE_KW, **kw}), device="cpu", program_cache=cache)


def _traffic(pkg, n=8, seed=7, max_new=6, deadline_s=None):
    rng = np.random.default_rng(seed)
    lens = [3, 7, 12, 5, 17, 2, 9, 4, 11, 6][:n]
    prompts = [[int(t) for t in rng.integers(1, 256, ln)] for ln in lens]
    sps = [pkg.SamplingParams(
        max_new_tokens=max_new, temperature=0.7 if i % 2 else 0.0,
        top_k=20 if i % 3 else 0, seed=i, deadline_s=deadline_s)
        for i in range(n)]
    return prompts, sps


def _reference(ref, n, max_new=6, **kw):
    """The reference engine's tokens for ``_traffic(n)``."""
    prompts, sps = _traffic(ref_serving, n, max_new=max_new)
    eng = ref_serving.LLMEngine(ref, ref_serving.EngineConfig(
        **{**ENGINE_KW, **kw}))
    out = [r.output_token_ids for r in eng.generate(prompts, sps)]
    eng.shutdown()
    return out


def _collector():
    rec = {"tokens": [], "fins": 0}

    def _stream(rid, tok, fin):
        if tok is not None:
            rec["tokens"].append(int(tok))
        if fin:
            rec["fins"] += 1

    return rec, _stream


def _fc(**kw):
    d = dict(collective_timeout_s=8.0, kv_slice_s=0.05,
             heartbeat_interval_s=0.3, suspect_after_s=1.2,
             dead_after_s=2.4, rendezvous_timeout_s=30.0)
    d.update(kw)
    return fleet.FleetConfig(**d)


def _store_kv():
    from torch.distributed import TCPStore
    return StoreKVClient(TCPStore("127.0.0.1", 0, 1, True,
                                  timeout=datetime.timedelta(seconds=30),
                                  wait_for_workers=False))


class _Cluster:
    """Rank-per-thread replicas over one store client: each rank runs a
    real ReplicaServer loop on a thread, beating inline (a parked loop
    goes silent, as a SIGSTOPped process does)."""

    def __init__(self, model, ranks, spares=(), cache=None, kv=None,
                 **engine_kw):
        self.kv = kv or _store_kv()
        self.fc = _fc()
        self.ranks = list(ranks) + list(spares)
        self.servers, self.threads = {}, {}
        for r in self.ranks:
            def factory(payload, r=r):
                return serving.LLMEngine(
                    model, serving.EngineConfig(**{**ENGINE_KW,
                                                   **engine_kw}),
                    device="cpu", program_cache=cache,
                    metrics_name=f"serving.fleet.r{r}")
            cell = {}
            pub = fleet.HeartbeatPublisher(
                client=self.kv, rank=r,
                interval_s=self.fc.heartbeat_interval_s,
                payload_fn=lambda cell=cell: cell["srv"].telemetry())
            srv = ReplicaServer(self.kv, r, factory, config=self.fc,
                                publisher=pub, inline_beats=True)
            cell["srv"] = srv
            self.servers[r] = srv
            t = threading.Thread(target=srv.serve, daemon=True)
            self.threads[r] = t
            t.start()
        self.monitor = fleet.FleetMonitor(
            client=self.kv, config=self.fc,
            world_fn=lambda: fleet.WorldView(self.ranks, self.ranks[0]))

    def proxy(self, rank):
        p = RemoteEngineClient(self.kv, rank,
                               namespace_fn=fleet.coord_namespace,
                               config=self.fc)
        p.call("boot", {}, timeout_s=self.fc.rendezvous_timeout_s)
        return p

    def serving_fleet(self, active, spares=()):
        return ServingFleet(
            self.kv, FleetServingConfig(active, spares,
                                        fleet_config=self.fc),
            router_config=RouterConfig(sleep=lambda s: None),
            monitor=self.monitor)

    def close(self):
        for srv in self.servers.values():
            srv.stop()
        for t in self.threads.values():
            t.join(timeout=1.0)        # a parked loop is left to wake
        self.monitor.stop()


# ------------------------------------------------------------------ wire
def test_wire_lane_errors_trace_and_sampling_params():
    kv = _store_kv()
    ns = "test/ns"
    wire.post_request(kv, ns, 3, 0, "ping", {"x": 1})
    m, p, ctx = wire.read_request(kv, ns, 3, 0, 1.0)
    assert (m, p, ctx) == ("ping", {"x": 1}, None)
    assert kv.key_value_dir_get_bytes(wire.req_key(ns, 3, 0)) == []
    wire.post_response(kv, ns, 3, 0, result={"rank": 3})
    assert wire.await_response(kv, ns, 3, 0, 1.0) == {"rank": 3}
    assert kv.key_value_dir_get_bytes(f"{ns}/") == []
    with obs.use_context(obs.TraceContext("rr-7-abc",
                                          parent_span_id="1a.2")):
        wire.post_request(kv, ns, 1, 0, "step", {})
    _m, _p, ctx = wire.read_request(kv, ns, 1, 0, 1.0)
    assert (ctx.trace_id, ctx.parent_span_id) == ("rr-7-abc", "1a.2")
    wire.post_response(kv, ns, 0, 0,
                       error=AdmissionRejected("no_slot", "full"))
    with pytest.raises(AdmissionRejected) as ei:
        wire.await_response(kv, ns, 0, 0, 1.0)
    assert ei.value.reason == "no_slot"
    wire.post_response(kv, ns, 0, 1, error=ValueError("bad geom"))
    with pytest.raises(ValueError, match="bad geom"):
        wire.await_response(kv, ns, 0, 1, 1.0)
    wire.post_response(kv, ns, 0, 2, error=RuntimeError("boom"))
    with pytest.raises(RemoteReplicaError, match="RuntimeError"):
        wire.await_response(kv, ns, 0, 2, 1.0)
    sp = serving.SamplingParams(max_new_tokens=9, temperature=0.5, top_k=11,
                                top_p=0.9, seed=4, deadline_s=2.5)
    assert wire.sp_to_dict(wire.sp_from_dict(wire.sp_to_dict(sp))) == \
        wire.sp_to_dict(sp)
    assert wire.sp_from_dict(wire.sp_to_dict(None)) is None


def test_pack_state_round_trip_is_bit_exact():
    g = torch.Generator().manual_seed(0)
    blocks = {"k": torch.randn(3, 2, 4, 8, generator=g).bfloat16(),
              "v_codes": torch.randint(-128, 128, (3, 2, 4, 8),
                                       dtype=torch.int8, generator=g),
              "v_scales": torch.rand(3, 2, generator=g),
              "n": np.arange(6, dtype=np.float32).reshape(2, 3)}
    state = {"prompt_token_ids": [1, 2, 3], "output_token_ids": [9],
             "streamed": 1, "age_s": 1.25, "arrival_index": -7, "len": 3,
             "sampling_params": {"max_new_tokens": 4},
             "geometry": {"page_size": 4, "dtype": "bfloat16"},
             "trace": {"trace_id": "t"}, "layers": [blocks, blocks]}
    back = wire.unpack_state(wire.pack_state(state))
    assert {k: v for k, v in back.items() if k != "layers"} == \
        {k: v for k, v in state.items() if k != "layers"}
    for blk in back["layers"]:
        for name, t in blocks.items():
            want = torch.as_tensor(t)
            assert blk[name].dtype == want.dtype
            bits = torch.int16 if want.dtype == torch.bfloat16 else None
            assert torch.equal(blk[name].view(bits) if bits else blk[name],
                               want.view(bits) if bits else want)


# ---------------------------------------------------------- page handoff
@pytest.mark.parametrize("pools", ["f32", "int8", "bf16"])
def test_page_handoff_equals_the_monolithic_run(models, pools):
    ref, port, half, _ = models
    kw = {"int8": dict(kv_cache_dtype="int8"),
          "bf16": dict(dtype=torch.bfloat16)}.get(pools, {})
    model = half if pools == "bf16" else port
    prompts, sps = _traffic(serving, 3)
    if pools == "bf16":      # no shared bf16 arithmetic: the port's own run
        want = [r.output_token_ids for r in
                _engine(model, **kw).generate(prompts, sps)]
    else:
        want = _reference(ref, 3, **kw)
    ea, eb = _engine(model, **kw), _engine(model, **kw)
    ea.warmup()
    eb.warmup()
    events = obs.recompile_log().count
    builds = (ea.metrics.compile_count, eb.metrics.compile_count)
    for p, sp, tokens in zip(prompts, sps, want):
        a_rec, a_stream = _collector()
        rid = ea.add_request(p, sp, stream=a_stream)
        while not any(r == rid and t is not None for r, t, _ in ea.step()):
            pass
        state = ea.export_page_state(rid)
        assert not ea.has_unfinished()          # released
        assert state["streamed"] == len(a_rec["tokens"]) >= 1
        if pools != "f32":                      # through the wire format
            state = wire.unpack_state(wire.pack_state(state))
        b_rec, b_stream = _collector()
        brid = eb.import_page_state(state, stream=b_stream)
        while not any(r == brid and f for r, _, f in eb.step()):
            pass
        assert eb.finished_requests.pop(brid).output_token_ids == tokens
        assert a_rec["tokens"] + b_rec["tokens"] == tokens
        assert b_rec["fins"] == 1
    assert obs.recompile_log().count == events, "the handoff built"
    assert (ea.metrics.compile_count, eb.metrics.compile_count) == builds


def test_import_rejects_mismatches_and_backpressure_is_retryable(models):
    _, port, _, _ = models
    ea = _engine(port)
    prompts, sps = _traffic(serving, 2)
    states = []
    for p, sp in zip(prompts, sps):
        rid = ea.add_request(p, sp)
        while not any(t is not None for _, t, _ in ea.step()):
            pass
        states.append(ea.export_page_state(rid))
    with pytest.raises(ValueError, match="geometry mismatch"):
        _engine(port, page_size=8).import_page_state(states[0])
    with pytest.raises(ValueError, match="cache length"):
        ea.import_page_state({**states[0], "len": states[0]["len"] + 1})
    with pytest.raises(ValueError, match="not running"):
        ea.export_page_state("req-99")
    eb = _engine(port, max_num_seqs=1)
    assert eb.import_page_state(states[0]) is not None
    with pytest.raises(AdmissionRejected) as ei:
        eb.import_page_state(states[1])
    assert ei.value.reason == "no_slot"
    while eb.has_unfinished():
        eb.step()
    assert eb.import_page_state(states[1]) is not None


def test_disaggregated_engine_equals_the_reference(models, warm_cache):
    ref, port, _, _ = models
    want = _reference(ref, 5)
    prompts, sps = _traffic(serving, 5)
    pre, dec = _engine(port, cache=warm_cache), _engine(port,
                                                        cache=warm_cache)
    d = DisaggregatedEngine(pre, dec, client=_store_kv())
    out = d.generate(prompts, sps)
    assert [r.tokens for r in out] == want
    assert d.handoffs == sum(r.finished_on == "decode" for r in out) >= 4
    assert d.handoff_bytes > 0
    assert pre.metrics.compile_count == dec.metrics.compile_count == 0


# ------------------------------------------------------ remote replicas
def test_remote_replicas_serve_adopt_expire_and_split(models, warm_cache):
    ref, port, _, _ = models
    c = _Cluster(port, [1, 2], cache=warm_cache)
    try:
        proxy = c.proxy(1)
        proxy.warmup()
        prompts, sps = _traffic(serving, 4)
        recs = {}
        for p, sp in zip(prompts, sps):
            rec, stream = _collector()
            recs[proxy.add_request(p, sp, stream=stream)] = rec
        while proxy.has_unfinished():
            proxy.step()
        got = [proxy.finished_requests[rid].output_token_ids for rid in recs]
        assert got == _reference(ref, 4)
        assert all(rec["tokens"] == toks and rec["fins"] == 1
                   for rec, toks in zip(recs.values(), got))
        audit = proxy.call("audit")
        assert (audit["compiled"], audit["cache_loads"]) == (0, 6)
        # adoption ships the request's AGE: it survives the boundary
        sp = serving.SamplingParams(max_new_tokens=8, seed=3,
                                    deadline_s=30.0)
        erid = proxy.adopt_request(prompts[0], sp, generated_token_ids=[17],
                                   arrive_t=time.perf_counter() - 5.0)
        proxy.step()
        r = proxy.call("export_handoff", {"request_id": erid,
                                          "hid": "age-probe"})
        state = wire.unpack_state(fleet.kv_get_bytes(
            c.kv, wire.handoff_key(fleet.coord_namespace(), "age-probe"),
            5.0))
        assert r["hid"] == "age-probe" and 4.5 <= state["age_s"] <= 15.0
        # a request adopted past its deadline expires at once
        rec, stream = _collector()
        erid = proxy.adopt_request(
            prompts[0], serving.SamplingParams(max_new_tokens=16,
                                               deadline_s=3.0),
            generated_token_ids=[5], stream=stream,
            arrive_t=time.perf_counter() - 5.0)
        assert (erid, None, True) in proxy.step()
        assert proxy.finished_requests[erid].finish_reason == "deadline"
        assert rec["fins"] == 1
        # the disaggregated split over the wire, remote on both sides
        dec = c.proxy(2)
        dec.warmup()
        d = DisaggregatedEngine(proxy, dec, client=c.kv)
        out = d.generate(*_traffic(serving, 4))
        assert [o.tokens for o in out] == got
        assert d.handoffs >= 3 and d.handoff_bytes > 0
        assert [e["pages"] > 0 for e in d.exports] == [True] * d.handoffs
        for px in (proxy, dec):
            assert px.call("audit")["compiled"] == 0
            px.shutdown()
    finally:
        c.close()


# ------------------------------------------------------ the serving fleet
def _fleet_run(sf, n, plan=None, max_new=8, extra=()):
    prompts, sps = _traffic(serving, n, max_new=max_new)
    recs, rids = {}, []
    for p, sp in zip(prompts, sps):
        rec, stream = _collector()
        rid = sf.router.add_request(p, sp, stream=stream)
        rids.append(rid)
        recs[rid] = rec
    rids_extra = [sf.router.add_request(p, sp) for p, sp in extra]
    deadline = time.monotonic() + 60.0
    with R.FaultInjector(plan or R.FaultPlan([])) as inj:
        while sf.router.has_unfinished():
            assert time.monotonic() < deadline, "fleet hung"
            sf.step()
    out = [sf.router.finished_results.pop(rid) for rid in rids]
    for rid, r in zip(rids, out):
        assert recs[rid]["tokens"] == r.output_token_ids, "stream diverged"
        assert recs[rid]["fins"] == 1
    return ([r.output_token_ids for r in out], out, inj,
            [sf.router.finished_results.pop(r) for r in rids_extra])


def test_fleet_failover_exactly_once_and_deadlines(models, warm_cache):
    ref, port, _, _ = models
    want = _reference(ref, 6, max_new=8)
    c = _Cluster(port, [1, 2], cache=warm_cache, max_num_seqs=2)
    try:
        sf = c.serving_fleet([1, 2])
        got, _out, _inj, _ = _fleet_run(sf, 6)
        assert got == want
        assert {sf.rank_of(0), sf.rank_of(1)} == {1, 2}
        # a replica step that raises mid-stream: its requests migrate and
        # replay; queued requests whose TTL expired finish as "deadline"
        rng = np.random.default_rng(11)
        late = [([int(t) for t in rng.integers(1, 256, 4)],
                 serving.SamplingParams(max_new_tokens=8, seed=90 + i,
                                        deadline_s=0.3)) for i in range(2)]
        plan = R.FaultPlan([R.FaultSpec("serving.fleet.step", "exception",
                                        at=6)])
        extra_rids = [sf.router.add_request(p, sp) for p, sp in late]
        time.sleep(0.4)
        got, out, inj, _ = _fleet_run(sf, 6, plan=plan)
        assert len(inj.injected) == 1 and got == want
        assert sum(r.migrations for r in out) >= 1
        assert sf.router.snapshot()["failovers"] == 1
        for rid in extra_rids:
            assert sf.router.finished_results.pop(rid).finish_reason == \
                "deadline"
        sf.shutdown()
    finally:
        c.close()


def test_parked_replica_dead_verdict_and_warm_respawn(models, warm_cache):
    ref, port, _, _ = models
    want = _reference(ref, 6, max_new=8)
    c = _Cluster(port, [1, 2], spares=[3], cache=warm_cache)
    try:
        sf = c.serving_fleet([1, 2], spares=[3])
        plan = R.FaultPlan([R.FaultSpec("serving.fleet.step", "wedge", at=6,
                                        payload={"park_s": 4.0})])
        got, _out, inj, _ = _fleet_run(sf, 6, plan=plan)
        assert len(inj.injected) == 1 and got == want
        (det,) = sf.detections()
        assert det["verdict"] == "dead-verdict" and det["detect_s"] < 4.0
        assert c.monitor.dead_ranks() == [det["rank"]]
        slot = [1, 2].index(det["rank"])
        assert sf.rank_of(slot) == 3 and sf.respawn_ms
        respawned = sf.router.replicas[slot]
        assert respawned.generation == 1
        assert respawned.boot_info["warm"] is True
        assert respawned.boot_info["compiled"] == 0
        sf.shutdown()
    finally:
        c.close()


def test_traffic_controller_over_remote_replicas(models, warm_cache,
                                                 tmp_path, monkeypatch):
    """The worker's traffic mode: a seeded Poisson trace on the driver's
    virtual clock through a ServingFleet of two remote replicas (rank
    threads), every request completed, no token lost."""
    from paddle_tpu_torch.serving import traffic
    from paddle_tpu_torch.serving.fleet import worker
    _, port, _, sd = models
    np.savez(tmp_path / "weights.npz", **sd)
    c = _Cluster(port, [1, 2], cache=warm_cache)
    monkeypatch.setattr(fleet, "_config", c.fc)
    fleet.install_client(c.kv)
    spec = dict(name="fleet", seed=3, arrival={"kind": "poisson",
                                               "rate_qps": 10.0},
                duration_s=0.5, prompt_len=((1.0, 4, 12),),
                output_tokens=((1.0, 4, 6),),
                classes=({"name": "interactive", "ttft_slo_s": 1.0},))
    cfg = {"seed": 0, "device": "cpu",
           "weights": str(tmp_path / "weights.npz"),
           "model": {"preset": "gpt3_tiny"}, "engine": ENGINE_KW,
           "cache_dir": warm_cache, "out_dir": str(tmp_path),
           "worker_ranks": [1, 2], "traffic": spec, "quantum_s": 0.01}
    try:
        worker.run_traffic_controller(cfg, 0)
    finally:
        fleet.get_publisher().stop()
        c.close()
    res = json.loads((tmp_path / "controller.json").read_text())
    rep = res["traffic"]
    assert rep["offered"] == len(traffic.compile_trace(
        traffic.TrafficSpec(**spec))) > 0
    assert rep["completed"] == rep["offered"] and rep["token_loss"] == 0
    assert [b["warm"] for b in res["boots"]] == [True, True]
    assert res["detections"] == [] and res["snapshot"]["failovers"] == 0


def _bare_fleet(kv, cfg, spares, assigned):
    sf = ServingFleet.__new__(ServingFleet)
    sf.client, sf.config, sf._ns = kv, cfg, fleet.coord_namespace
    sf._lock = threading.Lock()
    sf._spares, sf._assigned = list(spares), dict(assigned)
    sf._retired, sf.proxies, sf.respawn_ms = [], {}, []
    sf.monitor = fleet.FleetMonitor(client=kv, config=cfg.fleet_config,
                                    world_fn=lambda: fleet.WorldView([9], 9))
    return sf


def test_factory_claims_roll_back_and_config_validates():
    kv = fleet.LocalKVClient()
    cfg = FleetServingConfig([9], fleet_config=_fc(rendezvous_timeout_s=0.3))
    sf = _bare_fleet(kv, cfg, [], {0: 1})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="spare pool"):
            sf._factory(0)
    assert sf._retired == [] and sf._assigned == {0: 1}
    sf = _bare_fleet(kv, cfg, [], {})
    with pytest.raises(fleet.CollectiveTimeout):
        sf._factory(0)                   # rank 9 serves nothing
    assert sf._assigned == {} and sf._retired == []
    sf = _bare_fleet(kv, cfg, [3], {0: 1})
    with pytest.raises(fleet.CollectiveTimeout):
        sf._factory(0)
    assert sf._spares == [3] and sf._assigned == {0: 1}
    calls = []
    p = RemoteEngineClient(kv, 9, namespace_fn=fleet.coord_namespace,
                           config=_fc(rendezvous_timeout_s=0.2),
                           hold_verdict=lambda s: calls.append(("hold", s)),
                           release_verdict=lambda: calls.append(("rel",)))
    with pytest.raises(fleet.CollectiveTimeout):
        p.warmup()
    assert calls == [("hold", 0.2), ("rel",)]
    with pytest.raises(ValueError, match="at least one"):
        FleetServingConfig([])
    with pytest.raises(ValueError, match="both"):
        FleetServingConfig([1, 2], spare_ranks=[2])
    assert FleetServingConfig([1], rpc_timeout_s=0.5, fleet_config=_fc()
                              ).fleet_config.collective_timeout_s == 0.5


# --------------------------------------------- the multi-process fleet
def _free_port():
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multiprocess_fleet_rank_kill_through_the_launcher(models, tmp_path):
    """4 fresh processes through the port's launcher: rank 0 the
    controller (and the store's host), 1 and 2 replicas, 3 the spare;
    rank 2 SIGKILLed at its 5th step."""
    ref, _, _, sd = models
    weights = tmp_path / "weights.npz"
    np.savez(weights, **sd)
    out_dir, cache, spool = (tmp_path / d for d in ("out", "cache",
                                                    "spool"))
    for d in (out_dir, cache, spool):
        d.mkdir()
    prompts, sps = _traffic(ref_serving, 6, seed=3, max_new=10)
    dprompts, dsps = _traffic(ref_serving, 2, seed=4, max_new=8)
    scenario = {
        "seed": 0, "device": "cpu", "weights": str(weights),
        "model": {"preset": "gpt3_tiny", "dtype": "float32"},
        "engine": ENGINE_KW, "cache_dir": str(cache),
        "out_dir": str(out_dir), "controller_rank": 0,
        "worker_ranks": [1, 2], "spare_ranks": [3],
        "prompts": prompts, "sampling": [wire.sp_to_dict(s) for s in sps],
        "disagg_prompts": dprompts,
        "disagg_sampling": [wire.sp_to_dict(s) for s in dsps],
        "faults": {"2": [{"site": "serving.fleet.step",
                          "kind": "rank_kill", "at": 5}]},
        "serve_budget_s": 40.0, "finalize_s": 1.0}
    path = tmp_path / "scenario.json"
    path.write_text(json.dumps(scenario))
    env = {**os.environ, "PYTHONPATH": ROOT, "TORCH_CPP_LOG_LEVEL": "ERROR",
           "PADDLE_LAUNCH_ID": "fleettest", "PTPU_OBS_SPOOL_DIR": str(spool),
           "PTPU_FLEET_TIMEOUT_S": "10", "PTPU_FLEET_KV_SLICE_S": "0.25",
           "PTPU_FLEET_HB_INTERVAL_S": "0.4",
           "PTPU_FLEET_RENDEZVOUS_TIMEOUT_S": "20"}
    port = _free_port()
    worker = os.path.join(ROOT, "paddle_tpu_torch", "serving", "fleet",
                          "worker.py")
    procs = {r: subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--master", f"127.0.0.1:{port}", "--nnodes", "4", "--rank", str(r),
         worker, str(path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(4)}
    try:
        outs = {r: p.communicate(timeout=90)[0] for r, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = {r: p.returncode for r, p in procs.items()}
    assert codes == {0: 0, 1: 0, 2: -9, 3: 0}, (codes, outs[0][-3000:])
    res = json.loads((out_dir / "controller.json").read_text())
    want = [r.output_token_ids for r in ref_serving.LLMEngine(
        ref, ref_serving.EngineConfig(**ENGINE_KW)).generate(prompts, sps)]
    assert [r["tokens"] for r in res["ref"]] == want
    assert [r["tokens"] for r in res["fleet"]] == want
    assert all(r["stream_tokens"] == r["tokens"] and r["stream_fins"] == 1
               for r in res["fleet"])
    assert sum(r["migrations"] for r in res["fleet"]) >= 1
    (det,) = res["detections"]
    assert det["rank"] == 2 and det["verdict"] == "dead-verdict"
    assert res["assigned"] == {"0": 1, "1": 3}
    assert res["boots"][1]["warm"] is True
    assert res["ref_boot"]["compiled"] == 6
    assert [r["tokens"] for r in res["disagg"]] == \
        [r["tokens"] for r in res["disagg_ref"]]
    assert res["handoffs"] == 2 and res["handoff_bytes"] > 0
    for rank in ("1", "3"):
        assert res["audits"][rank]["compiled"] == 0
    assert res["postmortems"]["2"]["in_flight_requests"]
    tel = fleettrace.merge_spools(str(spool))
    assert sorted(p.rank for p in tel.processes) == [0, 1, 2, 3]
    assert all(p.clock["offset_ns"] is not None for p in tel.processes)
    assert not (out_dir / "replica-rank2.json").exists()
    assert json.loads((out_dir / "replica-rank3.json").read_text())[
        "cache_loads"] == 6
