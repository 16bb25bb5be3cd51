"""paddle_tpu_torch.serving.router and the AOT program cache against the
reference package on shared weights (gpt3_tiny, f32).

The port's routed tokens, greedy and sampled, equal the reference
Router's for the same trace and equal the port's sequential single-engine
run (exactly: both run the same arithmetic on the CPU), across a forced
drain with a respawn, a planted ``serving.decode`` crash on one replica
(zero token loss), and queue-full spillover; the routers' counters
(spillovers, failovers, adoptions, respawns, drains) agree. The engine
hooks ``adopt_request`` and ``release_waiting`` give the reference
engine's tokens and request ids. The reference Router runs without a
program cache (its executables do not serialize on the CPU backend)
and builds its programs lazily (``warm_boot=False``), which changes no
routing decision: routing reads queue depth, occupancy and health only.
"""
import numpy as np
import pytest

import paddle_tpu as P
from paddle_tpu import resilience as ref_R
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny
from paddle_tpu.serving.router import Router as RefRouter
from paddle_tpu.serving.router import RouterConfig as RefRouterConfig

from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.resilience import faultinject as R
from paddle_tpu_torch.serving.aot_cache import (AOTProgramCache,
                                                engine_fingerprint)
from paddle_tpu_torch.serving.router import (ReplicaState, Router,
                                             RouterConfig)

ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 16, 32))


@pytest.fixture(scope="module")
def models():
    P.seed(0)
    ref = RefGPT(ref_tiny())
    init = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(), device="cpu")
    load_numpy_state_dict(port, init)
    return ref, port


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("aot"))


def _traffic(pkg, n=9, seed=42):
    """Mixed prefill/decode trace: varied prompt lengths, greedy and
    sampled rows, one seed a request."""
    rng = np.random.default_rng(seed)
    lens = [3, 7, 12, 5, 17, 2, 9, 4, 11, 6, 14, 8][:n]
    prompts = [[int(t) for t in rng.integers(1, 256, ln)] for ln in lens]
    sps = [pkg.SamplingParams(max_new_tokens=6,
                              temperature=0.7 if i % 2 else 0.0,
                              top_k=20 if i % 3 else 0, seed=i)
           for i in range(n)]
    return prompts, sps


def _ref_router(ref, n, **kw):
    return RefRouter(ref, ref_serving.EngineConfig(**{**ENGINE_KW, **kw}),
                     num_replicas=n,
                     config=RefRouterConfig(sleep=lambda s: None,
                                            warm_boot=False))


def _port_router(port, n, cache, **kw):
    return Router(port, serving.EngineConfig(**{**ENGINE_KW, **kw}),
                  num_replicas=n, config=RouterConfig(sleep=lambda s: None),
                  program_cache=cache, device="cpu")


def _sequential(port, prompts, sps, **kw):
    eng = serving.LLMEngine(port, serving.EngineConfig(**{**ENGINE_KW, **kw}),
                            device="cpu")
    out = []
    for p, sp in zip(prompts, sps):
        (one,) = eng.generate([p], [sp])
        out.append(one.output_token_ids)
    eng.shutdown()
    return out


def _counters(router):
    snap = router.snapshot()
    return {k: snap[k] for k in ("spillovers", "failovers", "adoptions",
                                 "respawns", "drains")} | {
        "finished": snap["requests"]["finished"]}


def _drain_run(router, prompts, sps):
    """Six admissions, two fleet steps, a forced drain of replica 0, three
    more admissions, served to the end."""
    rids = [router.add_request(p, sp) for p, sp in zip(prompts[:6], sps[:6])]
    for _ in range(2):
        router.step()
    drained = router.drain(0)
    assert drained.state.value == "draining"
    rids += [router.add_request(p, sp) for p, sp in zip(prompts[6:], sps[6:])]
    rounds = 0
    while router.has_unfinished():
        router.step()
        rounds += 1
        assert rounds < 500
    res = [router.finished_results[r] for r in rids]
    return ([r.output_token_ids for r in res], [r.replica for r in res],
            _counters(router))


def test_forced_drain_matches_reference_router_and_sequential(models,
                                                              cache_dir):
    ref, port = models
    want = _drain_run(_ref_router(ref, 3), *_traffic(ref_serving))
    prompts, sps = _traffic(serving)
    router = _port_router(port, 3, cache_dir)
    got = _drain_run(router, prompts, sps)
    assert got == want
    assert got[0] == _sequential(port, prompts, sps)
    assert got[2]["drains"] == 1 and got[2]["respawns"] >= 1
    assert len(set(got[1])) >= 2                    # spread over the fleet
    router.shutdown()


def test_planted_decode_crash_migrates_without_token_loss(models, cache_dir):
    ref, port = models
    kw = dict(crash_safe_decode=False)
    prompts, sps = _traffic(ref_serving, 6)
    rr = _ref_router(ref, 2, **kw)
    with ref_R.FaultInjector(ref_R.FaultPlan(
            [ref_R.FaultSpec("serving.decode", "exception", at=2)])):
        want = rr.generate(prompts, sps)
    prompts, sps = _traffic(serving, 6)
    router = _port_router(port, 2, cache_dir, **kw)
    with R.FaultInjector(R.FaultPlan(
            [R.FaultSpec("serving.decode", "exception", at=2)])):
        got = router.generate(prompts, sps)
    tokens = [r.output_token_ids for r in got]
    assert tokens == [r.output_token_ids for r in want]
    assert tokens == _sequential(port, prompts, sps, **kw)
    assert all(len(t) == 6 for t in tokens)          # zero token loss
    assert [r.migrations for r in got] == [r.migrations for r in want]
    assert any(r.migrations for r in got)
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert _counters(router) == _counters(rr)
    assert router.metrics.failovers == 1 and router.metrics.respawns == 1
    router.shutdown()


def test_queue_full_spillover_and_fleet_backpressure(models, cache_dir):
    ref, port = models
    kw = dict(max_num_seqs=1, max_queue_depth=1)
    rr = _ref_router(ref, 2, **kw)
    want = rr.generate(*_traffic(ref_serving, 8))
    prompts, sps = _traffic(serving, 8)
    router = _port_router(port, 2, cache_dir, **kw)
    got = router.generate(prompts, sps)
    tokens = [r.output_token_ids for r in got]
    assert tokens == [r.output_token_ids for r in want]
    assert tokens == _sequential(port, prompts, sps, **kw)
    assert [r.replica for r in got] == [r.replica for r in want]
    assert router.metrics.spillovers == rr.metrics.spillovers >= 1
    router.shutdown()


def test_adopt_and_release_waiting_match_reference_engine(models):
    ref, port = models
    prompt = [5, 9, 2, 14]
    out = []
    for pkg, model, kw in ((ref_serving, ref, {}),
                           (serving, port, {"device": "cpu"})):
        sp = pkg.SamplingParams(max_new_tokens=8, temperature=0.9, seed=7)
        cfg = pkg.EngineConfig(**ENGINE_KW)
        origin = pkg.LLMEngine(model, cfg, **kw)
        origin.add_request(prompt, sp)
        events = []
        for _ in range(3):                   # prefill + 2 decode tokens
            events += origin.step()
        partial = [t for _, t, _ in events if t is not None]
        target = pkg.LLMEngine(model, cfg, **kw)
        streamed = []
        target.adopt_request(prompt, sp, generated_token_ids=partial,
                             stream=lambda r, t, fin: streamed.append(t))
        while target.has_unfinished():
            target.step()
        (req,) = target.finished_requests.values()
        with pytest.raises(ValueError, match="already finished"):
            target.adopt_request(prompt, sp, generated_token_ids=[1] * 8)
        one = pkg.LLMEngine(model, pkg.EngineConfig(**{**ENGINE_KW,
                                                       "max_num_seqs": 1}),
                            **kw)
        for i in range(3):
            one.add_request([1 + i, 2, 3], pkg.SamplingParams(
                max_new_tokens=2))
        one.step()                           # admits exactly one
        handed = [r.request_id for r in one.release_waiting()]
        while one.has_unfinished():
            one.step()
        out.append((partial, req.output_token_ids, streamed,
                    target.metrics.requests_adopted,
                    target.metrics.snapshot()["requests"], handed,
                    one.metrics.requests_finished, one.scheduler.queue_depth))
        for e in (origin, target, one):
            e.shutdown()
    assert out[0] == out[1]
    partial, tokens, streamed = out[1][:3]
    assert tokens[:len(partial)] == partial
    assert streamed == tokens[len(partial):]          # nothing streamed twice
    assert out[1][5] == ["req-1", "req-2"]
    assert target.metrics.ttft_decode.count == 1


def test_snapshot_keys_boot_counters_and_metrics_source(models, cache_dir):
    ref, port = models
    rr = _ref_router(ref, 2)            # the keys need no traffic
    cold = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                             device="cpu", program_cache=cache_dir)
    cold.warmup()                        # the cache holds every record
    cold.shutdown()
    router = Router(port, serving.EngineConfig(**ENGINE_KW), num_replicas=2,
                    config=RouterConfig(sleep=lambda s: None),
                    program_cache=AOTProgramCache(cache_dir), device="cpu",
                    metrics_name="serving.router.pytest")
    res = router.generate(*_traffic(serving, 3))
    assert [len(r.output_token_ids) for r in res] == [6, 6, 6]

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}

    want, snap = rr.snapshot(), router.snapshot()
    assert keys(snap) == keys(want)
    def replica_keys(snapshot):
        return [{k: v for k, v in keys(d).items() if k != "boot"}
                for d in snapshot["replica_detail"]]

    # the reference's boot entry holds only boot_ms and warm when its
    # replicas build lazily
    assert replica_keys(snap) == replica_keys(want)
    assert set(snap["replica_detail"][0]["boot"]) == {
        "programs", "compiled", "cache_loads", "boot_ms", "warm"}
    # every replica boots warm, building nothing cold, within the
    # reference's compile bound
    bound = serving.EngineConfig(**ENGINE_KW).compile_bound
    for h in router.replicas:
        assert h.boot_info["warm"] is True
        assert h.boot_info["compiled"] == 0
        assert h.boot_info["cache_loads"] == h.boot_info["programs"] == bound
    assert snap["boot_warm_ms"]["count"] == 2
    assert snap["boot_cold_ms"]["count"] == 0
    report = registry().report()["serving.router.pytest"]
    assert report["requests"]["finished"] == 3
    router.drain(1)
    router.step()                             # drained out: respawned warm
    assert router.replicas[1].generation == 1
    assert router.replicas[1].boot_info["warm"] is True
    assert router.replicas[1].state is ReplicaState.ACTIVE
    router.shutdown()
    assert "serving.router.pytest" not in registry().report()
    rr.shutdown()


def test_generate_batch_larger_than_retention_and_background_loop(models,
                                                                  cache_dir):
    _, port = models
    prompts, sps = _traffic(serving, 6)
    router = Router(port, serving.EngineConfig(**ENGINE_KW), num_replicas=2,
                    config=RouterConfig(sleep=lambda s: None,
                                        finished_retention=2),
                    program_cache=cache_dir, device="cpu")
    res = router.generate(prompts, sps)
    assert [r.output_token_ids for r in res] == _sequential(port, prompts,
                                                            sps)
    assert len(router.finished_results) <= 2
    router.config.finished_retention = 1024
    got = []
    router.start(interval_s=0.001)
    try:
        rids = [router.add_request(p, sp, stream=lambda r, t, fin:
                                   got.append((r, t, fin)))
                for p, sp in zip(prompts[:3], sps[:3])]
        for _ in range(6000):
            with router._lock:
                if all(r in router.finished_results for r in rids):
                    break
            import time
            time.sleep(0.005)
    finally:
        router.stop()
    assert all(len(router.finished_results[r].output_token_ids) == 6
               for r in rids)
    assert sum(1 for _, _, fin in got if fin) == 3
    router.shutdown()


# ---------------------------------------------------- AOT program cache
def test_fingerprint_covers_model_and_engine_config(models, cache_dir):
    _, port = models
    params = dict(port.state_dict())
    base = engine_fingerprint(port.config, serving.EngineConfig(**ENGINE_KW),
                              params)
    assert base == engine_fingerprint(
        port.config, serving.EngineConfig(**ENGINE_KW), params)
    for cfg in ({**ENGINE_KW, "page_size": 8}, {**ENGINE_KW, "guard": True},
                {**ENGINE_KW, "kv_cache_dtype": "int8"},
                {**ENGINE_KW, "prefill_buckets": (8, 32)}):
        assert engine_fingerprint(port.config, serving.EngineConfig(**cfg),
                                  params) != base
    other = gpt3_tiny(num_layers=1)
    assert engine_fingerprint(other, serving.EngineConfig(**ENGINE_KW),
                              params) != base
    eng = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                            device="cpu", program_cache=cache_dir)
    assert eng.program_fingerprint == base
    eng.shutdown()


def test_corrupt_entry_is_a_miss_and_evict_stale_keeps_current(models,
                                                                tmp_path):
    _, port = models
    cache = AOTProgramCache(tmp_path)
    e1 = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                           device="cpu", program_cache=cache)
    e1._get_decode()
    fp = e1.program_fingerprint
    assert cache.entries(fp) == ["decode"]
    with open(cache._entry_path(fp, "decode"), "wb") as fh:
        fh.write(b"torn")
    e2 = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                           device="cpu", program_cache=cache)
    e2._get_decode()                         # rebuilt cold, not a crash
    assert e2.metrics.compile_count == 1 and cache.error_count == 1
    e3 = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                           device="cpu", program_cache=cache)
    e3._get_decode()                         # the replacement loads
    assert e3.metrics.compile_count == 0
    assert e3.metrics.aot_cache_loads == 1
    assert e3.metrics.snapshot()["compiles"]["cache_loads"] == 1
    other = serving.LLMEngine(port, serving.EngineConfig(
        **{**ENGINE_KW, "page_size": 8}), device="cpu", program_cache=cache)
    other._get_decode()
    assert cache.evict_stale(fp) == [other.program_fingerprint]
    assert cache.entries(fp) == ["decode"]
    assert not cache.entries(other.program_fingerprint)
    for e in (e1, e2, e3, other):
        e.shutdown()
