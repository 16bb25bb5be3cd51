"""paddle_tpu_torch's serving guard and crash-safe decode against
paddle_tpu's engine: the counterparts of ``tests/test_sentinel.py``'s
``TestServingGuard`` and ``tests/test_resilience.py``'s
``TestChaosServing``, each plan run through both engines on shared
weights. Tokens, finish reasons, ``guard_anomalies``,
``decode_fault_recoveries`` and eviction counts must be equal (exact);
a ticking clock gives the reference's latency histograms (to its 4
decimals); a re-run decode step leaves the pools of one run (bit for
bit).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
from paddle_tpu import resilience as ref_R
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTConfig as RefConfig
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT

from paddle_tpu_torch import resilience as R
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

MODEL_KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                max_seq_len=64, dropout=0.0, attention_dropout=0.0)
GUARD_CFG = dict(max_num_seqs=4, page_size=8, max_model_len=32,
                 prefill_buckets=(8, 16))
GUARD_PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
CHAOS_CFG = dict(max_num_seqs=2, page_size=4, max_model_len=32,
                 prefill_buckets=(8, 16))
CHAOS_PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12]]


@pytest.fixture(scope="module")
def models():
    P.seed(0)
    ref = RefGPT(RefConfig(**MODEL_KW))
    port = GPTForCausalLM(GPTConfig(**MODEL_KW), device="cpu")
    load_numpy_state_dict(port, {k: np.asarray(t._value)
                                 for k, t in ref.state_dict().items()})
    return ref, port


def _spec(pkg, site, kind, **kw):
    return pkg.FaultSpec(site, kind, **kw)


# plan name -> (engine config, sampling params, [(site, kind, kwargs)])
PLANS = {
    "clean": (GUARD_CFG, dict(max_new_tokens=6, seed=7), []),
    "clean_guarded": ({**GUARD_CFG, "guard": True},
                      dict(max_new_tokens=6, seed=7), []),
    "nan_logits": ({**GUARD_CFG, "guard": True},
                   dict(max_new_tokens=6, seed=7),
                   [("serving.logits", "nan_grad", dict(at=2))]),
    "inf_bitflip": ({**GUARD_CFG, "guard": True},
                    dict(max_new_tokens=6, seed=7),
                    [("serving.logits", "bitflip", dict(at=1))]),
    "int8_clean_guarded": ({**GUARD_CFG, "guard": True,
                            "kv_cache_dtype": "int8"},
                           dict(max_new_tokens=6, seed=7), []),
    "int8_scale_overflow": ({**GUARD_CFG, "guard": True,
                             "kv_cache_dtype": "int8",
                             "guard_scale_limit": 1e-6},
                            dict(max_new_tokens=6, seed=7), []),
    "int8_nan_and_decode_fault": (
        {**GUARD_CFG, "guard": True, "kv_cache_dtype": "int8"},
        dict(max_new_tokens=6, seed=7),
        [("serving.logits", "nan_grad", dict(at=2)),
         ("serving.decode", "exception", dict(at=4))]),
    "sticky_poison": ({**GUARD_CFG, "guard": True,
                       "guard_requeue_limit": 1},
                      dict(max_new_tokens=6, seed=7),
                      [("serving.logits", "nan_grad",
                        dict(at=0, times=999,
                             payload={"request_id": "req-0"}))]),
    "pool_and_decode_fault": (
        CHAOS_CFG, dict(max_new_tokens=4, temperature=0.7, seed=3),
        [("serving.pool", "pool_exhaust", dict(at=1)),
         ("serving.decode", "exception", dict(at=4))]),
    "decode_fault_named": (
        CHAOS_CFG, dict(max_new_tokens=4, temperature=0.7, seed=3),
        [("serving.decode", "exception",
          dict(at=2, payload={"request_id": "req-0"}))]),
}


def _serve(pkg, model, plan_name, clock=None):
    """(tokens, finish reasons, counters, metrics snapshot) of serving
    the plan's prompts through ``pkg``'s engine under its faults."""
    cfg, sp, faults = PLANS[plan_name]
    prompts = CHAOS_PROMPTS if cfg is CHAOS_CFG else GUARD_PROMPTS
    srv = serving if pkg is R else ref_serving
    kw = {"device": "cpu"} if pkg is R else {}
    if clock is not None:
        kw["clock"] = clock
    eng = srv.LLMEngine(model, srv.EngineConfig(**cfg), **kw)
    plan = pkg.FaultPlan([_spec(pkg, s, k, **a) for s, k, a in faults],
                         name=plan_name)
    try:
        with pkg.FaultInjector(plan):
            outs = eng.generate(prompts, srv.SamplingParams(**sp))
        m = eng.metrics
        counters = dict(guard_anomalies=m.guard_anomalies,
                        decode_fault_recoveries=m.decode_fault_recoveries,
                        evicted=m.requests_evicted,
                        compiles=m.compile_count,
                        bound=m.compile_bound)
        return ([o.output_token_ids for o in outs],
                [o.finish_reason for o in outs], counters,
                m.snapshot())
    finally:
        eng.shutdown()


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_plan_matches_reference_engine(models, plan_name):
    ref, port = models
    got = _serve(R, port, plan_name)
    want = _serve(ref_R, ref, plan_name)
    assert got[:3] == want[:3]
    counters = got[2]
    assert counters["compiles"] <= counters["bound"]
    snap = got[3]
    assert snap["guard_anomalies"] == counters["guard_anomalies"]
    assert snap["decode_fault_recoveries"] == \
        counters["decode_fault_recoveries"]


def test_plans_recover_token_identically(models):
    """What the reference's tests hold of its own engine, held of the
    port's: the guard leaves clean tokens alone; a poisoned row is
    evicted once and replayed to the same tokens; the decode faults
    recover to the fault-free tokens; a persistent overflow or a sticky
    poison finishes with "anomaly" and spares the others."""
    _, port = models
    base, _, _, _ = _serve(R, port, "clean")
    guarded, fins, c, _ = _serve(R, port, "clean_guarded")
    assert guarded == base and c["guard_anomalies"] == 0
    toks, fins, c, _ = _serve(R, port, "nan_logits")
    assert toks == base and fins == ["length"] * 3
    assert c["guard_anomalies"] == 1 and c["evicted"] == 1
    assert _serve(R, port, "inf_bitflip")[2]["guard_anomalies"] == 1
    _, fins, c, _ = _serve(R, port, "int8_clean_guarded")
    assert c["guard_anomalies"] == 0 and set(fins) == {"length"}
    _, fins, c, _ = _serve(R, port, "int8_scale_overflow")
    assert c["guard_anomalies"] > 0 and set(fins) == {"anomaly"}
    _, fins, _, _ = _serve(R, port, "sticky_poison")
    assert fins == ["anomaly", "length", "length"]
    for name in ("pool_and_decode_fault", "decode_fault_named"):
        toks, _, c, _ = _serve(R, port, name)
        cfg, sp, _ = PLANS[name]
        clean = serving.LLMEngine(port, serving.EngineConfig(**cfg),
                                  device="cpu").generate(
            CHAOS_PROMPTS, serving.SamplingParams(**sp))
        assert toks == [o.output_token_ids for o in clean], name
        assert c["decode_fault_recoveries"] == 1 and c["evicted"] >= 1


@pytest.mark.parametrize("pkg_name", ["port", "reference"])
def test_decode_faults_that_must_raise(models, pkg_name):
    """``crash_safe_decode=False`` re-raises the step's fault, and a
    fault at every decode step exhausts the streak bound and re-raises,
    in both packages."""
    ref, port = models
    pkg, srv, model, kw = (R, serving, port, {"device": "cpu"}) \
        if pkg_name == "port" else (ref_R, ref_serving, ref, {})
    for cfg, times in (({"crash_safe_decode": False}, 1), ({}, 10_000)):
        eng = srv.LLMEngine(model, srv.EngineConfig(**{**CHAOS_CFG, **cfg}),
                            **kw)
        plan = pkg.FaultPlan([pkg.FaultSpec("serving.decode", "exception",
                                            at=0, times=times)])
        with pkg.FaultInjector(plan):
            with pytest.raises(pkg.WorkerFault):
                eng.generate(CHAOS_PROMPTS[:2],
                             srv.SamplingParams(max_new_tokens=4))
        eng.shutdown()


class _Ticks:
    """A clock that moves 5 ms at every read."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.005
        return self.t


def test_virtual_clock_gives_reference_histograms(models):
    """The engine reads its clock where the reference's does: under a
    clock that ticks at every read, every latency histogram and the
    uptime equal the reference's; a second engine's metrics keep their
    own clock."""
    ref, port = models
    got = _serve(R, port, "nan_logits", clock=_Ticks())[3]
    want = _serve(ref_R, ref, "nan_logits", clock=_Ticks())[3]
    for key in ("ttft_ms", "inter_token_ms", "e2e_latency_ms",
                "prefill_step_ms", "decode_step_ms"):
        assert {k: v if k == "count" else round(v, 4)
                for k, v in got[key].items()} == want[key], key
    assert round(got["uptime_s"], 3) == want["uptime_s"]
    other = serving.EngineMetrics()
    assert other.clock is not serving.EngineMetrics(clock=_Ticks()).clock


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8", "fp8_e5m2"])
def test_rerun_decode_step_is_idempotent(models, kv_cache_dtype):
    """A decode step run twice (as a recovered step re-runs it) leaves
    the pools and logits of one run, bit for bit."""
    _, port = models
    eng = serving.LLMEngine(port, serving.EngineConfig(
        **GUARD_CFG, kv_cache_dtype=kv_cache_dtype), device="cpu")
    for p in GUARD_PROMPTS:
        eng.add_request(p, serving.SamplingParams(max_new_tokens=8))
    for _ in range(3):
        eng.step()
    tokens = np.zeros((eng.config.max_num_seqs, 1), np.int64)
    for slot, req in enumerate(eng._slots):
        if req is not None:
            tokens[slot, 0] = req.output_token_ids[-1]
    args = [torch.from_numpy(a) for a in (eng._tables, eng._lens, tokens)]

    def copy(pools):
        return [tuple(t.clone() for t in p) if isinstance(p, tuple)
                else p.clone() for p in pools]

    once = (copy(eng._k_pools), copy(eng._v_pools))
    twice = (copy(eng._k_pools), copy(eng._v_pools))
    fn_once, _ = eng._decode_program(pools=once)
    fn_twice, _ = eng._decode_program(pools=twice)
    out = fn_once(*args)
    fn_twice(*args)
    again = fn_twice(*args)
    assert torch.equal(out, again)
    flat = [t for pools in (once, twice) for p in pools[0] + pools[1]
            for t in (p if isinstance(p, tuple) else (p,))]
    half = len(flat) // 2
    assert all(torch.equal(a.view(torch.uint8) if a.dtype.itemsize == 1
                           else a, b.view(torch.uint8)
                           if b.dtype.itemsize == 1 else b)
               for a, b in zip(flat[:half], flat[half:]))
    eng.shutdown()


def test_sampler_takes_nan_and_inf_rows():
    """Rows the guard just evicted are sampled as padding before their
    tokens are dropped: a NaN or inf row samples without raising, and the
    other rows' tokens are unchanged."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((4, 32)).astype(np.float32))
    args = ([1, 2, 3, 4], [5, 6, 7, 8], [0.0, 0.8, 0.0, 0.8], [0, 5, 0, 0],
            [1.0, 0.9, 1.0, 1.0])
    clean = serving.sample_tokens(logits, *args)
    bad = logits.clone()
    bad[1] = float("nan")
    bad[2, 3] = float("inf")
    got = serving.sample_tokens(bad, *args)
    assert got[0] == clean[0] and got[3] == clean[3]
    assert all(0 <= int(t) < 32 for t in got)
