"""paddle_tpu_torch serving: paged attention, the sampler and the engine
against the reference package on the same inputs, and the port's own
continuous == sequential contract.

Paged attention and engine logits are f32 (atol 1e-5); tokens compare
exactly, greedy and sampled: the port draws the reference's threefry
Gumbel noise from (seed, position) (``test_torch_sampler.py`` holds the
noise itself against jax), and the shared-noise tests feed both packages
one noise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu import serving as ref_serving
from paddle_tpu.incubate.nn import paged_attention as ref_paged
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny
from paddle_tpu.resilience.health import HealthMonitor as RefHealth
from paddle_tpu.serving import sampler as ref_sampler

from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.incubate.nn import paged_attention as paged
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.resilience.health import HealthMonitor
from paddle_tpu_torch.serving import sampler

ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 32))


# ------------------------------------------------------ paged attention
def _pools(rng, n_pages=9, h=2, page=4, d=8):
    k = rng.standard_normal((n_pages, h, page, d)).astype(np.float32)
    v = rng.standard_normal((n_pages, h, page, d)).astype(np.float32)
    return k, v


def test_page_allocator_matches_reference():
    ours, ref = paged.PageAllocator(9, 3, 4), ref_paged.PageAllocator(9, 3, 4)
    script = [("allocate", 0, 2), ("allocate", 1, 3), ("release", 0),
              ("allocate", 2, 4), ("allocate", 0, 1), ("release", 1),
              ("allocate", 1, 2), ("release", 2), ("release", 2)]
    for op, *args in script:
        assert getattr(ours, op)(*args) == getattr(ref, op)(*args)
        assert ours.num_free_pages == ref.num_free_pages
        assert ours.check_invariant()
    assert not ours.can_allocate(0, 5)            # past max_pages_per_seq
    small = paged.PageAllocator(4, 2, 3)
    small.allocate(0, 3)
    with pytest.raises(RuntimeError, match="out of pages"):
        small.allocate(1, 1)


def test_paged_decode_step_matches_reference():
    rng = np.random.default_rng(0)
    k_pages, v_pages = _pools(rng)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.array([9, 4, 0], np.int32)       # row 2: an empty slot
    q, k_new, v_new = (rng.standard_normal((3, 2, 1, 8)).astype(np.float32)
                       for _ in range(3))
    want = ref_paged.paged_decode_step(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(k_pages), jnp.asarray(v_pages), jnp.asarray(tables),
        jnp.asarray(lens), 4)
    kp, vp = torch.tensor(k_pages), torch.tensor(v_pages)
    got = paged.paged_decode_step(
        torch.tensor(q), torch.tensor(k_new), torch.tensor(v_new), kp, vp,
        torch.tensor(tables), torch.tensor(lens), 4)
    assert got[1] is kp and got[2] is vp                 # written in place
    live = [1, 2, 3, 4, 5]                  # page 0 is the garbage page
    np.testing.assert_allclose(got[0][:2].numpy(), np.asarray(want[0])[:2],
                               atol=1e-5, rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy()[live], np.asarray(w)[live])


def test_paged_attend_bf16_matches_reference():
    rng = np.random.default_rng(1)
    k_pages, v_pages = _pools(rng)
    tables = np.array([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
    lens = np.array([14, 5], np.int32)
    q = rng.standard_normal((2, 2, 1, 8)).astype(np.float32)
    bf = jnp.bfloat16
    want = ref_paged.paged_attend(
        jnp.asarray(q).astype(bf), jnp.asarray(k_pages).astype(bf),
        jnp.asarray(v_pages).astype(bf), jnp.asarray(tables),
        jnp.asarray(lens), 4)
    got = paged.paged_attend(
        torch.tensor(q).bfloat16(), torch.tensor(k_pages).bfloat16(),
        torch.tensor(v_pages).bfloat16(), torch.tensor(tables),
        torch.tensor(lens), 4)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # one bf16 rounding of an f32 result: within one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-5)


def test_paged_prefill_append_matches_reference():
    rng = np.random.default_rng(2)
    k_pages, v_pages = _pools(rng)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    lens = np.array([6, 0], np.int32)          # row 1 is not prefilled
    k_new, v_new = (rng.standard_normal((2, 2, 8, 8)).astype(np.float32)
                    for _ in range(2))
    want = ref_paged.paged_prefill_append(
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(k_pages),
        jnp.asarray(v_pages), jnp.asarray(tables), jnp.asarray(lens), 4)
    got = paged.paged_prefill_append(
        torch.tensor(k_new), torch.tensor(v_new), torch.tensor(k_pages),
        torch.tensor(v_pages), torch.tensor(tables), torch.tensor(lens), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])


# ------------------------------------------------------------- sampler
def _sampler_inputs(b=4, v=32):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((b, v)).astype(np.float32) * 2.0,
            rng.gumbel(size=(b, v)).astype(np.float32))


def test_greedy_sampling_matches_reference():
    logits, _ = _sampler_inputs()
    b = logits.shape[0]
    want = ref_sampler.sample_tokens(
        jnp.asarray(logits), jnp.arange(b), jnp.arange(b), jnp.zeros(b),
        jnp.zeros(b, jnp.int32), jnp.ones(b))
    got = sampler.sample_tokens(torch.tensor(logits), list(range(b)),
                                list(range(b)), np.zeros(b), np.zeros(b),
                                np.ones(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7, top_k=0, top_p=1.0),
    dict(temperature=1.3, top_k=5, top_p=1.0),
    dict(temperature=1.0, top_k=0, top_p=0.6),
    dict(temperature=0.9, top_k=8, top_p=0.8),
], ids=["temperature", "top_k", "top_p", "all"])
def test_sampling_with_shared_noise_matches_reference(monkeypatch, knobs):
    logits, noise = _sampler_inputs()
    for i in range(logits.shape[0]):
        monkeypatch.setattr(jax.random, "gumbel",
                            lambda key, shape, dtype, _n=noise[i]:
                            jnp.asarray(_n))
        want = int(ref_sampler._sample_row(
            jnp.asarray(logits[i]), i, 5, knobs["temperature"],
            knobs["top_k"], knobs["top_p"]))
        got = sampler._sample_row(
            torch.tensor(logits[i]), i, 5, knobs["temperature"],
            knobs["top_k"], knobs["top_p"], noise=torch.tensor(noise[i]))
        assert got == want


def test_sampling_is_determined_by_seed_and_position():
    logits, _ = _sampler_inputs(b=3, v=64)
    t = torch.tensor(logits)
    args = ([1, 2, 3], [5, 6, 7], np.full(3, 0.8), np.zeros(3), np.ones(3))
    a = sampler.sample_tokens(t, *args)
    b = sampler.sample_tokens(t, *args)
    assert torch.equal(a, b)
    # row 0 alone, at the same (seed, position): the same draw
    one = sampler.sample_tokens(t[:1], [1], [5], [0.8], [0], [1.0])
    assert one[0] == a[0]
    # top_k=2 keeps the draw inside the two largest logits
    for seed in range(6):
        out = sampler.sample_tokens(t, [seed] * 3, [0] * 3, np.full(3, 1.5),
                                    np.full(3, 2), np.ones(3))
        top2 = np.argsort(logits, -1)[:, -2:]
        assert all(out[i].item() in top2[i] for i in range(3))


# ----------------------------------------------- host logic (copies)
def test_scheduler_and_buckets_match_reference():
    from paddle_tpu.serving import scheduler as ref_sched
    for n in (8, 48, 100, 256, 1024):
        assert serving.default_buckets(n) == ref_sched.default_buckets(n)
    assert serving.bucket_for(17, (16, 32)) == 32
    s = serving.Scheduler((16,), page_size=4, growth_reserve_pages=1)
    reqs = [serving.Request(f"r{i}", list(range(1, 9)),
                            serving.SamplingParams(), arrival_index=i)
            for i in range(3)]
    for r in reqs:
        s.enqueue(r)
    assert s.pages_for_prompt(8) == 3
    assert s.pop_admissible(free_slots=1, free_pages=2) is None
    assert s.pop_admissible(1, 3) is reqs[0]
    for r in reqs:
        r.state = serving.RequestState.DECODE
    assert s.select_victim(reqs) is reqs[2]


def test_health_monitor_matches_reference():
    ours, ref = HealthMonitor(), RefHealth()
    for p in (0.5, 0.86, 0.9, 0.98, 0.9, 0.8, 0.6, 0.99, 0.84, 0.5):
        assert int(ours.update(p)) == int(ref.update(p))
        assert ours.admitting == ref.admitting
    assert [(int(a), int(b)) for a, b, _ in ours.transitions] == \
        [(int(a), int(b)) for a, b, _ in ref.transitions]


def test_metrics_snapshot_schema():
    m = serving.EngineMetrics()
    m.pages_total, m.pages_in_use, m.generated_tokens = 10, 5, 100
    m.ttft.observe(0.25)
    snap = m.snapshot()
    assert snap["pages"]["utilization"] == 0.5
    assert snap["ttft_ms"]["p50"] == 250.0
    assert snap["tokens"]["per_s"] > 0


# --------------------------------------------------------------- engine
SAMPLED = dict(temperature=0.7, top_k=20, top_p=0.9)


@pytest.fixture(scope="module")
def shared_models():
    """A reference and a port tiny GPT (fused_ln=True) on one set of
    weights, and the reference engine's greedy tokens and its tokens
    sampled at ``SAMPLED`` (seed i for request i), built once."""
    P.seed(0)
    ref = RefGPT(ref_tiny(fused_ln=True))
    sd = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(port, sd)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (3, 7, 12, 5)]
    eng = ref_serving.LLMEngine(ref, ref_serving.EngineConfig(**ENGINE_KW))
    try:
        ref_tokens = [r.output_token_ids for r in eng.generate(
            prompts, [ref_serving.SamplingParams(max_new_tokens=6)
                      for _ in prompts])]
        ref_sampled = [r.output_token_ids for r in eng.generate(
            prompts, [ref_serving.SamplingParams(max_new_tokens=6, seed=i,
                                                 **SAMPLED)
                      for i in range(len(prompts))])]
    finally:
        eng.shutdown()
    return port, prompts, ref_tokens, ref_sampled


def test_greedy_tokens_match_reference_engine(shared_models):
    port, prompts, ref_tokens, _ = shared_models
    eng = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                            device="cpu")
    got = eng.generate(prompts, [serving.SamplingParams(max_new_tokens=6)
                                 for _ in prompts])
    assert [r.output_token_ids for r in got] == ref_tokens
    snap = eng.metrics.snapshot()
    assert snap["requests"]["finished"] == 4
    assert snap["pages"]["in_use"] == 0
    assert all(r.finish_reason == "length" for r in got)


def test_sampled_tokens_match_reference_engine(shared_models):
    port, prompts, ref_tokens, ref_sampled = shared_models
    assert ref_sampled != ref_tokens            # the knobs do sample
    eng = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                            device="cpu")
    got = eng.generate(prompts, [serving.SamplingParams(
        max_new_tokens=6, seed=i, **SAMPLED) for i in range(len(prompts))])
    assert [r.output_token_ids for r in got] == ref_sampled


def test_continuous_equals_sequential_with_sampling(shared_models):
    port, prompts, _, _ = shared_models
    sps = [serving.SamplingParams(
        max_new_tokens=6, temperature=0.7 if i % 2 else 0.0,
        top_k=20 if i % 3 else 0, top_p=0.9 if i % 2 else 1.0, seed=i)
        for i in range(len(prompts))]
    cont = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                             device="cpu")
    batched = cont.generate(prompts, sps)
    seq = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                            device="cpu")
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        (one,) = seq.generate([p], [sp])
        assert one.output_token_ids == batched[i].output_token_ids, i


def test_preemption_replays_token_identically(shared_models):
    port, _, _, _ = shared_models
    cfg = dict(max_num_seqs=4, page_size=4, max_model_len=16, num_pages=11,
               prefill_buckets=(8, 16))
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 256, 3 + i)]
               for i in range(4)]
    sps = [serving.SamplingParams(max_new_tokens=8, temperature=0.9, seed=i)
           for i in range(4)]
    eng = serving.LLMEngine(port, serving.EngineConfig(**cfg), device="cpu")
    res = eng.generate(prompts, sps)
    assert eng.metrics.requests_evicted >= 1
    seq = serving.LLMEngine(port, serving.EngineConfig(**cfg), device="cpu")
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        (one,) = seq.generate([p], [sp])
        assert one.output_token_ids == res[i].output_token_ids


def test_engine_contract_errors(shared_models, monkeypatch, tmp_path):
    port, prompts, _, _ = shared_models
    with pytest.raises(NotImplementedError):
        serving.EngineConfig(mesh={"tp": 2})
    for kw in ({"kv_cache_dtype": "int8"}, {"kv_cache_dtype": "fp8_e4m3"},
               {"kv_cache_dtype": "fp8_e5m2"}, {"guard": True},
               {"crash_safe_decode": False}):
        serving.EngineConfig(**kw)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        serving.EngineConfig(kv_cache_dtype="int4")
    cached = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                               device="cpu", program_cache=str(tmp_path))
    assert len(cached.program_fingerprint) == 24
    cached.shutdown()
    named = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                              device="cpu", metrics_name="engine-a")
    assert named.metrics.labels == {"engine": "engine-a"}
    named.shutdown()
    eng = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                            device="cpu")
    with pytest.raises(ValueError, match="max_model_len"):
        eng.add_request(list(range(1, 40)),
                        serving.SamplingParams(max_new_tokens=20))
    with pytest.raises(TypeError):
        eng.generate([1, 2, 3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW))
