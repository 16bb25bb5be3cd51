"""paddle_tpu_torch serving: the engine's program layer against the
reference's (``paddle_tpu/serving/engine.py``): the ``len(buckets) + 3``
compile bound, ``warmup()``, the prefill and decode program functions
against the reference engine's programs on the same weights, pools,
tables and lengths (f32, atol 1e-5), the sampler on device tensors
against its list form and the reference, and the kernel counts of a
captured region.

On the CPU the engine runs each program function uncaptured, under the
same count; on CUDA the same functions are captured as CUDA graphs
(``chip_smoke.py`` checks those on the card).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny
from paddle_tpu.serving import sampler as ref_sampler

from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.ops.cuda import launch, norm
from paddle_tpu_torch.serving import sampler
from paddle_tpu_torch.serving.engine import _Graph

ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 32))
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """A reference and a port tiny GPT (fused_ln=True) on one set of
    weights, the reference engine over the first, and the reference
    engine's greedy tokens for four prompts."""
    P.seed(0)
    ref = RefGPT(ref_tiny(fused_ln=True))
    sd = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(port, sd)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (3, 7, 12, 5)]
    ref_eng = ref_serving.LLMEngine(ref,
                                    ref_serving.EngineConfig(**ENGINE_KW))
    ref_tokens = [r.output_token_ids for r in ref_eng.generate(
        prompts, [ref_serving.SamplingParams(max_new_tokens=6)
                  for _ in prompts])]
    yield port, ref_eng, prompts, ref_tokens
    ref_eng.shutdown()


def _engine(port, **kw):
    return serving.LLMEngine(port, serving.EngineConfig(**{**ENGINE_KW,
                                                           **kw}),
                             device="cpu")


# ------------------------------------------------------- compile bound
@pytest.mark.parametrize("kw", [
    ENGINE_KW,
    dict(max_model_len=1024),
    dict(max_model_len=64, prefill_buckets=(16, 32, 64)),
], ids=["tests", "chip_smoke", "reference_test"])
def test_compile_bound_is_buckets_plus_three(kw):
    ours = serving.EngineConfig(**kw)
    ref = ref_serving.EngineConfig(**kw)
    assert ours.compile_bound == len(ours.prefill_buckets) + 3
    assert ours.compile_bound == ref.compile_bound
    if kw.get("max_model_len") == 1024:
        assert ours.compile_bound == 10          # buckets 16 ... 1024


def test_note_compile_raises_past_the_bound():
    m = serving.EngineMetrics()
    m.compile_bound = 2
    m.note_compile()
    m.note_compile()
    with pytest.raises(RuntimeError, match="recompile storm"):
        m.note_compile()
    assert m.snapshot()["compiles"] == {"count": 3, "bound": 2,
                                        "cache_loads": 0}


def test_warmup_builds_every_program_and_serving_builds_none(models):
    port, _, prompts, ref_tokens = models
    eng = _engine(port)
    bound = eng.config.compile_bound
    boot = eng.warmup()
    assert boot["programs"] == boot["compiled"] == bound == 5
    assert boot["cache_loads"] == 0 and boot["boot_ms"] >= 0.0
    assert sorted(eng._programs, key=str) == sorted(
        [("prefill", 8), ("prefill", 32), ("decode",), ("sample", 1),
         ("sample", 4)], key=str)
    # on the CPU a program is its plain function, uncaptured
    assert eng._programs[("sample", 1)] is sampler.sample_tokens
    assert not any(isinstance(p, _Graph) for p in eng._programs.values())
    assert eng.warmup()["compiled"] == bound       # idempotent
    got = eng.generate(prompts, [serving.SamplingParams(max_new_tokens=6)
                                 for _ in prompts])
    assert [r.output_token_ids for r in got] == ref_tokens
    rng = np.random.default_rng(0)
    for _ in range(3):
        mixed = [[int(t) for t in rng.integers(1, 256, int(n))]
                 for n in rng.integers(2, 30, 5)]
        sps = [serving.SamplingParams(max_new_tokens=3,
                                      temperature=0.8 * (i % 2), seed=i)
               for i in range(len(mixed))]
        eng.generate(mixed, sps)
    assert eng.metrics.compile_count == bound
    snap = eng.metrics.snapshot()
    assert snap["compiles"] == {"count": eng.metrics.compile_count,
                                "bound": bound, "cache_loads": 0}
    eng.shutdown()
    assert eng._programs == {}


def test_programs_are_built_lazily_within_the_bound(models):
    port, _, prompts, _ = models
    eng = _engine(port)
    eng.generate(prompts[:2], [serving.SamplingParams(max_new_tokens=2)] * 2)
    # both prompts bucket at 8: one prefill, the decode, both samplers
    assert set(eng._programs) == {("prefill", 8), ("decode",), ("sample", 1),
                                  ("sample", 4)}
    assert eng.metrics.compile_count == 4
    eng.metrics.compile_bound = 4
    with pytest.raises(RuntimeError, match="recompile storm"):
        eng.warmup()
    assert ("prefill", 32) not in eng._programs    # nothing over the bound


# ---------------------------------------------- programs vs reference
def _pools(seed, cfg, n_layers=2, heads=4, head_dim=16):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_pages, heads, cfg.page_size, head_dim)
    return [[rng.standard_normal(shape).astype(np.float32)
             for _ in range(n_layers)] for _ in range(2)]


def _load_pools(eng, pools):
    for dst, src in zip(eng._k_pools + eng._v_pools, pools[0] + pools[1]):
        dst.copy_(torch.from_numpy(src))


def _check_pools(eng, ref_pools):
    """Every page but the garbage page 0, which takes repeated writes."""
    for got, want in zip(eng._k_pools + eng._v_pools,
                         list(ref_pools[0]) + list(ref_pools[1])):
        np.testing.assert_allclose(got.numpy()[1:], np.asarray(want)[1:],
                                   atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("bucket,length", [(8, 5), (32, 21)])
def test_prefill_program_matches_reference(models, bucket, length):
    port, ref_eng, _, _ = models
    eng = _engine(port)
    cfg = eng.config
    pools = _pools(bucket, cfg)
    _load_pools(eng, pools)
    rng = np.random.default_rng(length)
    table = np.zeros((1, cfg.max_pages_per_seq), np.int64)
    n_pages = -(-length // cfg.page_size)
    table[0, :n_pages] = rng.permutation(np.arange(1, cfg.num_pages))[
        :n_pages]
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :length] = rng.integers(1, 256, length)
    pos = np.arange(bucket, dtype=np.int64)[None]
    lens = np.array([length], np.int64)

    fn, example = eng._prefill_program(bucket)
    assert [tuple(e.shape) for e in example] == [
        (1, cfg.max_pages_per_seq), (1, bucket), (1, bucket), (1,)]
    got = fn(*map(torch.from_numpy, (table, ids, pos, lens)))
    ref_fn, *_ = ref_eng._prefill_program(bucket)
    want, k_ref, v_ref = jax.jit(ref_fn)(
        ref_eng._params, [jnp.asarray(p) for p in pools[0]],
        [jnp.asarray(p) for p in pools[1]],
        *(jnp.asarray(a, jnp.int32) for a in (table, ids, pos, lens)))
    assert got.shape == (1, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    _check_pools(eng, (k_ref, v_ref))


def test_decode_program_matches_reference(models):
    port, ref_eng, _, _ = models
    eng = _engine(port)
    cfg = eng.config
    pools = _pools(11, cfg)
    _load_pools(eng, pools)
    rng = np.random.default_rng(12)
    lens = np.array([5, 8, 0, 13], np.int64)      # row 2: an empty slot
    pages = iter(rng.permutation(np.arange(1, cfg.num_pages)))
    tables = np.zeros((4, cfg.max_pages_per_seq), np.int64)
    for b, n in enumerate(lens):
        if n:
            for j in range(n // cfg.page_size + 1):
                tables[b, j] = next(pages)
    tokens = rng.integers(1, 256, (4, 1)).astype(np.int64)

    fn, example = eng._decode_program()
    assert [tuple(e.shape) for e in example] == [
        (4, cfg.max_pages_per_seq), (4,), (4, 1)]
    got = fn(*map(torch.from_numpy, (tables, lens, tokens)))
    ref_fn, *_ = ref_eng._decode_program()
    want, k_ref, v_ref = jax.jit(ref_fn)(
        ref_eng._params, [jnp.asarray(p) for p in pools[0]],
        [jnp.asarray(p) for p in pools[1]],
        *(jnp.asarray(a, jnp.int32) for a in (tables, lens, tokens)))
    assert got.shape == (4, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    _check_pools(eng, (k_ref, v_ref))


def test_program_pools_argument_leaves_engine_pools_alone(models):
    """``pools=`` runs a program over other pools: what chip_smoke's
    check of a replay against the uncaptured function relies on."""
    port, _, _, _ = models
    eng = _engine(port)
    cfg = eng.config
    pools = _pools(3, cfg)
    _load_pools(eng, pools)
    copies = ([p.clone() for p in eng._k_pools],
              [p.clone() for p in eng._v_pools])
    tables = np.zeros((4, cfg.max_pages_per_seq), np.int64)
    tables[:, 0] = [1, 2, 3, 4]
    lens = np.array([1, 2, 3, 0], np.int64)
    tokens = np.array([[5], [6], [7], [8]], np.int64)
    args = list(map(torch.from_numpy, (tables, lens, tokens)))
    other = eng._decode_program(pools=copies)[0](*args)
    for p, src in zip(eng._k_pools, pools[0]):
        np.testing.assert_array_equal(p.numpy(), src)
    own = eng._decode_program()[0](*args)
    assert torch.equal(own, other)
    for a, b in zip(eng._k_pools + eng._v_pools, copies[0] + copies[1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------- sampler
@pytest.mark.parametrize("kind", ["all_greedy", "all_sampled", "mixed"])
def test_sampler_on_device_tensors_matches_list_form_and_reference(kind):
    rng = np.random.default_rng(5)
    b, v = 6, 64
    logits = (rng.standard_normal((b, v)) * 2.0).astype(np.float32)
    greedy = {"all_greedy": np.ones(b, bool), "all_sampled": np.zeros(b, bool),
              "mixed": np.arange(b) % 2 == 0}[kind]
    seeds = rng.integers(0, 2 ** 31, b)
    positions = rng.integers(0, 1024, b)
    temps = np.where(greedy, 0.0, 0.9).astype(np.float32)
    top_ks = np.where(np.arange(b) % 3 == 0, 0, 10).astype(np.int32)
    top_ps = np.where(np.arange(b) % 4 == 1, 0.8, 1.0).astype(np.float32)

    listed = sampler.sample_tokens(
        torch.tensor(logits), seeds.tolist(), positions.tolist(),
        temps.tolist(), top_ks.tolist(), top_ps.tolist())
    on_device = sampler.sample_tokens(
        torch.tensor(logits), torch.tensor(seeds), torch.tensor(positions),
        torch.tensor(temps), torch.tensor(top_ks), torch.tensor(top_ps))
    want = ref_sampler.sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds, jnp.int32),
        jnp.asarray(positions, jnp.int32), jnp.asarray(temps),
        jnp.asarray(top_ks), jnp.asarray(top_ps))
    assert on_device.dtype == torch.int32 and on_device.shape == (b,)
    np.testing.assert_array_equal(on_device.numpy(), listed.numpy())
    np.testing.assert_array_equal(on_device.numpy(), np.asarray(want))
    np.testing.assert_array_equal(on_device.numpy()[greedy],
                                  logits.argmax(-1)[greedy])
    if kind != "all_greedy":
        assert (on_device.numpy() != logits.argmax(-1)).any()


# ------------------------------------------------------ kernel counts
def test_captured_counts_are_added_once_a_replay():
    before = {**norm.LAUNCHES}, {**norm.ROUTED}
    try:
        with launch.captured_counts() as added:
            norm.LAUNCHES["ln_fwd"] += 25
            norm.LAUNCHES["ln_res_fwd"] += 24
            norm.ROUTED["layer_norm"] += 1
        assert (norm.LAUNCHES, norm.ROUTED) == before   # capture: none
        for _ in range(3):
            launch.add_replay_counts(added)
        assert norm.LAUNCHES["ln_fwd"] == before[0]["ln_fwd"] + 75
        assert norm.LAUNCHES["ln_res_fwd"] == before[0]["ln_res_fwd"] + 72
        assert norm.ROUTED["layer_norm"] == before[1]["layer_norm"] + 3
        assert norm.LAUNCHES["ln_bwd"] == before[0]["ln_bwd"]
        # a failed capture leaves the counts as they were, too
        with pytest.raises(ValueError):
            with launch.captured_counts():
                norm.LAUNCHES["rms_fwd"] += 1
                raise ValueError("capture failed")
        assert norm.LAUNCHES["rms_fwd"] == before[0]["rms_fwd"]
    finally:
        norm.LAUNCHES.update(before[0])
        norm.ROUTED.update(before[1])
