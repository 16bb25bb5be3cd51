"""paddle_tpu_torch's quantized KV pools (``quantization/kv_cache.py``)
against paddle_tpu's, and the tiny engine over int8 / fp8 pools against
the reference engine.

Codes and scales are compared bit for bit (int8 and both fp8 types; the
garbage page 0, where padding rows' writes collide, is left out);
attention outputs within 1e-6 (f32, sums in another order); tokens, the
pools' bytes and ``kv_bytes_per_token`` exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny
from paddle_tpu.quantization import kv_cache as ref_kv

from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.quantization import kv_cache as kv

SPECS = ["int8", "fp8_e4m3", "fp8_e5m2"]
ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 32))


def _u8(x):
    """The bits of codes (either package's) as uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_specs_bytes_and_errors_match_reference():
    for name in SPECS:
        ours, ref = kv.resolve_kv_cache_dtype(name), \
            ref_kv.resolve_kv_cache_dtype(name)
        assert (ours.qmax, ours.code_bytes, ours.is_int) == \
            (ref.qmax, ref.code_bytes, ref.is_int)
        for page in (4, 16):
            assert kv.kv_bytes_per_token(16, 128, page, ours) == \
                ref_kv.kv_bytes_per_token(16, 128, page, ref)
    assert kv.kv_bytes_per_token(16, 128, 16, None, torch.bfloat16) == \
        ref_kv.kv_bytes_per_token(16, 128, 16, None, jnp.bfloat16) == 8192
    assert kv.resolve_kv_cache_dtype(None) is None
    for mod in (kv, ref_kv):
        with pytest.raises(ValueError, match="not supported"):
            mod.resolve_kv_cache_dtype("int4")
    x = np.array([-2.5, -0.5, 0.5, 1.5, 200.0], np.float32)
    np.testing.assert_array_equal(
        kv.encode_int_codes(torch.tensor(x), 127.0).numpy(),
        np.asarray(ref_kv.encode_int_codes(jnp.asarray(x), 127.0)))
    with pytest.raises(NotImplementedError):
        kv.encode_int_codes(torch.tensor(x), 127.0, key=0)


@pytest.mark.parametrize("name", SPECS)
def test_quantize_block_bit_equal(name):
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((3, 2, 4, 8)) *
         rng.choice([0.0, 1e-3, 1.0, 300.0], (3, 2, 1, 1))).astype(np.float32)
    ours = kv.quantize_block(torch.tensor(v), kv.KV_CACHE_DTYPES[name],
                             (2, 3))
    ref = ref_kv.quantize_block(jnp.asarray(v),
                                ref_kv.KV_CACHE_DTYPES[name], (2, 3))
    np.testing.assert_array_equal(_u8(ours[0]), _u8(ref[0]))
    np.testing.assert_array_equal(_np(ours[1]), _np(ref[1]))
    np.testing.assert_array_equal(
        kv.dequantize_codes(*ours).numpy(),
        np.asarray(ref_kv.dequantize_codes(*ref)))


def _pools(rng, name, N=12, h=2, p=4, d=8):
    """Two (codes, scales) pools of stale random content, as both
    packages' tensors."""
    spec = kv.KV_CACHE_DTYPES[name]
    out = []
    for _ in range(2):
        codes = torch.tensor(rng.integers(-100, 100, (N, h, p, d)),
                             dtype=torch.float32).to(spec.code_dtype)
        scales = torch.tensor(rng.uniform(0.5, 2.0, (N, h)),
                              dtype=torch.float32)
        out.append((codes, scales))
    ref = [(jnp.asarray(_u8(c)).view(ref_kv.KV_CACHE_DTYPES[name].code_dtype),
            jnp.asarray(s.numpy())) for c, s in out]
    return out, ref


def _check_pools(ours, ref):
    for (c, s), (rc, rs) in zip(ours, ref):
        np.testing.assert_array_equal(_u8(c)[1:], _u8(rc)[1:])
        np.testing.assert_array_equal(s.numpy()[1:], np.asarray(rs)[1:])


@pytest.mark.parametrize("name", SPECS)
def test_prefill_decode_and_attend_bit_equal(name):
    """A prefill over stale pools (row 2 not prefilled), then four
    decode steps with growing, shrinking and again growing token
    magnitudes, row 0 crossing onto a fresh page (its stale scale
    ignored): codes and scales bit-equal after every write, the
    attention within 1e-6."""
    rng = np.random.default_rng(1)
    spec, rspec = kv.KV_CACHE_DTYPES[name], ref_kv.KV_CACHE_DTYPES[name]
    ours, ref = _pools(rng, name)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    lens = np.array([7, 10, 0], np.int32)
    k, v = (rng.standard_normal((3, 2, 12, 8)).astype(np.float32)
            for _ in range(2))
    kv.quantized_prefill_append(torch.tensor(k), torch.tensor(v), *ours,
                                torch.tensor(tables), torch.tensor(lens), 4,
                                spec)
    ref = list(ref_kv.quantized_prefill_append(
        jnp.asarray(k), jnp.asarray(v), *ref, jnp.asarray(tables),
        jnp.asarray(lens), 4, rspec))
    _check_pools(ours, ref)
    for step, mag in enumerate((1.0, 3.0, 0.5, 5.0)):
        q, kn, vn = (rng.standard_normal((3, 2, 1, 8)).astype(np.float32)
                     for _ in range(3))
        kn, vn = kn * mag, vn * mag
        got = kv.quantized_decode_step(
            torch.tensor(q), torch.tensor(kn), torch.tensor(vn), *ours,
            torch.tensor(tables), torch.tensor(lens), 4, spec)
        want = ref_kv.quantized_decode_step(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), *ref,
            jnp.asarray(tables), jnp.asarray(lens), 4, rspec)
        assert got[1] is ours[0] and got[2] is ours[1]     # in place
        ref = list(want[1:])
        _check_pools(ours, ref)
        np.testing.assert_allclose(got[0].numpy()[:2],
                                   np.asarray(want[0])[:2], rtol=1e-6,
                                   atol=1e-6)
        lens = lens + np.array([1, 1, 0], np.int32)
    att = kv.quantized_attend(torch.tensor(q), *ours, torch.tensor(tables),
                              torch.tensor(lens), 4, spec)
    want = ref_kv.quantized_attend(jnp.asarray(q), *ref,
                                   jnp.asarray(tables), jnp.asarray(lens), 4,
                                   rspec)
    np.testing.assert_allclose(att.numpy()[:2], np.asarray(want)[:2],
                               rtol=1e-6, atol=1e-6)


def test_no_growth_append_keeps_codes_bit_identical():
    """A token that does not grow the page's scale re-grids the page by
    exactly 1.0 (the reference's ``tests/test_quantized_kv.py:153``)."""
    spec = kv.KV_CACHE_DTYPES["int8"]
    pools = [(torch.zeros(3, 1, 4, 8, dtype=torch.int8), torch.zeros(3, 1))
             for _ in range(2)]
    tables = torch.tensor([[1, 2]])
    q = torch.ones(1, 1, 1, 8)
    big, small = torch.full((1, 1, 1, 8), 4.0), torch.full((1, 1, 1, 8),
                                                           0.25)
    kv.quantized_decode_step(q, big, big, *pools, tables, torch.zeros(1),
                             4, spec)
    before = pools[0][0][1].clone()
    scale = pools[0][1][1].clone()
    kv.quantized_decode_step(q, small, small, *pools, tables, torch.ones(1),
                             4, spec)
    assert torch.equal(pools[0][0][1][:, 0], before[:, 0])
    assert torch.equal(pools[0][1][1], scale)


# --------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def shared_models():
    """The reference and the port tiny GPT on one set of weights, f32."""
    P.seed(0)
    ref = RefGPT(ref_tiny(fused_ln=True))
    sd = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(port, sd)
    rng = np.random.default_rng(42)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (3, 7, 12, 5)]
    return ref, port, prompts


def _sps(n, max_new=6):
    return [dict(max_new_tokens=max_new, temperature=0.7 if i % 2 else 0.0,
                 top_k=20 if i % 3 else 0, top_p=0.9 if i % 2 else 1.0,
                 seed=i) for i in range(n)]


def _ref_generate(ref, prompts, sps, **cfg):
    eng = ref_serving.LLMEngine(ref, ref_serving.EngineConfig(
        **{**ENGINE_KW, **cfg}))
    try:
        out = eng.generate(prompts, [ref_serving.SamplingParams(**sp)
                                     for sp in sps])
        return [r.output_token_ids for r in out], eng
    finally:
        eng.shutdown()


def _port_engine(port, **cfg):
    return serving.LLMEngine(port, serving.EngineConfig(
        **{**ENGINE_KW, **cfg}), device="cpu")


def _generate(eng, prompts, sps):
    return [r.output_token_ids for r in eng.generate(
        prompts, [serving.SamplingParams(**sp) for sp in sps])]


@pytest.mark.parametrize("name", SPECS)
def test_engine_tokens_and_bytes_match_reference(shared_models, name):
    """Greedy and sampled tokens over quantized pools equal the
    reference engine's, and so do the pools' bytes."""
    ref, port, prompts = shared_models
    sps = _sps(len(prompts))
    want, ref_eng = _ref_generate(ref, prompts, sps, kv_cache_dtype=name)
    eng = _port_engine(port, kv_cache_dtype=name)
    assert _generate(eng, prompts, sps) == want
    assert eng.metrics.compile_count <= eng.config.compile_bound
    assert eng.kv_pool_bytes == ref_eng.kv_pool_bytes
    assert eng.kv_bytes_per_token == ref_eng.kv_bytes_per_token
    plain = _port_engine(port, dtype=torch.bfloat16)
    assert eng.kv_bytes_per_token < 0.55 * plain.kv_bytes_per_token


def test_int8_continuous_equals_sequential(shared_models):
    _, port, prompts = shared_models
    sps = _sps(len(prompts))
    batched = _generate(_port_engine(port, kv_cache_dtype="int8"), prompts,
                        sps)
    seq = _port_engine(port, kv_cache_dtype="int8")
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        assert _generate(seq, [p], [sp]) == [batched[i]], i


def test_int8_eviction_replay_deterministic(shared_models):
    """Preemption over int8 pools: the replay re-quantizes prompt +
    generated tokens through prefill, so tokens may drift within the
    reference's tolerance contract, but two runs are identical, and equal
    the reference engine's."""
    ref, port, _ = shared_models
    cfg = dict(max_model_len=16, num_pages=11, prefill_buckets=(8, 16),
               kv_cache_dtype="int8")
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, 256, 3 + i)]
               for i in range(4)]
    sps = [dict(max_new_tokens=8, temperature=0.9, seed=i) for i in range(4)]
    runs = []
    for _ in range(2):
        eng = _port_engine(port, **cfg)
        runs.append((_generate(eng, prompts, sps),
                     eng.metrics.requests_evicted))
    assert runs[0] == runs[1] and runs[0][1] >= 1
    want, ref_eng = _ref_generate(ref, prompts, sps, **cfg)
    assert runs[0] == (want, ref_eng.metrics.requests_evicted)
