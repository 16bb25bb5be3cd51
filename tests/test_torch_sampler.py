"""paddle_tpu_torch's sampler noise against the installed jax: the
threefry-2x32 hash, ``PRNGKey``, ``fold_in`` and the 32-bit random bits
bit for bit; the uniforms bit for bit; the Gumbel noise within 2 ulp of
each of its two logs (``|dg| <= 2 ulp(g) + 2^-22``: jax's CPU log is not
the correctly rounded one the port takes, and near ``u = 1/e`` the outer
log turns one ulp of the inner into many of the result); and the tokens
``sample_tokens`` draws without ``noise=`` equal the reference
sampler's. The engine's sampled tokens against the reference engine's
are in ``test_torch_serving.py`` (its shared models).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jax_prng

from paddle_tpu.serving import sampler as ref_sampler

from paddle_tpu_torch.serving import sampler

SEEDS = (0, 1, 2 ** 31 - 1)
POSITIONS = (0, 5, 1023)


def _words(a):
    return [int(x) for x in np.asarray(a).astype(np.int64).ravel()]


def _jax_key(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(seed), pos)


def test_threefry2x32_matches_jax():
    rng = np.random.default_rng(0)
    for seed in SEEDS:
        for pos in POSITIONS:
            key = np.asarray(_jax_key(seed, pos))
            count = rng.integers(0, 2 ** 32, 2 * 37, dtype=np.uint64) \
                .astype(np.uint32)
            want = jax_prng.threefry_2x32(jnp.asarray(key),
                                          jnp.asarray(count))
            k1, k2 = (torch.tensor(int(w)) for w in key)
            x = torch.tensor(count.astype(np.int64))
            y1, y2 = sampler.threefry2x32(k1, k2, x[:37], x[37:])
            assert _words(torch.cat([y1, y2])) == _words(want)


@pytest.mark.parametrize("seed", SEEDS + (-1,))
def test_prng_key_and_fold_in_match_jax(seed):
    assert _words(torch.stack(sampler.prng_key(seed))) == \
        _words(jax.random.PRNGKey(seed))
    for pos in POSITIONS:
        got = sampler.fold_in(sampler.prng_key(seed), pos)
        assert _words(torch.stack(got)) == _words(_jax_key(seed, pos))


def test_random_bits_and_uniforms_match_jax():
    tiny = np.finfo(np.float32).tiny
    for seed in SEEDS:
        for pos in POSITIONS:
            jkey = _jax_key(seed, pos)
            key = sampler.fold_in(sampler.prng_key(seed), pos)
            assert _words(sampler.random_bits(key, 100)) == \
                _words(jax.random.bits(jkey, (100,), jnp.uint32))
            want = np.asarray(jax.random.uniform(jkey, (100,), jnp.float32,
                                                 minval=tiny))
            np.testing.assert_array_equal(
                sampler.uniform(key, 100).numpy().view(np.int32),
                want.view(np.int32))


@pytest.mark.parametrize("vocab", [64, 50304])
def test_gumbel_noise_matches_jax(vocab):
    for seed in SEEDS:
        for pos in POSITIONS:
            want = np.asarray(jax.random.gumbel(_jax_key(seed, pos), (vocab,),
                                                jnp.float32))
            got = sampler.gumbel_noise(seed, pos, vocab, "cpu").numpy()
            ulp = np.spacing(np.abs(want))
            err = np.abs(got.astype(np.float64) - want)
            assert (err <= 2 * ulp + 2.0 ** -22).all(), err.max()


def test_rows_draw_as_one_key_each():
    """The batched draw is the per-row draw: a row's noise depends only
    on its own (seed, position)."""
    seeds, positions = [3, 3, 7], [10, 11, 10]
    key = sampler.fold_in(sampler.prng_key(seeds), positions)
    rows = sampler.gumbel(key, 64)
    for i in range(3):
        assert torch.equal(rows[i], sampler.gumbel_noise(
            seeds[i], positions[i], 64, "cpu"))


@pytest.mark.parametrize("knobs", [
    dict(temperature=0.7, top_k=0, top_p=1.0),
    dict(temperature=1.3, top_k=5, top_p=1.0),
    dict(temperature=0.9, top_k=8, top_p=0.8),
    dict(temperature=0.0, top_k=0, top_p=1.0),
], ids=["temperature", "top_k", "all", "greedy"])
def test_sample_tokens_match_reference(knobs):
    rng = np.random.default_rng(11)
    b, v = 6, 64
    logits = (2.0 * rng.standard_normal((b, v))).astype(np.float32)
    seeds = [0, 1, 2 ** 31 - 1, 17, 17, 4]
    positions = [0, 5, 1023, 9, 10, 300]
    temps = np.full(b, knobs["temperature"], np.float32)
    top_ks = np.full(b, knobs["top_k"], np.int32)
    top_ps = np.full(b, knobs["top_p"], np.float32)
    want = ref_sampler.sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(positions),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps))
    got = sampler.sample_tokens(torch.tensor(logits), seeds, positions,
                                temps, top_ks, top_ps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
