"""paddle_tpu_torch's global RNG key and dropout against paddle_tpu's:
``seed``/``next_key``/``get_rng_state``, ``split`` and the keep mask bit
for bit against ``jax.random`` (the keep-mask kernel's plain version on
the CPU), ``F.dropout`` in every mode and over axes, ``dropout2d``,
``dropout3d`` and ``alpha_dropout`` equal to the reference's for the
same seed, and 3 ``to_static`` train steps of ``gpt3_tiny`` at the
flagship's dropout defaults (0.1 and 0.1) against the reference's.

Tolerances: masks and keys exact; dropout's values exact (the same f32
or bf16 multiply and divide); the train steps' f32 losses within 1e-5
(the same arithmetic in another order) and the key after each step
exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu.nn.functional as PF
from paddle_tpu.framework import state as ref_state
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny

import paddle_tpu_torch as T
from paddle_tpu_torch.framework import random as threefry
from paddle_tpu_torch.framework import state
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.jit import api
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import random as rng_kernel

VOCAB = 256
SHAPE = (2, 3, 5, 7)


def _ref_key():
    return np.asarray(ref_state.get_rng_state()).astype(np.int64).tolist()


def _key():
    return T.get_rng_state().tolist()


def _words(key):
    return torch.tensor(np.asarray(jax.random.key_data(key)).astype(
        np.int64))


def test_seed_next_key_and_state_match_the_reference():
    T.seed(123)
    P.seed(123)
    assert _key() == _ref_key() == [0, 123]
    for _ in range(3):
        sub = T.framework.next_key()
        want = ref_state.next_key()
        assert sub.tolist() == _words(want).tolist()
        assert _key() == _ref_key()
    saved = T.get_rng_state()
    T.framework.next_key()
    T.set_rng_state(saved)
    assert _key() == saved.tolist()
    T.set_rng_state(np.asarray(jax.random.key_data(jax.random.key(9)),
                               np.uint32))
    assert _key() == [0, 9]


@pytest.mark.parametrize("num", [2, 3])
def test_split_matches_jax(num):
    key = jax.random.key(77)
    k1, k2 = threefry.split(threefry.key_words(_words(key)), num)
    want = np.asarray(jax.random.key_data(jax.random.split(key, num)))
    assert torch.stack([k1, k2], -1).tolist() == want.astype(
        np.int64).tolist()


@pytest.mark.parametrize("dtype", [torch.bool, torch.float32,
                                   torch.bfloat16, torch.float16])
def test_keep_mask_matches_bernoulli_bit_for_bit(dtype):
    """The keep-mask kernel's plain version: the key advanced to
    ``split(key)[0]`` and ``bernoulli(split(key)[1], 0.9, shape)`` of a
    4-D shape, counter layout included."""
    key = jax.random.key(2024)
    new, sub = jax.random.split(key)
    words = _words(key)
    keep, got_sub = rng_kernel.keep_mask(words, 0.9, SHAPE, dtype)
    want = np.asarray(jax.random.bernoulli(sub, 0.9, SHAPE))
    assert keep.dtype == dtype and tuple(keep.shape) == SHAPE
    np.testing.assert_array_equal(keep.float().numpy(), want)
    assert got_sub.tolist() == _words(sub).tolist()
    assert words.tolist() == _words(new).tolist()
    assert not any(rng_kernel.LAUNCHES.values())       # CPU: plain only


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
@pytest.mark.parametrize("axis", [None, 1, [0, 2]])
def test_dropout_matches_reference(mode, axis):
    x = np.random.default_rng(1).standard_normal(SHAPE).astype(np.float32)
    T.seed(5)
    P.seed(5)
    for training in (True, False):
        got = F.dropout(torch.tensor(x), 0.3, axis=axis, training=training,
                        mode=mode)
        want = PF.dropout(P.to_tensor(x), 0.3, axis=axis, training=training,
                          mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
        assert _key() == _ref_key()
    layer = T.nn.Dropout(0.3, axis=axis, mode=mode)
    ref_layer = P.nn.Dropout(0.3, axis=axis, mode=mode)
    np.testing.assert_array_equal(
        layer(torch.tensor(x)).numpy(),
        np.asarray(ref_layer(P.to_tensor(x))._value))


@pytest.mark.parametrize("kind", ["dropout2d", "dropout3d", "alpha_dropout",
                                  "bf16"])
def test_dropout_variants_match_reference(kind):
    shape = {"dropout2d": (2, 3, 4, 5), "dropout3d": (2, 3, 2, 2, 3),
             "alpha_dropout": SHAPE, "bf16": SHAPE}[kind]
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    T.seed(8)
    P.seed(8)
    if kind == "bf16":
        got = F.dropout(torch.tensor(x).bfloat16(), 0.1).float().numpy()
        want = PF.dropout(P.to_tensor(jnp.asarray(x, jnp.bfloat16)), 0.1)
        want = np.asarray(want._value.astype(jnp.float32))
    else:
        got = getattr(F, kind)(torch.tensor(x), 0.4).numpy()
        want = np.asarray(getattr(PF, kind)(P.to_tensor(x), 0.4)._value)
    np.testing.assert_array_equal(got, want)
    assert _key() == _ref_key()


def test_dropout_off_draws_nothing():
    x = torch.ones(4, 4)
    T.seed(1)
    assert F.dropout(x, 0.0) is x
    assert F.dropout(x, 0.5, training=False) is x
    assert torch.equal(F.alpha_dropout(x, 0.5, training=False), x)
    assert _key() == [0, 1]
    with pytest.raises(ValueError, match="mode"):
        F.dropout(x, 0.5, mode="upscale")


def test_a_key_made_during_discovery_is_restored_to_its_init():
    """A key registered after ``to_static``'s snapshot (a step's first
    draw makes it) is filled back with its two-word init, the seed's
    words, as the reference's ``_reinit`` rebuilds it."""
    state._rng.key, state._rng.seed_val = None, 4
    snap = api._StateSnapshot(torch.device("cpu"))
    version = state.registry_version()
    sub = T.framework.next_key()
    t = state.key_tensor()
    assert state.registry_version() != version
    assert state.state_init(t).tolist() == [0, 4] != t.tolist()
    snap.restore()
    assert t.tolist() == [0, 4]
    assert T.framework.next_key().tolist() == sub.tolist()


def _tiny_step(model, opt, pkg, F_):
    @pkg.jit.to_static
    def train_step(ids, labels):
        opt.clear_grad()
        loss = F_.cross_entropy(model(ids).reshape([-1, VOCAB]),
                                labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return train_step


def test_gpt_tiny_train_steps_at_dropout_defaults_match_reference():
    """3 ``to_static`` steps of ``gpt3_tiny(dropout=0.1,
    attention_dropout=0.1)``: losses within 1e-5 and the key after each
    step bit for bit (7 draws a step: the embeddings', then each layer's
    attention probabilities' and two residual dropouts')."""
    P.seed(0)
    ref = RefGPT(ref_tiny(dropout=0.1, attention_dropout=0.1))
    ref_opt = P.optimizer.AdamW(learning_rate=1e-3,
                                parameters=ref.parameters())
    init = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(dropout=0.1, attention_dropout=0.1),
                          device="cpu")
    load_numpy_state_dict(port, init)
    opt = T.optimizer.AdamW(learning_rate=1e-3,
                            parameters=port.parameters())
    ref_step = _tiny_step(ref, ref_opt, P, PF)
    step = _tiny_step(port, opt, T, F)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (2, 16))
    labels = rng.integers(0, VOCAB, (2, 16))
    P.seed(5)
    T.seed(5)
    losses, ref_losses, keys, ref_keys = [], [], [], []
    for _ in range(3):
        ref_losses.append(float(ref_step(P.to_tensor(ids, dtype="int64"),
                                         P.to_tensor(labels,
                                                     dtype="int64"))))
        ref_keys.append(_ref_key())
        losses.append(step(torch.tensor(ids), torch.tensor(labels)).item())
        keys.append(_key())
    np.testing.assert_allclose(losses, ref_losses, atol=1e-5, rtol=0)
    assert keys == ref_keys
    assert len(set(map(tuple, keys))) == 3
