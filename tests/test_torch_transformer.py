"""paddle_tpu_torch's ``nn.MultiHeadAttention``, the transformer layers and
``nn.Transformer`` against paddle_tpu's, on the same numpy inputs from a
seed and the reference's weights crossing by state-dict name: attention
self and cross (sq != sk) with no, bool and additive masks, the
incremental decode through ``Cache`` / ``StaticCache`` step by step, both
layer types pre- and post-LN with ``fused_ln`` on and off, the y-only
post-LN join against the reference's ``fused_add_layer_norm`` (Pallas in
interpret mode) in three dtype mixes, ``Transformer`` with its gradients
at dropout 0 and 0.1 (the same masks from a shared seed), the shared
``_clone_args`` bias defect, and ``chip_smoke.py``'s Transformer-base
harness at a tiny width: 3 ``to_static`` O1 steps against the
reference's, and its cached and uncached greedy decodes. At head_dim 64
(width 128, 2 heads) unmasked attention takes the port's flash wrappers
(their plain versions on the CPU) and the reference's Pallas kernel.

Tolerances: f32 outputs within 1e-5 (absolute and relative), gradients
within 1e-4 of each tensor's largest magnitude (the key projection's
bias, whose exact gradient is 0, below 1e-5 in both), bf16 within 2^-7
of the largest magnitude; O1 losses within 2^-7 of the loss, and the
O1 harness's gradients, updates and changes within the bf16 limits that
``test_harness_to_static_o1_steps_match_the_reference`` states (its f32
gradients within 1e-4 of each tensor's largest magnitude).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as Pnn
import paddle_tpu.nn.functional as PF
from paddle_tpu.framework import state as ref_state
from paddle_tpu.ops.pallas.norm import fused_add_layer_norm as ref_add_ln

import paddle_tpu_torch as T
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import flash_attention, norm

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

E, H, FFN = 128, 2, 256            # head_dim 64: the flash wrappers
B, SQ, SK = 2, 12, 20
BF16_REL = 2.0 ** -7


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6), err


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()
    return np.array(t._value if hasattr(t, "_value") else t, np.float32)


def _cross(ref, port):
    """The reference's weights into the port, by name."""
    load_numpy_state_dict(port, {k: np.asarray(t._value)
                                 for k, t in ref.state_dict().items()})


def _pair(ref_cls, port_cls, *args, **kw):
    P.seed(0)
    ref = ref_cls(*args, **kw)
    port = port_cls(*args, device="cpu", **kw)
    _cross(ref, port)
    return ref, port


def _ref_run(layer, fn, arrays, cot):
    """Output of ``fn(*arrays)``, the gradients of ``sum(out * cot)``
    with respect to each array and each named parameter."""
    ts = [P.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * P.to_tensor(cot)).sum().backward()
    params = {k: _np(p.grad) for k, p in layer.named_parameters()
              if p.grad is not None}
    return _np(out), [_np(t.grad) for t in ts], params


def _port_run(layer, fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.tensor(cot)).sum().backward()
    params = {k: _np(p.grad) for k, p in layer.named_parameters()
              if p.grad is not None}
    return _np(out), [_np(t.grad) for t in ts], params


def _held(ref_res, port_res):
    (r_out, r_in, r_par), (p_out, p_in, p_par) = ref_res, port_res
    _close(p_out, r_out)
    for g, w in zip(p_in, r_in):
        _rel_close(g, w)
    assert sorted(p_par) == sorted(r_par)
    for k in r_par:
        if k.endswith("k_proj.bias"):
            # a bias on every key shifts a row's scores alike: its exact
            # gradient is 0, and both packages give rounding noise
            assert np.abs(p_par[k]).max() < 1e-5 > np.abs(r_par[k]).max()
            continue
        _rel_close(p_par[k], r_par[k])


def _masks(kind, sq, sk):
    rng = _rng(7)
    if kind == "none":
        return None, None
    if kind == "bool":
        m = rng.random((B, 1, sq, sk)) < 0.8
        m[..., 0] = True
        return P.to_tensor(m), torch.tensor(m)
    m = np.where(rng.random((sq, sk)) < 0.8, 0.0, -1e4).astype(np.float32)
    return P.to_tensor(m), torch.tensor(m)


# --------------------------------------------------- multi-head attention
@pytest.mark.parametrize("mask", ["none", "bool", "additive"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
def test_attention_output_and_gradients(cross, mask):
    """Self-attention and cross-attention with sq != sk; without a mask
    both packages take flash (the reference's Pallas kernel, the port's
    flash wrappers), with one the composition."""
    ref, port = _pair(Pnn.MultiHeadAttention, nn.MultiHeadAttention, E, H)
    rng = _rng(1)
    sk = SK if cross else SQ
    q = rng.standard_normal((B, SQ, E)).astype(np.float32)
    kv = rng.standard_normal((B, sk, E)).astype(np.float32)
    cot = rng.standard_normal((B, SQ, E)).astype(np.float32)
    rm, pm = _masks(mask, SQ, sk)
    before = flash_attention.ROUTED["flash_attention"]
    if cross:
        want = _ref_run(ref, lambda a, b: ref(a, b, b, rm), [q, kv], cot)
        got = _port_run(port, lambda a, b: port(a, b, b, pm), [q, kv], cot)
    else:
        want = _ref_run(ref, lambda a: ref(a, attn_mask=rm), [q], cot)
        got = _port_run(port, lambda a: port(a, attn_mask=pm), [q], cot)
    _held(want, got)
    assert flash_attention.ROUTED["flash_attention"] == before


def test_need_weights_is_stored_and_not_read():
    ref, port = _pair(Pnn.MultiHeadAttention, nn.MultiHeadAttention, E, H,
                      need_weights=True)
    assert ref.need_weights and port.need_weights
    x = _rng(2).standard_normal((B, SQ, E)).astype(np.float32)
    _close(port(torch.tensor(x)).detach(), _np(ref(P.to_tensor(x))))


@pytest.fixture(scope="module")
def decode_pair():
    ref, port = _pair(Pnn.MultiHeadAttention, nn.MultiHeadAttention, E, H)
    rng = _rng(3)
    memory = rng.standard_normal((B, SK, E)).astype(np.float32)
    steps = rng.standard_normal((B, 5, E)).astype(np.float32)
    return ref, port, memory, steps


def test_cache_and_static_cache_decode_step_by_step(decode_pair):
    """A self-attention ``Cache`` grown a token at a time, and a
    cross-attention ``StaticCache`` over a memory: each step's output and
    the caches' keys and values equal the reference's."""
    ref, port, memory, steps = decode_pair
    rc = ref.gen_cache(P.to_tensor(steps))
    pc = port.gen_cache(torch.tensor(steps))
    rs = ref.gen_cache(P.to_tensor(memory), P.to_tensor(memory),
                       Pnn.MultiHeadAttention.StaticCache)
    ps = port.gen_cache(torch.tensor(memory), torch.tensor(memory),
                        nn.MultiHeadAttention.StaticCache)
    _close(ps.k.detach(), _np(rs.k))
    with torch.no_grad():
        for t in range(steps.shape[1]):
            x = steps[:, t:t + 1]
            r_out, rc = ref(P.to_tensor(x), cache=rc)
            p_out, pc = port(torch.tensor(x), cache=pc)
            _close(p_out, _np(r_out))
            assert pc.k.shape == (B, t + 1, H, E // H)
            _close(pc.v, _np(rc.v))
            r_out, rs = ref(P.to_tensor(x), P.to_tensor(memory),
                            P.to_tensor(memory), cache=rs)
            p_out, ps = port(torch.tensor(x), torch.tensor(memory),
                             torch.tensor(memory), cache=ps)
            _close(p_out, _np(r_out))
            assert isinstance(ps, nn.MultiHeadAttention.StaticCache)


def test_gen_cache_f32_zeros_promote_a_bf16_step(decode_pair):
    """``gen_cache`` makes f32 zeros ``[b, 0, heads, head_dim]`` in both
    packages, so under O1 a step's bf16 keys concatenate to f32 keys
    while the queries stay bf16: a defect both share."""
    ref, port, _, steps = decode_pair
    rc = ref.gen_cache(P.to_tensor(steps))
    pc = port.gen_cache(torch.tensor(steps))
    assert tuple(rc.k.shape) == tuple(pc.k.shape) == (B, 0, H, E // H)
    assert str(rc.k.dtype).endswith("float32") and pc.k.dtype == torch.float32
    x = steps[:, :1]
    with P.amp.auto_cast(level="O1", dtype="bfloat16"):
        _, rc = ref(P.to_tensor(x), cache=rc)
    with torch.no_grad(), T.amp.auto_cast(level="O1", dtype="bfloat16"):
        q, _, _, _ = port._prepare_qkv(torch.tensor(x), torch.tensor(x),
                                       torch.tensor(x), pc)
        _, pc = port(torch.tensor(x), cache=pc)
    assert str(rc.k.dtype).endswith("float32")
    assert pc.k.dtype == torch.float32 and q.dtype == torch.bfloat16


def test_attr_forms():
    """``bias_attr=False`` drops every projection's bias; any other
    ParamAttr waits for nn/initializer.py."""
    ref, port = _pair(Pnn.MultiHeadAttention, nn.MultiHeadAttention, E, H,
                      bias_attr=False)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    assert port.q_proj.bias is None
    with pytest.raises(NotImplementedError, match="A.7"):
        nn.MultiHeadAttention(E, H, weight_attr=object())
    with pytest.raises(NotImplementedError, match="A.7"):
        nn.TransformerEncoderLayer(E, H, FFN, bias_attr=object())


# ------------------------------------------------------------- the layers
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_ln"])
@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_encoder_layer(pre, fused):
    ref, port = _pair(Pnn.TransformerEncoderLayer, nn.TransformerEncoderLayer,
                      E, H, FFN, dropout=0.0, normalize_before=pre,
                      fused_ln=fused)
    rng = _rng(4)
    x = rng.standard_normal((B, SQ, E)).astype(np.float32)
    cot = rng.standard_normal((B, SQ, E)).astype(np.float32)
    before = dict(norm.ROUTED)
    _held(_ref_run(ref, ref, [x], cot), _port_run(port, port, [x], cot))
    assert dict(norm.ROUTED) == before


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_ln"])
@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_decoder_layer(pre, fused):
    ref, port = _pair(Pnn.TransformerDecoderLayer, nn.TransformerDecoderLayer,
                      E, H, FFN, dropout=0.0, normalize_before=pre,
                      fused_ln=fused)
    rng = _rng(5)
    tgt = rng.standard_normal((B, SQ, E)).astype(np.float32)
    mem = rng.standard_normal((B, SK, E)).astype(np.float32)
    cot = rng.standard_normal((B, SQ, E)).astype(np.float32)
    r_mask = Pnn.Transformer.generate_square_subsequent_mask(SQ)
    p_mask = nn.Transformer.generate_square_subsequent_mask(SQ)
    _close(p_mask.numpy(), np.asarray(r_mask._value))
    _held(_ref_run(ref, lambda a, m: ref(a, m, r_mask), [tgt, mem], cot),
          _port_run(port, lambda a, m: port(a, m, p_mask), [tgt, mem], cot))


MIXES = [("float32", "float32", "float32"), ("bfloat16", "float32", "float32"),
         ("bfloat16", "bfloat16", "float32")]


@pytest.mark.parametrize("mix", MIXES, ids=["-".join(m) for m in MIXES])
def test_y_only_join_against_the_pallas_kernel(mix):
    """``F.fused_add_layer_norm`` (the kernel's y-only entry) against the
    reference's ``fused_add_layer_norm`` in interpret mode: y and all
    four gradients, dx in x's type and dresidual in the residual's; the
    (bf16 x, f32 residual, f32 weights) mix is the O1 post-LN join's."""
    xd, rd, wd = mix
    rng = _rng(6)
    x, r, cot = (rng.standard_normal((B * SQ, E)).astype(np.float32)
                 for _ in range(3))
    w = (1 + 0.1 * rng.standard_normal(E)).astype(np.float32)
    b = (0.1 * rng.standard_normal(E)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jx, jr, jw, jb = (jnp.asarray(a, jdt[d]) for a, d in
                      ((x, xd), (r, rd), (w, wd), (b, wd)))
    y, vjp = jax.vjp(lambda *a: ref_add_ln(*a, 1e-5), jx, jr, jw, jb)
    ref_grads = vjp(jnp.asarray(cot, y.dtype))
    tx, tr, tw, tb = (torch.tensor(a).to(tdt[d]).requires_grad_()
                      for a, d in ((x, xd), (r, rd), (w, wd), (b, wd)))
    before = norm.ROUTED["fused_add_layer_norm"]
    got = F.fused_add_layer_norm(tx, tr, tw, tb, 1e-5)
    assert norm.ROUTED["fused_add_layer_norm"] == before
    assert str(got.dtype).split(".")[1] == str(y.dtype)
    got.backward(torch.tensor(cot).to(got.dtype))
    narrow = got.dtype == torch.bfloat16
    (_rel_close(_np(got), np.asarray(y, np.float32), BF16_REL) if narrow
     else _close(_np(got), np.asarray(y, np.float32)))
    for t, g in zip((tx, tr, tw, tb), ref_grads):
        assert str(t.grad.dtype).split(".")[1] == str(g.dtype)
        _rel_close(_np(t.grad), np.asarray(g, np.float32),
                   BF16_REL if t.grad.dtype == torch.bfloat16 else 1e-4)


# ------------------------------------------------------------ Transformer
WIDTHS = dict(d_model=E, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
              dim_feedforward=FFN)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_transformer_output_and_gradients(dropout):
    """``Transformer`` (post-LN, plain joins) with a causal target mask:
    the output and every gradient; at dropout 0.1 every attention takes
    the composition and both packages draw the same masks from one
    seed."""
    ref, port = _pair(Pnn.Transformer, nn.Transformer, dropout=dropout,
                      **WIDTHS)
    rng = _rng(8)
    src = rng.standard_normal((B, SK, E)).astype(np.float32)
    tgt = rng.standard_normal((B, SQ, E)).astype(np.float32)
    cot = rng.standard_normal((B, SQ, E)).astype(np.float32)
    r_mask = Pnn.Transformer.generate_square_subsequent_mask(SQ)
    p_mask = nn.Transformer.generate_square_subsequent_mask(SQ)
    P.seed(11)
    want = _ref_run(ref, lambda s, t: ref(s, t, tgt_mask=r_mask),
                    [src, tgt], cot)
    T.seed(11)
    got = _port_run(port, lambda s, t: port(s, t, tgt_mask=p_mask),
                    [src, tgt], cot)
    _held(want, got)
    assert np.array_equal(np.asarray(ref_state.get_rng_state()),
                          T.get_rng_state().numpy())


@pytest.mark.parametrize("pre", [False, True], ids=["post", "pre"])
def test_state_dict_names_equal_the_reference(pre):
    P.seed(0)
    ref = Pnn.Transformer(normalize_before=pre, **WIDTHS)
    port = nn.Transformer(normalize_before=pre, device="cpu", **WIDTHS)
    keys = list(port.state_dict())
    assert sorted(keys) == sorted(ref.state_dict())
    assert ("encoder.norm.weight" in keys) == pre
    for k, t in ref.state_dict().items():
        assert tuple(port.state_dict()[k].shape) == tuple(t.shape)


def test_a_default_build_draws_every_weight_apart():
    """``nn.Transformer()`` at its defaults, built without a generator:
    one generator runs through the whole model, so no two of its weights
    start equal, within a layer, across layers, or between the encoder
    and the decoder (as the reference draws each from its global key).
    Two such builds are equal."""
    model = nn.Transformer(device="cpu")
    weights = [(k, t) for k, t in model.state_dict().items()
               if k.endswith("weight") and "norm" not in k]
    assert len(weights) == 6 * 6 + 6 * 10
    seen = {}
    for k, t in weights:
        key = (tuple(t.shape), float(t.flatten()[0]), float(t.flatten()[-1]))
        assert key not in seen, (k, seen.get(key))
        seen[key] = k
    attn = model.encoder.layers[0].self_attn
    assert not torch.equal(attn.q_proj.weight, attn.k_proj.weight)
    again = nn.Transformer(num_encoder_layers=1, num_decoder_layers=1,
                           device="cpu").state_dict()
    first = nn.Transformer(num_encoder_layers=1, num_decoder_layers=1,
                           device="cpu").state_dict()
    assert all(torch.equal(first[k], again[k]) for k in first)


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_clone_args_drops_bias_attr_as_the_reference(kind):
    """``_clone_args`` carries no ``bias_attr``: the first layer has no
    biases and its clones have them, in both packages."""
    ref_layer, port_layer = {
        "encoder": (Pnn.TransformerEncoderLayer, nn.TransformerEncoderLayer),
        "decoder": (Pnn.TransformerDecoderLayer,
                    nn.TransformerDecoderLayer)}[kind]
    ref_stack, port_stack = {
        "encoder": (Pnn.TransformerEncoder, nn.TransformerEncoder),
        "decoder": (Pnn.TransformerDecoder, nn.TransformerDecoder)}[kind]
    P.seed(0)
    ref = ref_stack(ref_layer(32, 2, 64, bias_attr=False), 3)
    port = port_stack(port_layer(32, 2, 64, bias_attr=False, device="cpu"),
                      3)
    keys = set(port.state_dict())
    assert keys == set(ref.state_dict())
    assert "layers.0.linear1.bias" not in keys
    assert "layers.1.linear1.bias" in keys and "layers.2.self_attn." \
        "q_proj.bias" in keys


# ---------------------------------------------- the Transformer-base harness
HARNESS = dict(vocab=64, max_len=16, d_model=E, nhead=H,
               num_encoder_layers=1, num_decoder_layers=1,
               dim_feedforward=FFN, dropout=0.0)
HB, HS = 2, 16


class RefTransformerLM(Pnn.Layer):
    """``chip_smoke.TransformerLM`` from the reference's public layers."""

    def __init__(self, vocab, max_len, fused_ln, **widths):
        super().__init__()
        d, p = widths["d_model"], widths["dropout"]
        self.embed = Pnn.Embedding(vocab, d, weight_attr=P.ParamAttr(
            initializer=Pnn.initializer.Normal(0.0, d ** -0.5)))
        layer = dict(d_model=d, nhead=widths["nhead"],
                     dim_feedforward=widths["dim_feedforward"], dropout=p,
                     fused_ln=fused_ln)
        self.transformer = Pnn.Transformer(
            **widths,
            custom_encoder=Pnn.TransformerEncoder(
                Pnn.TransformerEncoderLayer(**layer),
                widths["num_encoder_layers"]),
            custom_decoder=Pnn.TransformerDecoder(
                Pnn.TransformerDecoderLayer(**layer),
                widths["num_decoder_layers"]))
        self.drop = Pnn.Dropout(p)
        self._pos = chip_smoke.sinusoid_table(max_len, d)
        self.scale = float(np.sqrt(d))

    def embed_tokens(self, ids):
        pos = P.to_tensor(self._pos[:ids.shape[1]])
        return self.drop(self.embed(ids) * self.scale + pos)

    def forward(self, src, tgt, tgt_mask):
        h = self.transformer(self.embed_tokens(src), self.embed_tokens(tgt),
                             tgt_mask=tgt_mask)
        return P.matmul(h, self.embed.weight, transpose_y=True)


def _ref_harness():
    widths = {k: v for k, v in HARNESS.items() if k not in ("vocab",
                                                            "max_len")}
    P.seed(0)
    model = RefTransformerLM(HARNESS["vocab"], HARNESS["max_len"], True,
                             **widths)
    sched = P.optimizer.lr.NoamDecay(E, chip_smoke.TB_WARMUP)
    opt = P.optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                           epsilon=1e-9, parameters=model.parameters())
    vocab = HARNESS["vocab"]

    @P.jit.to_static
    def train_step(src, tgt_in, tgt_out, mask):
        opt.clear_grad()
        with P.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = model(src, tgt_in, mask)
            loss = PF.cross_entropy(logits.reshape([-1, vocab]),
                                    tgt_out.reshape([-1]),
                                    label_smoothing=chip_smoke.TB_SMOOTHING)
        loss.backward()
        opt.step()
        return loss

    return model, train_step, sched, opt


def _noam(epoch):
    """NoamDecay(d_model E, warmup)'s lr after ``epoch`` steps of the
    scheduler, which reads epoch 0 as 1."""
    step, w = max(epoch, 1), chip_smoke.TB_WARMUP
    return E ** -0.5 * min(step ** -0.5, step * w ** -1.5)


@pytest.fixture(scope="module")
def harness():
    """Both harnesses from the reference's weights, a batch, and the
    reference's record of its 3 steps: the losses, the lr each step ran
    at, the gradients and weights after step 1, and the weights after
    step 3."""
    ref, ref_step, ref_sched, ref_opt = _ref_harness()
    init = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    rng = _rng(9)
    vocab = HARNESS["vocab"]
    src = rng.integers(1, vocab, (HB, HS))
    tgt = rng.integers(1, vocab, (HB, HS + 1))
    batch = (src, tgt[:, :-1], tgt[:, 1:])
    mask = Pnn.Transformer.generate_square_subsequent_mask(HS)
    rec = {"losses": [], "lrs": []}
    for i in range(3):
        rec["lrs"].append(ref_opt.get_lr())
        rec["losses"].append(float(ref_step(
            *(P.to_tensor(a, dtype="int64") for a in batch), mask)))
        ref_sched.step()
        if i == 0:
            rec["grads"] = {k: _np(p.grad) for k, p in ref.named_parameters()}
            rec["step1"] = {k: _np(p) for k, p in ref.named_parameters()}
    rec["after"] = {k: np.asarray(t._value, np.float32)
                    for k, t in ref.state_dict().items()}
    return init, batch, rec


def _port_harness(init):
    widths = {k: v for k, v in HARNESS.items() if k not in ("vocab",
                                                            "max_len")}
    model, step, opt, after = chip_smoke.transformer_build(
        True, device="cpu", vocab=HARNESS["vocab"],
        max_len=HARNESS["max_len"], **widths)
    load_numpy_state_dict(model, init)
    return model, step, opt, after


def test_harness_state_dict_crosses_by_name(harness):
    init = harness[0]
    model = _port_harness(init)[0]
    assert sorted(model.state_dict()) == sorted(init)


def _fro(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_harness_to_static_o1_steps_match_the_reference(harness):
    """Three captured (on the CPU: eager under ``to_static``) O1 steps of
    Transformer-base's step, NoamDecay stepped after each, against the
    reference's: the lr tensor at NoamDecay's value before each step;
    losses within 2^-7, falling; after step 1 each gradient within 2^-5
    of its norm (the key biases, whose exact gradient is 0, below 1e-4 in
    both), and 95 % of each tensor's elements moved as the reference's
    within 1 % of lr (Adam's first step moves a weight by lr times its
    gradient's sign: bf16 rounding flips the few near zero); after step
    3, 90 % of each tensor's elements changed since the start as the
    reference's within 5 % of the 3 steps' summed lr (an lr that did not
    step would part by 25 %). The O1 limits are bf16's: the same step in
    f32 agrees within 1e-6 of each gradient's largest magnitude
    (``test_harness_f32_gradients_match_the_reference``); under O1 the two
    packages' gradients part by up to 2.6 % of their norm, at least 97.6 %
    of a tensor's elements move alike in step 1 and 96.9 % within 5 %
    after 3 steps."""
    init, batch, rec = harness
    model, step, opt, after = _port_harness(init)
    mask = nn.Transformer.generate_square_subsequent_mask(HS)
    losses = []
    for i in range(3):
        lr = float(opt._lr_tensor)
        assert rec["lrs"][i] == pytest.approx(_noam(i), rel=1e-12)
        assert lr == np.float32(rec["lrs"][i]), (i, lr, rec["lrs"][i])
        losses.append(float(step(*(torch.tensor(a) for a in batch), mask)))
        after()
        if i == 0:
            grads = {k: _np(p.grad) for k, p in model.named_parameters()}
            step1 = {k: _np(p) for k, p in model.named_parameters()}
    for got, want in zip(losses, rec["losses"]):
        assert abs(got - want) <= BF16_REL * abs(want), (losses, rec)
    assert losses[-1] < losses[0]
    assert sorted(grads) == sorted(rec["grads"])
    lr1 = _noam(0)
    for k, want in rec["grads"].items():
        if k.endswith("k_proj.bias"):
            assert np.abs(grads[k]).max() < 1e-4 > np.abs(want).max(), k
            continue
        assert _fro(grads[k], want) <= 2.0 ** -5, (k, _fro(grads[k], want))
        moved = step1[k] - init[k]
        ref_moved = rec["step1"][k] - init[k]
        share = np.mean(np.abs(moved - ref_moved) <= 0.01 * lr1)
        assert share >= 0.95, (k, share)
    state = model.state_dict()
    total = sum(_noam(i) for i in range(3))
    for k, want in rec["after"].items():
        if k.endswith("k_proj.bias"):
            continue
        change = _np(state[k]) - init[k]
        share = np.mean(np.abs(change - (want - init[k])) <= 0.05 * total)
        assert share >= 0.9, (k, share)


def test_harness_f32_gradients_match_the_reference(harness):
    """The harness's loss in f32 (no autocast) and its gradients on the
    same weights and batch: the tied embedding's (its lookup and the
    output product ``matmul(h, weight, transpose_y=True)``), the label-
    smoothed cross entropy's, every layer's: within 1e-5 for the loss and
    1e-4 of each gradient's largest magnitude (the key biases, whose
    exact gradient is 0, below 1e-5 in both)."""
    init, batch = harness[0], harness[1]
    vocab = HARNESS["vocab"]
    widths = {k: v for k, v in HARNESS.items() if k not in ("vocab",
                                                            "max_len")}
    ref = RefTransformerLM(vocab, HARNESS["max_len"], True, **widths)
    ref.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
    r_ids = [P.to_tensor(a, dtype="int64") for a in batch]
    r_loss = PF.cross_entropy(
        ref(r_ids[0], r_ids[1],
            Pnn.Transformer.generate_square_subsequent_mask(HS)).reshape(
                [-1, vocab]), r_ids[2].reshape([-1]),
        label_smoothing=chip_smoke.TB_SMOOTHING)
    r_loss.backward()
    model = _port_harness(init)[0]
    ids = [torch.tensor(a) for a in batch]
    loss = F.cross_entropy(
        model(ids[0], ids[1],
              nn.Transformer.generate_square_subsequent_mask(HS)).reshape(
                  [-1, vocab]), ids[2].reshape([-1]),
        label_smoothing=chip_smoke.TB_SMOOTHING)
    loss.backward()
    _close(float(loss), float(r_loss))
    _held((_np(r_loss), [], {k: _np(p.grad)
                             for k, p in ref.named_parameters()}),
          (_np(loss), [], {k: _np(p.grad)
                           for k, p in model.named_parameters()}))


def test_harness_greedy_decode_cached_equals_uncached(harness):
    """``chip_smoke._greedy`` on the tiny harness in f32: the cached
    decode (``Cache`` + ``StaticCache``, flash at one query row) and the
    uncached one (the whole prefix under the causal mask) give the same
    tokens, logits within 1e-4 of their largest magnitude, and the
    reference's decoder run through its own caches gives the same
    tokens."""
    init, batch = harness[0], harness[1]
    model = _port_harness(init)[0].eval()
    src = torch.tensor(batch[0])
    with torch.no_grad():
        memory = model.transformer.encoder(model.embed_tokens(src))
        cached = chip_smoke._greedy(model, memory, src[:, :1], True, 6)
        uncached = chip_smoke._greedy(model, memory, src[:, :1], False, 6)
    assert torch.equal(cached[0], uncached[0])
    _rel_close(cached[1], uncached[1].numpy(), 1e-4)
    widths = {k: v for k, v in HARNESS.items() if k not in ("vocab",
                                                            "max_len")}
    ref = RefTransformerLM(HARNESS["vocab"], HARNESS["max_len"], True,
                           **widths)
    ref.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
    ref.eval()
    rsrc = P.to_tensor(batch[0], dtype="int64")
    rmem = ref.transformer.encoder(ref.embed_tokens(rsrc))
    _close(memory.numpy(), _np(rmem))
    caches = ref.transformer.decoder.gen_cache(rmem)
    tok, tokens = batch[0][:, :1], []
    pos = chip_smoke.sinusoid_table(HARNESS["max_len"], E)
    for t in range(6):
        x = ref.embed(P.to_tensor(tok, dtype="int64")) * ref.scale \
            + P.to_tensor(pos[t:t + 1])
        h, caches = ref.transformer.decoder(x, rmem, None, None, caches)
        logits = P.matmul(h, ref.embed.weight, transpose_y=True)
        tok = np.asarray(logits._value)[:, -1].argmax(-1)[:, None]
        tokens.append(tok)
    assert np.array_equal(np.concatenate(tokens, 1), cached[0].numpy())
