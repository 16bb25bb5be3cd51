"""paddle_tpu_torch Mixture-of-Experts: the port's ``distributed/moe.py``,
``tensor.rand`` / ``tensor.topk`` and GPT's MoE blocks against the
reference package on shared weights (numpy, seeded), covering each
contract of ``tests/test_moe.py`` that runs on one device, plus tied
rows, the bf16 ``cumsum`` past 256, a MoE GPT's logits, aux loss and
``to_static`` steps, and the serving engine's tokens.

Tolerances: f32 outputs, aux losses and gradients within 1e-5 (2e-5
against the numpy oracle, the reference's own); a tiny MoE GPT's
logits and f32 losses within 1e-4 (the GPT tests' tolerance); routing
tensors and random draws exact; the bf16-policy losses within 0.05
(the reference's bf16 contract); tokens exact.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu.distributed.moe as ref_moe
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCrit
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny

import paddle_tpu_torch as T
from paddle_tpu_torch import serving
from paddle_tpu_torch.distributed import moe
from paddle_tpu_torch.framework.io import load_numpy_state_dict, numpy_grads
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)
from paddle_tpu_torch.tensor import rand, topk

MOE = dict(moe_num_experts=4, moe_top_k=2, moe_every=2, moe_gate="gshard")
ENGINE_KW = dict(max_num_seqs=4, page_size=4, max_model_len=48,
                 prefill_buckets=(8, 32))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._value if hasattr(t, "_value") else t,
                      dtype=np.float32)


def _sd(layer):
    return {k: np.asarray(t._value) for k, t in layer.state_dict().items()}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _probs(rng, n, e):
    p = np.abs(rng.random((n, e)).astype(np.float32)) + 1e-3
    return p / p.sum(-1, keepdims=True)


# ---------------------------------------------------------- rand, topk
def test_rand_draws_the_reference_values_from_a_shared_seed():
    for seed in (0, 11):
        P.seed(seed)
        T.seed(seed)
        for shape in ([5], [3, 7], [2, 1, 4]):
            want = np.asarray(P.rand(shape, dtype="float32")._value)
            got = rand(shape)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(NotImplementedError):
        rand([2], dtype="float16")


def test_topk_breaks_ties_as_jax():
    row = np.full((1, 8), 0.125, np.float32)
    tied = np.array([[0.1, 0.3, 0.3, 0.1, 0.2, 0.3, 0.0, 0.0],
                     [0.5, 0.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for x in (row, tied, np.random.default_rng(0).random((6, 8), np.float32)):
        for k in (1, 2, 3):
            want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
            got_v, got_i = topk(torch.tensor(x), k)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    _, idx = topk(torch.tensor(row), 2)
    assert idx.tolist() == [[0, 1]]      # torch.topk: [6, 5] on the CPU
    vals, idx = topk(torch.tensor(tied), 2, largest=False)
    assert idx.tolist() == [[6, 7], [2, 3]]


# ---------------------------------------------------- dispatch/combine
def _both_routing(p, top_k, capacity, kl=None, dtype=np.float32):
    """The port's and the reference's (combine, dispatch) of ``p``."""
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    want = ref_moe.gshard_dispatch_combine(
        jnp.asarray(p).astype(jdt), top_k, capacity,
        None if kl is None else jnp.asarray(kl))
    got = moe.dispatch_combine(torch.tensor(p).to(tdt), top_k, capacity,
                               None if kl is None else torch.tensor(kl))
    for g, w in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_array_equal(_np(g),
                                      np.asarray(w.astype(jnp.float32)))
    return got


def test_routes_every_token_under_ample_capacity():
    p = _probs(np.random.RandomState(0), 12, 4)
    combine, dispatch = _both_routing(p, 2, 12)
    d = dispatch.numpy()
    assert d.shape == (12, 4, 12)
    np.testing.assert_allclose(d.sum(axis=(1, 2)), 2.0)
    top2 = -np.sort(-p, axis=-1)[:, :2].sum(-1)
    np.testing.assert_allclose(combine.numpy().sum(axis=(1, 2)), top2,
                               rtol=1e-6)


def test_capacity_drops_lowest_priority_tokens():
    p = np.full((6, 3), 1e-3, np.float32)
    p[:, 0] = 0.9
    _, dispatch = _both_routing(p, 1, 2)
    d = dispatch.numpy()
    assert d[:, 0].sum() == 2.0
    np.testing.assert_allclose(d.sum(axis=(1, 2))[:2], 1.0)
    np.testing.assert_allclose(d.sum(axis=(1, 2))[2:], 0.0)


def test_top1_priority_beats_top2():
    p = np.array([[0.4, 0.6, 0.0], [0.9, 0.05, 0.05], [0.9, 0.05, 0.05]],
                 np.float32)
    _, dispatch = _both_routing(p, 2, 2)
    d = dispatch.numpy()
    assert d[1, 0].sum() == 1.0 and d[2, 0].sum() == 1.0
    assert d[0, 0].sum() == 0.0


def test_tied_rows_and_keep_last_route_as_the_reference():
    """Rows of equal probabilities (a LayerNorm's bias row gives them)
    claim the lower experts, as jax.lax.top_k orders them; keep_last
    drops the second choice where it is 0."""
    p = _probs(np.random.RandomState(1), 10, 4)
    p[::3] = 0.25                                   # tied rows
    kl = np.array([1, 0, 1, 1, 0, 1, 0, 1, 1, 0], np.float32)
    _, dispatch = _both_routing(p, 2, 3, kl)
    d = dispatch.numpy()
    assert d[0, 0].sum() == 1.0 and d[0, 2:].sum() == 0.0   # experts 0, 1
    assert d[1].sum() == 1.0                        # its 2nd choice dropped


def test_bf16_cumsum_past_256_shares_slots_as_the_reference():
    """384 tokens all choosing expert 0 in bf16: the ranks past 256 round
    to bf16 as jnp.cumsum's do (… 256, 256, 258, 260, 260, 260, 262), so
    the routing tensors equal the reference's bit for bit, and past rank
    256 several tokens share one slot: a defect both packages share."""
    p = np.full((384, 2), 0.25, np.float32)
    p[:, 0] = 0.75
    _, dispatch = _both_routing(p, 1, 384, dtype="bf16")
    per_slot = dispatch.float().sum(dim=0)[0]       # [C] of expert 0
    assert per_slot[:255].eq(1.0).all()
    assert per_slot[255:].max().item() > 1.0


# ------------------------------------------------------------- the layer
def _np_moe_oracle(x, gate_w, gate_b, w1, b1, w2, b2, top_k):
    n, d = x.shape
    logits = x @ gate_w + gate_b
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
    out = np.zeros_like(x)
    for i in range(n):
        for k in range(top_k):
            e = order[i, k]
            h = np.maximum(x[i] @ w1[e] + b1[e], 0.0)
            out[i] += probs[i, e] * (h @ w2[e] + b2[e])
    return out


def _pair(d, experts, gate, capacity, ref_experts=None):
    """A reference MoELayer (seeded) and the port's on its weights."""
    P.seed(0)
    ref = ref_moe.MoELayer(d, ref_experts(), gate=gate,
                           capacity_factor=capacity)
    port = moe.MoELayer(d, experts(), gate=gate, capacity_factor=capacity,
                        device="cpu")
    load_numpy_state_dict(port, _sd(ref))
    return ref, port


def _stacked(e, d, h, act="gelu"):
    return (lambda: moe.StackedExpertFFN(e, d, h, activation=act,
                                         device="cpu"),
            lambda: ref_moe.StackedExpertFFN(e, d, h, activation=act))


def test_matches_numpy_oracle_with_relu_experts():
    d, dh, E, K, n = 16, 24, 4, 2, 10
    mine, theirs = _stacked(E, d, dh, "relu")
    ref, port = _pair(d, mine, {"type": "naive", "top_k": K},
                      (float(n), float(n)), theirs)
    x = np.random.RandomState(1).randn(2, 5, d).astype(np.float32)
    got = port(torch.tensor(x))
    _close(got, ref(P.to_tensor(x)))
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    want = _np_moe_oracle(x.reshape(n, d), sd["gate.gate.weight"],
                          sd["gate.gate.bias"], sd["experts.w1"],
                          sd["experts.b1"], sd["experts.w2"],
                          sd["experts.b2"], K)
    np.testing.assert_allclose(got.detach().numpy().reshape(n, d), want,
                               atol=2e-5, rtol=2e-5)


def test_module_list_experts_and_grads():
    d = 8
    ref, port = _pair(
        d, lambda: [T.nn.Linear(d, d, device="cpu") for _ in range(2)],
        {"type": "naive", "top_k": 1}, (8.0, 8.0),
        lambda: [P.nn.Linear(d, d) for _ in range(2)])
    x = np.random.RandomState(2).randn(4, 2, d).astype(np.float32)
    y = port(torch.tensor(x))
    assert tuple(y.shape) == (4, 2, d)
    (y * y).mean().backward()
    ry = ref(P.to_tensor(x))
    (ry * ry).mean().backward()
    _close(y, ry)
    grads = numpy_grads(port)
    assert sorted(grads) == sorted(n for n, _ in ref.named_parameters())
    for name, p in ref.named_parameters():
        assert np.isfinite(grads[name]).all()
        np.testing.assert_allclose(grads[name], _np(p.grad), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("kind", ["gshard", "switch"])
def test_aux_losses_match_reference_and_formula(kind):
    d, E = 8, 4
    mine, theirs = _stacked(E, d, 8)
    gate = {"type": kind, "top_k": 2 if kind == "gshard" else 1}
    ref, port = _pair(d, mine, gate, (1.2, 2.4), theirs)
    ref.eval()
    port.eval()
    x = np.random.RandomState(3).randn(4, 2, d).astype(np.float32)
    port(torch.tensor(x))
    ref(P.to_tensor(x))
    loss = port.gate.get_loss()
    assert port.gate.get_loss() is None              # cleared on read
    _close(loss, ref.gate.get_loss())
    xf = x.reshape(-1, d)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    logits = xf @ sd["gate.gate.weight"] + sd["gate.gate.bias"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    share = np.bincount(probs.argmax(-1), minlength=E) / len(xf)
    want = ((share * probs.mean(0)).mean() * E * E if kind == "gshard"
            else (share * probs.mean(0)).sum() * E)
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)


@pytest.mark.parametrize("kind", ["switch", "gshard"])
def test_training_draws_match_reference_and_eval_is_deterministic(kind):
    """Switch's jitter and GShard's random second-expert routing draw the
    reference's values from a shared seed; two training calls differ;
    eval is deterministic."""
    d = 8
    mine, theirs = _stacked(4, d, 16 if kind == "switch" else 8)
    gate = {"type": kind, "top_k": 2 if kind == "gshard" else 1}
    ref, port = _pair(d, mine, gate, (64.0, 64.0), theirs)
    if kind == "gshard":
        assert port.gate.random_routing
    x = np.random.RandomState(7).randn(8, 4, d).astype(np.float32)
    P.seed(5)
    T.seed(5)
    a = port(torch.tensor(x))
    _close(a, ref(P.to_tensor(x)))
    b = port(torch.tensor(x))
    _close(b, ref(P.to_tensor(x)))
    assert not np.allclose(_np(a), _np(b))
    port.eval()
    ref.eval()
    c = port(torch.tensor(x))
    np.testing.assert_array_equal(_np(c), _np(port(torch.tensor(x))))
    _close(c, ref(P.to_tensor(x)))


def test_capacity_factor_forwarded_to_dict_gates():
    layer = moe.MoELayer(8, moe.StackedExpertFFN(2, 8, 8, device="cpu"),
                         gate={"type": "gshard", "top_k": 2},
                         capacity_factor=(64.0, 64.0), device="cpu")
    assert layer.capacity_factor == (64.0, 64.0)
    assert layer.gate.capacity_factor == (64.0, 64.0)
    with pytest.raises(ValueError, match="unknown gate"):
        moe.MoELayer(8, moe.StackedExpertFFN(2, 8, 8, device="cpu"),
                     gate={"type": "hash"}, device="cpu")


def test_dropped_tokens_fall_back_to_zero():
    d = 8
    mine, theirs = _stacked(2, d, 8)
    ref, port = _pair(d, mine, {"type": "naive", "top_k": 1}, (0.01, 0.01),
                      theirs)
    x = np.random.RandomState(5).randn(1, 6, d).astype(np.float32)
    y = port(torch.tensor(x))
    _close(y, ref(P.to_tensor(x)))
    assert (np.abs(_np(y)[0]).sum(-1) > 1e-7).sum() <= 2


# ------------------------------------------------------------ MoE GPT
@pytest.fixture(scope="module")
def gpt_pair():
    P.seed(0)
    ref = RefGPT(ref_tiny(**MOE))
    sd = _sd(ref)
    port = GPTForCausalLM(gpt3_tiny(**MOE), device="cpu")
    load_numpy_state_dict(port, sd)
    return ref, port, sd


def test_moe_gpt_logits_and_aux_loss_match_reference(gpt_pair):
    ref, port, sd = gpt_pair
    assert list(port.state_dict()) == list(sd)
    assert tuple(port.gpt.layers[1].mlp.experts.w1.shape) == (4, 64, 256)
    assert not hasattr(port.gpt.layers[0].mlp, "gate")
    ref.eval()
    port.eval()
    ids = np.random.default_rng(2).integers(0, 256, (2, 16))
    with torch.no_grad():
        got = port(torch.tensor(ids))
    _close(got, ref(P.to_tensor(ids)), 1e-4)
    _close(port.gpt.moe_aux_loss(), ref.gpt.moe_aux_loss(), 1e-5)
    assert float(port.gpt.moe_aux_loss()) == 0.0     # cleared on read
    dense = GPTForCausalLM(gpt3_tiny(), device="cpu")
    assert float(dense.gpt.moe_aux_loss()) == 0.0


def _ref_steps(sd, batches, amp_policy, remat=None):
    P.seed(0)
    model = RefGPT(ref_tiny(**MOE))
    model.set_state_dict({k: P.to_tensor(v) for k, v in sd.items()})
    crit = RefCrit()
    opt = P.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters())

    @P.jit.to_static(amp_policy=amp_policy, remat=remat)
    def step(ids, labels):
        opt.clear_grad()
        loss = crit(model(ids), labels) + 0.01 * model.gpt.moe_aux_loss()
        loss.backward()
        opt.step()
        return loss

    P.seed(9)
    return [float(step(*(P.to_tensor(a, dtype="int64") for a in b)))
            for b in batches]


def _port_steps(sd, batches, amp_policy, remat=None, aux=0.01):
    model = GPTForCausalLM(gpt3_tiny(**MOE), device="cpu")
    load_numpy_state_dict(model, sd)
    crit = GPTPretrainingCriterion()
    opt = T.optimizer.AdamW(learning_rate=1e-3,
                            parameters=model.parameters())

    @T.jit.to_static(amp_policy=amp_policy, remat=remat)
    def step(ids, labels):
        opt.clear_grad()
        loss = crit(model(ids), labels) + aux * model.gpt.moe_aux_loss()
        loss.backward()
        opt.step()
        return loss

    T.seed(9)
    losses = [step(*(torch.tensor(a) for a in b)).item() for b in batches]
    return losses, model


def _batches(n=2):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, 256, (4, 16)), rng.integers(0, 256, (4, 16)))
            for _ in range(n)]


def test_to_static_steps_match_reference(gpt_pair, monkeypatch):
    """Two to_static steps (criterion + 0.01 x aux loss, AdamW 1e-3,
    GShard's random routing drawn from one seed in both packages): f32
    losses within 1e-4; under the bf16 policy the probabilities,
    dispatch and combine take the reference's dtypes (f32: softmax is
    black-listed) and the losses stay within 0.05."""
    _, _, sd = gpt_pair
    batches = _batches()
    want = _ref_steps(sd, batches, None)
    got, _ = _port_steps(sd, batches, None)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[1] < got[0]

    seen = {"ref": [], "port": []}

    def spy(mod, tag):
        inner = mod.dispatch_combine

        def wrapped(probs, *a, **kw):
            out = inner(probs, *a, **kw)
            seen[tag].append(tuple(str(t.dtype).split(".")[-1]
                                   for t in (probs, *out)))
            return out
        monkeypatch.setattr(mod, "dispatch_combine", wrapped)

    spy(ref_moe, "ref")
    spy(moe, "port")
    want16 = _ref_steps(sd, batches, "bf16")
    got16, _ = _port_steps(sd, batches, "bf16")
    assert set(seen["port"]) == set(seen["ref"]) == {("float32",) * 3}
    np.testing.assert_allclose(got16, want16, atol=0.05, rtol=0)


def test_recompute_replays_the_routing_draws(gpt_pair):
    """to_static(remat=True) over the MoE blocks: the re-run draws the
    forward's random routing, so without the aux loss the losses and
    weights equal the plain steps' (within 1e-6). With it, the region's
    aux loss comes from its no-grad forward and carries no gradient; the
    reference's remat steps part from its plain ones too, and the port's
    equal them within 1e-4."""
    _, _, sd = gpt_pair
    batches = _batches()
    plain, m1 = _port_steps(sd, batches, None, aux=0.0)
    remat, m2 = _port_steps(sd, batches, None, remat=True, aux=0.0)
    np.testing.assert_allclose(remat, plain, atol=1e-6, rtol=0)
    for (n, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6,
                                   rtol=0, err_msg=n)
    got, _ = _port_steps(sd, batches, None, remat=True)
    want = _ref_steps(sd, batches, None, remat=True)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ------------------------------------------------------------- serving
SAMPLED = dict(temperature=0.7, top_k=20, top_p=0.9)


def test_engine_tokens_match_reference_engine(gpt_pair):
    """A 4-expert tiny MoE GPT served by both engines on one schedule:
    greedy tokens, and tokens sampled with a shared seed, equal."""
    ref, port, _ = gpt_pair
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (3, 7, 12, 5)]
    plans = [dict(), dict(SAMPLED)]
    want = []
    eng = ref_serving.LLMEngine(ref, ref_serving.EngineConfig(**ENGINE_KW))
    try:
        for knobs in plans:
            want.append([r.output_token_ids for r in eng.generate(
                prompts, [ref_serving.SamplingParams(
                    max_new_tokens=6, seed=i, **knobs)
                    for i in range(len(prompts))])])
    finally:
        eng.shutdown()
    ours = serving.LLMEngine(port, serving.EngineConfig(**ENGINE_KW),
                             device="cpu")
    for knobs, w in zip(plans, want):
        got = ours.generate(prompts, [serving.SamplingParams(
            max_new_tokens=6, seed=i, **knobs) for i in range(len(prompts))])
        assert [r.output_token_ids for r in got] == w
    assert want[0] != want[1]
