"""paddle_tpu_torch.observability.profile against the reference's roofline
profiler (``paddle_tpu/observability/profile.py``).

- the per-op cost conventions against the reference's ``eqn_cost`` on
  the same shapes: matmul, elementwise, reduction and convolution flops
  and their bytes, exactly;
- the tiny GPT train step of ``tools/perfgate.py:build_gpt_train_step``
  (gpt3_tiny, ids and labels 2 x 32, the loss under ``scope("loss")``),
  plain and in its optimized form (bf16 policy, fused AdamW), in both
  packages from the same weights: the same set of scope names (with
  ``optimizer.step`` and ``loss``), each scope's matmul flops equal to
  the reference's ``profile_static_function``'s exactly, at least 90 %
  of bytes and flops attributed (the reference's floor), two profiles
  identical, and every registered state tensor unchanged by a profile.
  Bytes are not compared across the packages: the reference books one
  jaxpr eqn where the port books the aten operations eager PyTorch runs
  (and a view moves no bytes here), so the granularity differs;
- a report read back by the reference's ``RooflineReport.from_dict``;
- a kernel booked as one boundary row whose bytes and bound are the
  kernel table's formula (``ops/cuda/cost.py``), at the table's shapes;
- ``profile_engine`` over the reference's ten programs.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu.nn.functional as PF
from paddle_tpu import serving as ref_serving
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny
from paddle_tpu.observability import profile as ref_profile

import paddle_tpu_torch as T
from paddle_tpu_torch import serving
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.framework.state import state_tensors
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import LayerNorm, Linear
from paddle_tpu_torch.observability import profile, span
from paddle_tpu_torch.ops.cuda import cost

VOCAB = 256


# ------------------------------------------------------------ cost model
def _port_costs(fn, *args):
    trace = profile.trace_call(lambda: fn(*args))
    return [op[1:3] for op in trace.ops]


def _ref_costs(fn, *args):
    jaxpr = jax.jit(fn).trace(*args).jaxpr
    return {e.primitive.name: ref_profile.eqn_cost(e)
            for e in jaxpr.jaxpr.eqns}


def test_matmul_cost_equals_reference_eqn_cost():
    a, b = np.ones((4, 8), np.float32), np.ones((8, 16), np.float32)
    want = _ref_costs(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    assert _port_costs(torch.mm, torch.tensor(a), torch.tensor(b)) == \
        [want["dot_general"]] == [(2 * 4 * 16 * 8, (32 + 128 + 64) * 4)]
    x, y = np.ones((3, 4, 8), np.float32), np.ones((3, 8, 5), np.float32)
    want = _ref_costs(lambda p, q: jnp.einsum("bij,bjk->bik", p, q),
                      jnp.asarray(x), jnp.asarray(y))
    assert _port_costs(torch.bmm, torch.tensor(x), torch.tensor(y)) == \
        [want["dot_general"]]


def test_pointwise_reduction_and_conv_costs_equal_reference():
    x = np.ones((8, 8), np.float32)
    want = _ref_costs(lambda a: jnp.tanh(a).sum(), jnp.asarray(x))
    got = _port_costs(lambda a: torch.tanh(a).sum(), torch.tensor(x))
    assert got == [want["tanh"], want["reduce_sum"]] == [(64, 512),
                                                        (64, 260)]
    img = np.ones((2, 3, 9, 9), np.float32)
    w = np.ones((4, 3, 3, 3), np.float32)
    want = _ref_costs(lambda i, k: jax.lax.conv(i, k, (1, 1), "VALID"),
                      jnp.asarray(img), jnp.asarray(w))
    got = _port_costs(torch.nn.functional.conv2d, torch.tensor(img),
                      torch.tensor(w))
    assert got == [want["conv_general_dilated"]]


def test_normalize_scope_and_tagging_toggle():
    for s in ("jvp(model)/fc1", "transpose(jvp(model))/act/sub", "",
              "plain/path", f"{profile.BWD_MARKER}model|fc1",
              f"{profile.BWD_MARKER}model|fc1/transpose(jvp(model))/fc1",
              f"{profile.BWD_MARKER}a|b/{profile.BWD_MARKER}c|d"):
        assert profile.normalize_scope(s) == ref_profile.normalize_scope(s)
    fc = Linear(4, 4, device="cpu")
    prev = profile.set_scope_tagging(False)
    try:
        rep = profile.profile_traced(profile.trace_call(
            lambda: fc(torch.ones(2, 4)).sum()))
        assert not rep.layers and rep.unattributed.bytes > 0
    finally:
        profile.set_scope_tagging(prev)
    assert profile.scope_tagging() is True


class TwoBlock(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc_in = Linear(8, 8, device="cpu")
        self.blocks = torch.nn.ModuleList([Linear(8, 8, device="cpu"),
                                           Linear(8, 8, device="cpu")])

    def forward(self, x):
        h = self.fc_in(x)
        for b in self.blocks:
            h = b(h)
        return h


def test_scope_paths_unique_for_list_siblings_and_backward_attribution():
    model = TwoBlock()
    x = torch.ones(4, 8)

    def step():
        loss = model(x).sum()
        loss.backward()
        return loss

    rep = profile.profile_traced(profile.trace_call(step))
    rows = {l.name: l for l in rep.layers}
    assert {"twoblock/fc_in", "twoblock/linear_0",
            "twoblock/linear_1"} <= set(rows)
    # the backward's products land in the layer: the forward's, dW's
    # and (but for the first layer, whose input needs no gradient) dx's
    assert rows["twoblock/fc_in"].matmul_flops == 2 * (2 * 4 * 8 * 8)
    assert rows["twoblock/linear_1"].matmul_flops == 3 * (2 * 4 * 8 * 8)


def test_record_function_paths_under_torch_profiler():
    model = TwoBlock()
    with profile.module_scopes(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        model(torch.ones(4, 8))
    names = {e.name for e in prof.events()}
    assert {"twoblock", "twoblock/fc_in", "twoblock/linear_1"} <= names


def _scope_hooks():
    mod = torch.nn.modules.module
    return [h for d in (mod._global_forward_pre_hooks,
                        mod._global_forward_hooks) for h in d.values()
            if getattr(h, "__module__", "") == profile.__name__]


def test_module_hooks_only_while_a_walk_or_module_scopes_runs():
    """A module call outside a walk runs none of the profiler's hooks;
    a walk, or nested ``module_scopes``, installs them once and the last
    one out removes them."""
    model = TwoBlock()
    assert _scope_hooks() == []
    seen = []
    profile.trace_call(lambda: seen.append(len(_scope_hooks())))
    assert seen == [2] and _scope_hooks() == []
    with profile.module_scopes():
        with profile.module_scopes():
            assert len(_scope_hooks()) == 2
        assert len(_scope_hooks()) == 2
    assert _scope_hooks() == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        model(torch.ones(4, 8))
    assert "twoblock/fc_in" not in {e.name for e in prof.events()}


# ------------------------------------------------- the tiny train step
def _ref_step(optimized):
    P.seed(0)
    cfg = ref_tiny(fused_ln=True)
    model = RefGPT(cfg)
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters(), fused=optimized)

    @P.jit.to_static(amp_policy="bf16" if optimized else None)
    def train_step(ids, labels):
        opt.clear_grad()
        logits = model(ids)
        with ref_profile.scope("loss"):
            loss = PF.cross_entropy(logits.reshape([-1, VOCAB]),
                                    labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return model, train_step


def _port_step(init, optimized):
    model = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(model, init)
    opt = T.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters(), fused=optimized)

    @T.jit.to_static(amp_policy="bf16" if optimized else None)
    def train_step(ids, labels):
        opt.clear_grad()
        logits = model(ids)
        with profile.scope("loss"):
            loss = F.cross_entropy(logits.reshape([-1, VOCAB]),
                                   labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return model, opt, train_step


def _ref_matmul_flops(train_step, ids, labels):
    """({scope: dot_general flops}, {scope: the bias gradients' ones-dot
    flops}) of the reference's program, walked by its own ``_walk`` with
    every other eqn costed at zero. The reference's master-weight Linear
    takes db as a ones-dot, a dot_general with a rank-1 result; the
    port's sums the cotangent over the tokens instead (a reduction), so
    those products are held apart."""
    jaxpr, _ = train_step.traced_program(ids, labels)
    orig = ref_profile.eqn_cost
    sinks = {}
    for bias in (False, True):
        def dots_only(eqn, bias=bias):
            flops, _ = orig(eqn)
            if eqn.primitive.name != "dot_general" or \
                    (eqn.outvars[0].aval.ndim == 1) != bias:
                return 0, 0
            return flops, 0

        ref_profile.eqn_cost = dots_only
        try:
            sink = {}
            ref_profile._walk(jaxpr.jaxpr, "", 1, sink)
        finally:
            ref_profile.eqn_cost = orig
        sinks[bias] = {k: v[0] for k, v in sink.items() if v[0]}
    return sinks[False], sinks[True]


@pytest.fixture(scope="module", params=[False, True],
                ids=["f32", "bf16-fused"])
def step_profiles(request):
    optimized = request.param
    ref_model, ref_step = _ref_step(optimized)
    init = {k: np.asarray(t._value) for k, t in ref_model.state_dict().items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (2, 32))
    labels = rng.integers(0, VOCAB, (2, 32))
    r_ids = P.to_tensor(ids, dtype="int64")
    r_labels = P.to_tensor(labels, dtype="int64")
    ref_rep = ref_profile.profile_static_function(ref_step, r_ids, r_labels)
    ref_mm = _ref_matmul_flops(ref_step, r_ids, r_labels)
    model, opt, step = _port_step(init, optimized)
    t_ids, t_labels = torch.tensor(ids), torch.tensor(labels)
    step(t_ids, t_labels)                  # the moments exist from here on
    before = [t.detach().clone() for t in state_tensors()]
    reps = [profile.profile_static_function(step, t_ids, t_labels,
                                            include_xla=True)
            for _ in range(2)]
    after = [t.detach().clone() for t in state_tensors()]
    return ref_rep, ref_mm, reps, before, after, opt, optimized


def test_step_scope_names_and_matmul_flops_equal_reference(step_profiles):
    ref_rep, (ref_mm, ref_bias), reps, *_, optimized = step_profiles
    rep = reps[0]
    names = {l.name for l in rep.layers}
    assert names == {l.name for l in ref_rep.layers}
    assert {"optimizer.step", "loss"} <= names
    assert any(n.startswith("gptforcausallm/gpt/gptdecoderlayer_0/attn")
               for n in names)
    got = {l.name: l.matmul_flops for l in rep.layers if l.matmul_flops}
    assert got == ref_mm
    assert rep.unattributed.matmul_flops == 0
    # the reference's db ones-dots (bf16 policy only): 2 x tokens x the
    # Linear's width in each biased Linear's scope, which the port books
    # as a reduction of the same cotangent
    cfg = gpt3_tiny()
    widths = {"qkv_proj": 3 * cfg.hidden_size, "out_proj": cfg.hidden_size,
              "fc1": cfg.ffn_hidden_size, "fc2": cfg.hidden_size}
    want = {n: 2 * 2 * 32 * widths[n.rsplit("/", 1)[-1]] for n in got
            if n.rsplit("/", 1)[-1] in widths} if optimized else {}
    assert ref_bias == want


def test_step_attribution_floor_determinism_and_state(step_profiles):
    _, _, (rep1, rep2), before, after, opt, _ = step_profiles
    assert rep1.frac_attributed_bytes >= 0.90, rep1.to_dict()
    assert rep1.frac_attributed_flops >= 0.90, rep1.to_dict()
    assert rep1.total_bytes == rep2.total_bytes
    assert rep1.total_flops == rep2.total_flops
    assert [l.to_dict() for l in rep1.rows()] == \
        [l.to_dict() for l in rep2.rows()]
    rows = rep1.rows()
    assert all(rows[i].bytes >= rows[i + 1].bytes
               for i in range(len(rows) - 1))
    # the independent flop count (matmuls only) within the reference's
    # 0.5-2x of the model's total
    assert 0.5 <= rep1.total_flops / rep1.xla["flops"] <= 2.0
    assert 0.0 <= rep1.bound_fraction <= 1.0 and rep1.predicted_ms > 0
    assert rep1.floor_ms >= rep1.predicted_ms * 0.5
    # weights, moments, the lr and the key as they were
    assert len(before) == len(after)
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    assert float(opt._lr_tensor) == pytest.approx(1e-4)


def test_report_read_back_by_reference_from_dict(step_profiles):
    _, _, (rep, _), *_ = step_profiles
    d = json.loads(json.dumps(rep.to_dict()))
    back = ref_profile.RooflineReport.from_dict(d)
    assert back.total_bytes == rep.total_bytes
    assert back.total_flops == rep.total_flops
    assert {l.name for l in back.layers} == {l.name for l in rep.layers}
    assert back.chip.name == "NVIDIA H100 SXM"
    ours = profile.RooflineReport.from_dict(d)
    assert ours.to_dict() == rep.to_dict()


# ------------------------------------------------------ kernel boundary
def test_kernel_booked_as_one_boundary_row():
    ln = LayerNorm(2048, fused=True, device="cpu")
    x = torch.randn(8, 2048).to(torch.bfloat16)
    trace = profile.trace_call(lambda: ln(x))
    assert [c.name for _, c in trace.kernels] == ["ln_fwd"]
    assert trace.ops == []               # the plain version's ops: silenced
    path, c = trace.kernels[0]
    assert path == "layernorm"
    # x and y in bf16, weight and bias in f32: the table's train mix
    assert c.bytes == 2 * 2 * 8 * 2048 + 2 * 2048 * 4
    rep = profile.profile_traced(trace)
    (row,) = rep.kernels
    assert row["bound_ms"] == cost.bound_ms(c.bytes, c.flops, "f32")[0]
    (interior,) = profile.kernel_interiors(trace)
    assert interior["reuse_factor"] == 1.0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


# PERF.md's kernel table: (cost of the kernel at its shape, bound ms)
TABLE = [
    (lambda: cost.flash_fwd(*[_meta(4, 1024, 16, 128)] * 3, True),
     0.02011),
    (lambda: cost.flash_bwd_dq(*[_meta(4, 1024, 16, 128)] * 4,
                               *[_meta(64, 1024, dtype=torch.float32)] * 2,
                               True), 0.02608),
    (lambda: cost.flash_bwd_dkv(*[_meta(4, 1024, 16, 128)] * 4,
                                *[_meta(64, 1024, dtype=torch.float32)] * 2,
                                True), 0.03478),
    (lambda: cost.ln_fwd(_meta(8, 2048), _meta(2048), _meta(2048), 1e-5),
     0.00002),
    (lambda: cost.ln_fwd(_meta(1000, 2048), _meta(2048), _meta(2048),
                         1e-5), 0.00245),
    (lambda: cost.ln_fwd(_meta(4096, 2048), *[_meta(
        2048, dtype=torch.float32)] * 2, 1e-5), 0.01002),
    (lambda: cost.ln_res_fwd(_meta(1000, 2048), _meta(1000, 2048),
                             _meta(2048), _meta(2048), 1e-5, None), 0.00489),
    (lambda: cost.ln_res_fwd(_meta(4096, 2048), _meta(4096, 2048), *[_meta(
        2048, dtype=torch.float32)] * 2, 1e-5, None), 0.02004),
    (lambda: cost.ln_bwd(_meta(4096, 2048), _meta(4096, 2048), *[_meta(
        2048, dtype=torch.float32)] * 2), 0.01503),
    (lambda: cost.ln_bwd(_meta(4096, 2048), _meta(4096, 2048), *[_meta(
        2048, dtype=torch.float32)] * 2, gh=_meta(4096, 2048)), 0.02004),
    (lambda: cost.rms_fwd(_meta(8192, 2048), _meta(
        2048, dtype=torch.float32), 1e-6), 0.02003),
    (lambda: cost.adam(*[_meta(50304, 2048, dtype=torch.float32)] * 4,
                       _meta(4, dtype=torch.float32), beta1=0.9,
                       beta2=0.999, eps=1e-8, guard=True), (0.12301,
                                                            0.86108)),
    (lambda: cost.keep_mask(_meta(2, dtype=torch.int64), 0.9,
                            (4, 16, 1024, 1024), torch.bfloat16), 0.16048),
]


@pytest.mark.parametrize("case", range(len(TABLE)))
def test_booked_cost_reproduces_the_kernel_table_bound(case):
    fn, want = TABLE[case]
    costs = fn()
    want = want if isinstance(want, tuple) else (want,)
    assert [round(c.bound_ms(), 5) for c in costs] == list(want)


def test_bsa_cost_counts_active_pairs():
    from paddle_tpu_torch.ops.cuda import block_sparse_attention as bsa
    bm = bsa.make_global_plus_window_mask(64, 64, 4, 2)
    tables = bsa.prepare_block_mask(bm, 64, 64)
    (c,) = cost.bsa_fwd(*[_meta(2, 16, 4096, 128)] * 3, tables)
    assert c.flops == 4 * 2 * 16 * int(bm.sum()) * 64 * 64 * 128
    assert c.bytes == 4 * 2 * 16 * 4096 * 128 * 2 + 2 * 16 * 4096 * 4
    assert c.interior_bytes > c.bytes            # k/v re-read a row


# ------------------------------------------------------------ the engine
def test_profile_engine_names_the_reference_programs_and_reconciles():
    P.seed(0)
    ref = RefGPT(ref_tiny(max_seq_len=1024))
    init = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port = GPTForCausalLM(gpt3_tiny(max_seq_len=1024), device="cpu")
    load_numpy_state_dict(port, init)
    kw = dict(max_num_seqs=4, page_size=16, max_model_len=1024)
    ref_eng = ref_serving.LLMEngine(ref, ref_serving.EngineConfig(**kw))
    want = ref_eng.audit_programs()
    eng = serving.LLMEngine(port, serving.EngineConfig(**kw), device="cpu")
    pools = [t.clone() for t in eng._k_pools + eng._v_pools]
    reports = profile.profile_engine(eng)
    assert len(reports) == 10 and set(reports) == set(want)
    assert all(torch.equal(a, b)
               for a, b in zip(pools, eng._k_pools + eng._v_pools))
    assert eng.metrics.compile_count == 0         # nothing built
    dec = reports["decode"]
    assert dec.where == "<serving decode>"
    assert {l.name for l in dec.layers} == {
        l.name for l in ref_profile.profile_traced(want["decode"]).layers}
    prefill = reports["prefill_64"]
    # per layer, the prefill's products: q/k/v, out, fc1, fc2 and the
    # head on 64 rows
    flops = {l.name: l.matmul_flops for l in prefill.layers}
    assert flops["gptforcausallm"] == 2 * 64 * 64 * VOCAB
    assert flops["gptforcausallm/gpt/gptdecoderlayer_0/mlp/fc1"] == \
        2 * 64 * 64 * 256
    with span("serving.decode"):
        pass
    profile.reconcile(dec, "serving.decode")
    assert dec.measured_ms is not None
    assert dec.measured_source.startswith("span serving.decode")
    eng.shutdown()
