"""paddle_tpu_torch training: the GPT train step of
``tools/perfgate.py:build_gpt_train_step`` (gpt3_tiny with fused_ln,
ids and labels 2 x 32) in the port and in paddle_tpu from the same
initial weights, with AdamW(1e-4, fused=False) and in its optimized,
guarded form (``AdamW(fused=True, guard=True)``,
``to_static(guard=True)``; the reference's Pallas kernels in interpret
mode), the bf16 activation policy, the optimizer and the loss.

Tolerances: f32 losses within 1e-4 over 3 steps and first-step
gradients within 1e-4 of each tensor's largest magnitude (the same f32
arithmetic in another order, with the attention softmax summed over
blocks in neither package on the CPU); the guard's verdict and region
counts exact, its gradient sum of squares within 1e-4 relative; the
bf16-policy loss trajectory within 0.05 of the f32 one (the reference's
contract for its policy).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as PF
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny

import paddle_tpu_torch as T
from paddle_tpu_torch.framework.io import load_numpy_state_dict, numpy_grads
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt3_tiny
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import flash_attention, norm, optim

VOCAB = 256


def _reference_step(fused=False, guard=False):
    """paddle_tpu's step (to_static, f32) and its model and optimizer."""
    P.seed(0)
    cfg = ref_tiny(fused_ln=True)
    model = RefGPT(cfg)
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters(), fused=fused,
                            guard=guard)

    @P.jit.to_static(amp_policy=None, guard=guard)
    def train_step(ids, labels):
        opt.clear_grad()
        logits = model(ids)
        loss = PF.cross_entropy(logits.reshape([-1, VOCAB]),
                                labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return model, opt, train_step


@pytest.fixture(scope="module")
def reference_run():
    """paddle_tpu's step (to_static, f32): initial weights, the batch,
    3 losses and the first step's gradients by name."""
    model, _, train_step = _reference_step()
    init = {k: np.asarray(t._value) for k, t in model.state_dict().items()}
    rng = np.random.default_rng(0)
    ids = rng.integers(0, VOCAB, (2, 32))
    labels = rng.integers(0, VOCAB, (2, 32))
    losses, grads = [], None
    for _ in range(3):
        losses.append(float(train_step(P.to_tensor(ids, dtype="int64"),
                                       P.to_tensor(labels, dtype="int64"))))
        if grads is None:
            grads = {n: np.asarray(p.grad._value)
                     for n, p in model.named_parameters()}
    return init, ids, labels, losses, grads


def _port_step(init, amp_policy=None, fused=False, guard=False):
    """The port's step from ``init``, and its model and optimizer."""
    model = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    load_numpy_state_dict(model, init)
    opt = T.optimizer.AdamW(learning_rate=1e-4,
                            parameters=model.parameters(), fused=fused,
                            guard=guard)

    @T.jit.to_static(amp_policy=amp_policy, guard=guard)
    def train_step(ids, labels):
        opt.clear_grad()
        logits = model(ids)
        loss = F.cross_entropy(logits.reshape([-1, VOCAB]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    return model, opt, train_step


def _port_run(init, ids, labels, steps, amp_policy=None):
    model, _, train_step = _port_step(init, amp_policy)
    ids, labels = torch.tensor(ids), torch.tensor(labels)
    losses, grads = [], None
    for _ in range(steps):
        losses.append(train_step(ids, labels).item())
        if grads is None:
            grads = numpy_grads(model)
    return model, losses, grads


def test_f32_step_matches_reference(reference_run):
    init, ids, labels, want_losses, want_grads = reference_run
    _, losses, grads = _port_run(init, ids, labels, 3)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=1e-4)
    assert losses[-1] < losses[0]
    assert sorted(grads) == sorted(want_grads)
    for name, want in want_grads.items():
        err = np.abs(grads[name] - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (name, err)
    assert not any(norm.LAUNCHES.values())           # CPU: plain versions
    assert not any(flash_attention.LAUNCHES.values())


def test_guarded_fused_step_matches_reference(reference_run):
    """The reference's optimized, guarded step (fused AdamW through the
    Pallas kernel in interpret mode, guard on both halves) and the
    port's, from the same weights, over 3 steps at amp_policy=None."""
    init, ids, labels, _, _ = reference_run
    ref_model, ref_opt, ref_step = _reference_step(fused=True, guard=True)
    ref_model.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
    _, opt, step = _port_step(init, fused=True, guard=True)
    regions = 0
    for p in ref_model.parameters():                 # row blocks, or 1
        regions += p.shape[0] // optim._pick_block_rows(
            p.shape[0], p.shape[1] * 4) if len(p.shape) == 2 else 1
    for _ in range(3):
        want = float(ref_step(P.to_tensor(ids, dtype="int64"),
                              P.to_tensor(labels, dtype="int64")))
        got = step(torch.tensor(ids), torch.tensor(labels)).item()
        assert abs(got - want) <= 1e-4
        s, ref_s = opt.guard_summary(), ref_opt.guard_summary()
        assert (s.good, s.bad_regions, s.regions) == \
            (ref_s.good, ref_s.bad_regions, ref_s.regions) == \
            (True, 0, regions)
        assert s.grad_sumsq == pytest.approx(ref_s.grad_sumsq, rel=1e-4)
        lg, ref_lg = step.last_guard, ref_step.last_guard
        assert lg["finite"] == ref_lg["finite"] == [True]
        assert lg["loss_finite"] is ref_lg["loss_finite"] is True
        assert lg["loss"] == got
        np.testing.assert_allclose(lg["values"], ref_lg["values"], rtol=0,
                                   atol=1e-4)
    assert not any(optim.LAUNCHES.values())          # CPU: plain version


def test_bf16_policy_trajectory_within_contract(reference_run):
    init, ids, labels, _, _ = reference_run
    _, f32, _ = _port_run(init, ids, labels, 10)
    model, bf16, grads = _port_run(init, ids, labels, 10, amp_policy="bf16")
    assert np.isfinite(bf16).all()
    assert np.abs(np.asarray(bf16) - np.asarray(f32)).max() <= 0.05
    # masters, their gradients and the moments stay f32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(g.dtype == np.float32 and np.isfinite(g).all()
               for g in grads.values())
    assert len(grads) == len(list(model.parameters()))


def test_policy_casts_module_inputs_only_inside_the_step():
    model = GPTForCausalLM(gpt3_tiny(fused_ln=True), device="cpu")
    seen = []
    model.gpt.layers[0].register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].dtype))
    ids = torch.zeros(1, 8, dtype=torch.long)
    step = T.jit.to_static(lambda: model(ids), amp_policy="bf16")
    logits = step()
    assert seen == [torch.bfloat16] and logits.dtype == torch.bfloat16
    model(ids)                         # outside the step: no cast
    assert seen[-1] == torch.float32
    with T.amp.activation_residency("bf16") as pol:
        assert T.amp.current_policy() is pol
    assert T.amp.current_policy() is None


def test_unported_options_raise():
    """Bad options raise; remat is ported: a remat step pushes a policy
    whose remat mode the model reads (``remat_active``), with or without
    a residency dtype."""
    with pytest.raises(ValueError, match="remat"):
        T.jit.to_static(lambda: None, remat="yes")
    seen = []
    for policy, remat in ((None, True), ("bf16", "bf16")):
        step = T.jit.to_static(lambda: seen.append(
            (T.amp.remat_active(), T.amp.current_policy().dtype)),
            amp_policy=policy, remat=remat)
        step()
    assert seen == [(True, None), ("bf16", torch.bfloat16)]
    assert T.amp.remat_active() is False
    with pytest.raises(ValueError, match="bf16"):
        T.jit.to_static(lambda: None, amp_policy="bp16")
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match="named"):
        T.optimizer.AdamW(parameters=p, apply_decay_param_fun=lambda n: True)


def test_adamw_decays_before_the_update_and_only_where_asked():
    """With zero gradients the Adam step is 0/(0 + eps) = 0, so each
    parameter moves by the decoupled decay alone, and only where
    apply_decay_param_fun says so."""
    lin = torch.nn.Linear(4, 3)
    before = {n: p.detach().clone() for n, p in lin.named_parameters()}
    opt = T.optimizer.AdamW(learning_rate=0.5, weight_decay=0.1,
                            parameters=lin.named_parameters(),
                            apply_decay_param_fun=lambda n: n == "weight")
    for p in lin.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    torch.testing.assert_close(lin.weight.detach(),
                               before["weight"] * (1 - 0.5 * 0.1))
    torch.testing.assert_close(lin.bias.detach(), before["bias"])
    opt.clear_grad()
    assert all(p.grad is None for p in lin.parameters())


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(0, 7, (2, 5))
    labels[0, 1] = labels[1, 4] = -100                 # ignored
    want = PF.cross_entropy(P.to_tensor(logits), P.to_tensor(labels))
    got = F.cross_entropy(torch.tensor(logits), torch.tensor(labels))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with T.amp.auto_cast():                  # bf16 logits are raised to f32
        got16 = F.cross_entropy(torch.tensor(logits).bfloat16(),
                                torch.tensor(labels)[..., None])
    assert got16.dtype == torch.float32
