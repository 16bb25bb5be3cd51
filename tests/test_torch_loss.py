"""paddle_tpu_torch's loss surface against paddle_tpu's: every
``cross_entropy`` option (``weight``, ``reduction``, ``soft_label``,
``label_smoothing``, ``axis``, ``use_softmax``, ``ignore_index``) with
its gradient, ``fused_linear_cross_entropy`` with a ragged last chunk
and ignored labels (loss and both gradients), ``GPTPretrainingCriterion``
with a ``loss_mask``, and the untied LM head's ``loss_with_fused_head``
on ``gpt3_tiny``.

Tolerances: f32, values and gradients within rtol 1e-5 / atol 1e-6 (the
same arithmetic, sums in another order); the fused head's loss against
logits + cross entropy within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as PF
from paddle_tpu.models.gpt import GPTForCausalLM as RefGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as RefCriterion
from paddle_tpu.models.gpt import gpt3_tiny as ref_tiny

from paddle_tpu_torch.framework.io import load_numpy_state_dict, numpy_grads
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)
from paddle_tpu_torch.nn import functional as F

TOL = dict(rtol=1e-5, atol=1e-6)


def _ce_case(case):
    """(logits, label, weight or None, kwargs) as numpy for one case."""
    rng = np.random.default_rng(CE_CASES.index(case))
    logits = rng.standard_normal((4, 6, 7)).astype(np.float32)
    label = rng.integers(0, 7, (4, 6))
    label[0, 1] = label[3, 5] = -100
    weight = None
    kw = {}
    if case in ("mean", "sum", "none"):
        kw["reduction"] = case
    elif case.startswith("weight"):
        weight = rng.uniform(0.2, 2.0, 7).astype(np.float32)
        kw["reduction"] = "sum" if case == "weight_sum" else "mean"
    elif case == "label_smoothing":
        kw["label_smoothing"] = 0.1
    elif case == "ignore_index":
        label = np.where(label < 0, 0, label)
        label[1, 2] = label[2, 2] = 3
        kw["ignore_index"] = 3
    elif case == "trailing_one":
        label = np.where(label < 0, 0, label)[..., None]
    elif case.startswith("soft"):
        p = rng.uniform(size=(4, 6, 7)).astype(np.float32)
        label = p / p.sum(-1, keepdims=True)
        kw["soft_label"] = True
        if case == "soft_smoothing":
            kw["label_smoothing"] = 0.2
    elif case == "axis":
        logits = np.ascontiguousarray(logits.transpose(0, 2, 1))  # [4, 7, 6]
        label = np.where(label < 0, 0, label)
        kw["axis"] = 1
    elif case == "no_softmax":
        e = np.exp(logits)
        logits = (e / e.sum(-1, keepdims=True)).astype(np.float32)
        label = np.where(label < 0, 0, label)
        kw["use_softmax"] = False
    return logits, label, weight, kw


CE_CASES = ["mean", "sum", "none", "weight", "weight_sum", "label_smoothing",
            "ignore_index", "trailing_one", "soft", "soft_smoothing", "axis",
            "no_softmax"]


@pytest.mark.parametrize("case", CE_CASES)
def test_cross_entropy_matches_reference(case):
    logits, label, weight, kw = _ce_case(case)
    x = torch.tensor(logits, requires_grad=True)
    got = F.cross_entropy(x, torch.tensor(label),
                          weight=None if weight is None
                          else torch.tensor(weight), **kw)
    rx = P.to_tensor(logits)
    rx.stop_gradient = False
    want = PF.cross_entropy(rx, P.to_tensor(label),
                            weight=None if weight is None
                            else P.to_tensor(weight), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._value),
                               **TOL)
    got.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(rx.grad._value),
                               **TOL)


def test_cross_entropy_rejects_a_bad_reduction():
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(torch.zeros(2, 3), torch.zeros(2, dtype=torch.long),
                        reduction="avg")


@pytest.mark.parametrize("chunk", [8, 64])
def test_fused_linear_cross_entropy_matches_reference(chunk):
    """21 tokens in chunks of 8 (a ragged last chunk) or one chunk, 4
    labels ignored: the loss and the gradients of hidden and weight."""
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 7, 16)).astype(np.float32)
    w = (0.3 * rng.standard_normal((16, 40))).astype(np.float32)
    y = rng.integers(0, 40, (3, 7))
    y[0, :2] = y[2, 6] = y[1, 3] = -100
    ht = torch.tensor(h, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    got = F.fused_linear_cross_entropy(ht, wt, torch.tensor(y),
                                       chunk_size=chunk)
    rh, rw = P.to_tensor(h), P.to_tensor(w)
    rh.stop_gradient = rw.stop_gradient = False
    want = PF.fused_linear_cross_entropy(rh, rw, P.to_tensor(y),
                                         chunk_size=chunk)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    got.backward()
    want.backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(rh.grad._value),
                               **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(rw.grad._value),
                               **TOL)
    plain = F.cross_entropy(torch.tensor(h) @ torch.tensor(w),
                            torch.tensor(y))
    np.testing.assert_allclose(got.item(), plain.item(), rtol=1e-5)
    none = F.fused_linear_cross_entropy(ht, wt, torch.full((3, 7), -100))
    assert none.item() == 0.0


def test_pretraining_criterion_with_loss_mask_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 8, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 8))
    mask = np.ones((2, 8), np.float32)
    mask[:, 6:] = 0                               # a masked tail per row
    for m in (mask, None):
        got = GPTPretrainingCriterion()(
            torch.tensor(logits), torch.tensor(labels),
            None if m is None else torch.tensor(m))
        want = RefCriterion()(P.to_tensor(logits), P.to_tensor(labels),
                              None if m is None else P.to_tensor(m))
        np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_untied_head_fused_loss_matches_reference():
    """gpt3_tiny cut to one layer with ``tie_word_embeddings=False``:
    ``loss_with_fused_head`` (chunks of 16 over 32 tokens) against the
    reference's, and against the port's logits + cross entropy, loss and
    every gradient."""
    P.seed(0)
    ref = RefGPT(ref_tiny(tie_word_embeddings=False, num_layers=1))
    sd = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    port, twin = (GPTForCausalLM(gpt3_tiny(tie_word_embeddings=False,
                                           num_layers=1), device="cpu")
                  for _ in range(2))
    load_numpy_state_dict(port, sd)
    load_numpy_state_dict(twin, sd)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 256, (2, 16))
    labels = rng.integers(0, 256, (2, 16))
    got = port.loss_with_fused_head(torch.tensor(ids), torch.tensor(labels),
                                    chunk_size=16)
    want = ref.loss_with_fused_head(P.to_tensor(ids), P.to_tensor(labels),
                                    chunk_size=16)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    plain = F.cross_entropy(twin(torch.tensor(ids)).reshape([-1, 256]),
                            torch.tensor(labels).reshape([-1]))
    np.testing.assert_allclose(got.item(), plain.item(), rtol=1e-5)
    got.backward()
    plain.backward()
    fused, unfused = numpy_grads(port), numpy_grads(twin)
    assert fused.keys() == unfused.keys()
    assert "lm_head_weight" in fused
    for k in fused:
        np.testing.assert_allclose(fused[k], unfused[k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
