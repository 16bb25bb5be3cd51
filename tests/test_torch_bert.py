"""paddle_tpu_torch's BERT and ERNIE-3.0 against paddle_tpu's, on the
reference's tiny configs (``bert_tiny``, ``ernie_tiny``: hidden 64, 4
heads of 16, 2 layers, vocab 256) with the same weights from the
reference's seed, crossing by state-dict name (the tied LM weight once):
the logits with and without a 2-D padding mask, the pretraining losses
and every gradient, the sequence classifiers, and 3 steps of the
reference's own train step (``bench.py:_bench_bert`` / ``_bench_ernie``:
``to_static``, ``AdamW(1e-4)``, ``auto_cast(level="O1",
dtype="bfloat16")``) in f32 and under O1. At head_dim 64 (hidden 128, 2
heads) the port's attention takes the flash wrappers, whose plain
versions run on the CPU.

Tolerances: f32 logits within 1e-5 (absolute and relative), gradients
and weights after 3 steps within 1e-4 of each tensor's largest
magnitude (weights that start at zero, the biases, also within 1e-6:
1 % of one AdamW step of 1e-4), f32 losses within 1e-5; O1 losses within
2e-2 (bf16
products rounded at other places: XLA's and oneDNN's).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as PF
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import ernie as ref_ernie

import paddle_tpu_torch as T
from paddle_tpu_torch import models
from paddle_tpu_torch.framework.io import (load_numpy_state_dict,
                                           numpy_grads)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import flash_attention

B, S = 2, 32
KINDS = ("bert", "ernie")


def _configs(kind, **kw):
    if kind == "bert":
        return ref_bert.bert_tiny(**kw), models.bert_tiny(**kw)
    return ref_ernie.ernie_tiny(**kw), models.ernie_tiny(**kw)


def _models(kind, **kw):
    """(reference model, port model, config) with the reference's seeded
    weights in both."""
    rcfg, cfg = _configs(kind, **kw)
    P.seed(0)
    if kind == "bert":
        ref = ref_bert.BertForPretraining(rcfg)
        port = models.BertForPretraining(cfg, device="cpu")
    else:
        ref = ref_ernie.ErnieForPretraining(rcfg)
        port = models.ErnieForPretraining(cfg, device="cpu")
    init = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    load_numpy_state_dict(port, init)
    return ref, port, cfg


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S))
    labels = rng.integers(0, vocab, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[1, S - 9:] = 0                      # the second row padded
    return ids, labels, mask


def _logits(out):
    return out[0] if isinstance(out, tuple) else out


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _rel_close(got, want, rel=1e-4, atol=0.0):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6) + atol, err


@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_crosses_by_name_with_the_tied_weight_once(kind):
    ref, port, _ = _models(kind)
    keys = list(port.state_dict())
    assert sorted(keys) == sorted(ref.state_dict())
    assert not any("decoder_weight" in k for k in keys)
    tied = port.cls.decoder_weight
    emb = (port.bert if kind == "bert" else port.ernie) \
        .embeddings.word_embeddings.weight
    assert tied is emb
    assert sum(p is emb for p in port.parameters()) == 1


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_logits_match_reference(kind, masked):
    """Without a mask attention is flash (the reference's Pallas kernel,
    the port's flash plain version); with the 2-D padding mask it is the
    composition with the additive -1e4 bias in both."""
    ref, port, cfg = _models(kind)
    ids, _, mask = _batch(cfg.vocab_size)
    rkw, pkw = {}, {}
    if masked:
        rkw["attention_mask"] = P.to_tensor(mask)
        pkw["attention_mask"] = torch.tensor(mask)
    if kind == "ernie":
        task = np.ones((B, S), np.int64)
        rkw["task_type_ids"] = P.to_tensor(task, dtype="int64")
        pkw["task_type_ids"] = torch.tensor(task)
    want = _logits(ref(P.to_tensor(ids, dtype="int64"), **rkw))
    got = _logits(port(torch.tensor(ids), **pkw))
    _close(got.detach().numpy(), np.asarray(want._value))
    if kind == "bert":                                       # the NSP head
        _close(port(torch.tensor(ids), **pkw)[1].detach().numpy(),
               np.asarray(ref(P.to_tensor(ids, dtype="int64"),
                              **rkw)[1]._value))


@pytest.mark.parametrize("kind", KINDS)
def test_pretraining_loss_and_gradients_match_reference(kind):
    """The pretraining criterion (labels -100 ignored, masked_lm_weights)
    over the padded batch, and every parameter's gradient."""
    ref, port, cfg = _models(kind)
    ids, labels, mask = _batch(cfg.vocab_size, seed=1)
    labels[:, ::3] = -100
    weights = np.random.default_rng(2).random((B, S)).astype(np.float32)
    rcrit = ref_bert.BertPretrainingCriterion(cfg.vocab_size)
    crit = models.BertPretrainingCriterion(cfg.vocab_size)
    assert models.ernie.ErniePretrainingCriterion is \
        models.BertPretrainingCriterion
    nsp = np.array([0, 1])

    def ref_loss():
        out = ref(P.to_tensor(ids, dtype="int64"),
                  attention_mask=P.to_tensor(mask))
        scores = _logits(out)
        rel = out[1] if kind == "bert" else None
        return rcrit(scores, rel, P.to_tensor(labels, dtype="int64"),
                     P.to_tensor(nsp, dtype="int64") if rel is not None
                     else None, P.to_tensor(weights))

    want = ref_loss()
    want.backward()
    out = port(torch.tensor(ids), attention_mask=torch.tensor(mask))
    scores = _logits(out)
    rel = out[1] if kind == "bert" else None
    got = crit(scores, rel, torch.tensor(labels),
               torch.tensor(nsp) if rel is not None else None,
               torch.tensor(weights))
    got.backward()
    _close(got.item(), float(want), rtol=1e-5, atol=1e-6)
    want_grads = {n: np.asarray(p.grad._value)
                  for n, p in ref.named_parameters() if p.grad is not None}
    grads = numpy_grads(port)
    assert sorted(grads) == sorted(want_grads)
    for name, g in grads.items():
        _rel_close(g, want_grads[name])


@pytest.mark.parametrize("kind", KINDS)
def test_sequence_classification_matches_reference(kind):
    rcfg, cfg = _configs(kind)
    P.seed(0)
    if kind == "bert":
        ref = ref_bert.BertForSequenceClassification(rcfg, num_classes=3)
        port = models.BertForSequenceClassification(cfg, 3, device="cpu")
    else:
        ref = ref_ernie.ErnieForSequenceClassification(rcfg, num_classes=3)
        port = models.ErnieForSequenceClassification(cfg, 3, device="cpu")
    load_numpy_state_dict(port, {k: np.asarray(t._value)
                                 for k, t in ref.state_dict().items()})
    ids, _, mask = _batch(cfg.vocab_size, seed=3)
    want = ref(P.to_tensor(ids, dtype="int64"),
               attention_mask=P.to_tensor(mask))
    got = port(torch.tensor(ids), attention_mask=torch.tensor(mask))
    _close(got.detach().numpy(), np.asarray(want._value))


def _reference_step(ref, kind, vocab, o1):
    opt = P.optimizer.AdamW(learning_rate=1e-4,
                            parameters=ref.parameters())

    @P.jit.to_static
    def train_step(ids, task_ids, labels):
        opt.clear_grad()
        with P.amp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
            pred = _logits(ref(ids, task_type_ids=task_ids)
                           if kind == "ernie" else ref(ids))
        loss = PF.cross_entropy(pred.reshape([-1, vocab]),
                                labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss
    return train_step


def _port_step(port, kind, vocab, o1):
    opt = T.optimizer.AdamW(learning_rate=1e-4,
                            parameters=port.parameters())

    @T.jit.to_static
    def train_step(ids, task_ids, labels):
        opt.clear_grad()
        with T.amp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
            pred = _logits(port(ids, task_type_ids=task_ids)
                           if kind == "ernie" else port(ids))
        loss = F.cross_entropy(pred.reshape([-1, vocab]),
                               labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss
    return train_step


@pytest.mark.parametrize("o1", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_train_step_three_steps(kind, o1):
    """The reference's bench step, 3 calls in each package from the same
    weights and batch (ERNIE with task ids 0): losses, and in f32 the
    weights after the third step."""
    ref, port, cfg = _models(kind)
    ids, labels, _ = _batch(cfg.vocab_size, seed=4)
    task = np.zeros((B, S), np.int64)
    ref_step = _reference_step(ref, kind, cfg.vocab_size, o1)
    step = _port_step(port, kind, cfg.vocab_size, o1)
    want = [float(ref_step(P.to_tensor(ids, dtype="int64"),
                           P.to_tensor(task, dtype="int64"),
                           P.to_tensor(labels, dtype="int64")))
            for _ in range(3)]
    got = [step(torch.tensor(ids), torch.tensor(task),
                torch.tensor(labels)).item() for _ in range(3)]
    if o1:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
        return
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[-1] < got[0]
    want_w = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    for name, w in port.state_dict().items():
        _rel_close(w.numpy(), want_w[name], atol=1e-6)


def test_head_dim_64_attention_takes_the_flash_path():
    """At head_dim 64 (hidden 128, 2 heads) and no mask, every attention
    call goes through the flash wrappers (nothing routed to the
    composition; plain versions on the CPU), and the logits still equal
    the reference's."""
    ref, port, cfg = _models("bert", hidden_size=128, num_heads=2)
    ids, _, _ = _batch(cfg.vocab_size, seed=5)
    before = flash_attention.ROUTED["flash_attention"]
    got = port(torch.tensor(ids))[0]
    assert flash_attention.ROUTED["flash_attention"] == before
    want = ref(P.to_tensor(ids, dtype="int64"))[0]
    _close(got.detach().numpy(), np.asarray(want._value))


def test_configs_and_constructors():
    base = models.bert_base()
    assert (base.hidden_size, base.num_layers, base.num_heads,
            base.ffn_hidden_size, base.vocab_size) == (768, 12, 12, 3072,
                                                       30522)
    large = models.bert_large()
    assert (large.hidden_size, large.num_layers, large.num_heads) == \
        (1024, 24, 16)
    ernie = models.ernie_3_0_base()
    assert (ernie.vocab_size, ernie.layer_norm_epsilon,
            ernie.task_type_vocab_size) == (40000, 1e-5, 3)
    assert models.ernie_3_0_medium().num_layers == 6
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            models.BertForPretraining(models.bert_tiny())
        else:
            raise RuntimeError("CUDA present: the default device is CUDA")
