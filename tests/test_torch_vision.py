"""paddle_tpu_torch's ResNet and ViT against paddle_tpu's, from the same
weights (crossing by state-dict name, BatchNorm's ``_mean`` and
``_variance`` included) and the same seeded batch of 2 images: the
reference's own train steps (``bench.py:_resnet_variant``: ``to_static``,
``Momentum(momentum=0.9)``, ``auto_cast(level="O1", dtype="bfloat16")``;
``tools/profile_vit.py``: the same with ``AdamW(1e-4)``) in f32 and
under O1, ResNet-18 (basic blocks, NCHW and NHWC) and ViT (``vit_tiny``,
32^2) for 3 steps, ResNet-50 (bottleneck blocks, NHWC, the bench's
layout) for one. Each first step returns its logits; the gradients are
read after it, the weights and running statistics after the last.

The ResNets see 64^2 images. At 32^2 the last stage is 1 x 1, so its
BatchNorms normalise 2 values a channel, whose outputs (+-1) flip sign
with the last bit of f32 sums: the two packages' logits part by O(1).
ResNet-50's gradients are ill-conditioned in f32 at any such batch:
against the same model in f64 (the port's), an f32 gradient of either
package is 16-53 % off for its worst tensor (batch 2 to 8, 64^2 to
128^2), while each of its four stages alone, given the same input,
agrees with the reference's within 1e-5. So ResNet-50 is held by its
first step (logits, loss, running statistics) and stage by stage, and
ResNet-18, which is well conditioned (f32 within 7e-5 of f64), through
its 3 steps. The learning rate keeps a batch of 2 from diverging (0.01;
the bench's 0.1 sends ResNet-50's loss past 3000 at step 2).

Tolerances: f32 logits and losses within 1e-5 absolute and relative
(ResNet-50's logits, loss and statistics within 1e-4 of the largest
magnitude: 53 layers of f32 sums in another order), gradients and
weights within 1e-4 of each tensor's largest magnitude (plus 1e-6 for
weights that start at zero, 1 % of an AdamW step); O1 losses within
2e-2.
"""
import copy

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn.functional as PF
from paddle_tpu.models import vit as ref_vit
from paddle_tpu.vision.models import resnet as ref_resnet

import paddle_tpu_torch as T
from paddle_tpu_torch import models
from paddle_tpu_torch.framework.io import load_numpy_state_dict, numpy_grads
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.vision.models import resnet

CLASSES = 10
RESNET_SIDE = 64     # the last stage 2 x 2: its BatchNorms see 8 values


def _pair(kind, df):
    """(reference, port) with the reference's seeded weights in both."""
    P.seed(0)
    if kind == "vit":
        ref = ref_vit.VisionTransformer(ref_vit.vit_tiny())
        port = models.VisionTransformer(models.vit_tiny(), device="cpu")
    else:
        depth = int(kind[len("resnet"):])
        rblock, block = ((ref_resnet.BottleneckBlock, resnet.BottleneckBlock)
                         if depth == 50 else
                         (ref_resnet.BasicBlock, resnet.BasicBlock))
        ref = ref_resnet.ResNet(rblock, depth, num_classes=CLASSES,
                                data_format=df)
        port = resnet.ResNet(block, depth, num_classes=CLASSES,
                             data_format=df, device="cpu")
    load_numpy_state_dict(port, {k: np.asarray(t._value)
                                 for k, t in ref.state_dict().items()})
    return ref, port


def _batch(kind, df):
    rng = np.random.default_rng(0)
    side = 32 if kind == "vit" else RESNET_SIDE
    shape = (2, side, side, 3) if df == "NHWC" else (2, 3, side, side)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, CLASSES, (2,)))


def _ref_step(model, opt, o1):
    @P.jit.to_static
    def train_step(x, y):
        opt.clear_grad()
        with P.amp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
            logits = model(x)
        loss = PF.cross_entropy(logits, y)
        loss.backward()
        opt.step()
        return loss, logits
    return train_step


def _port_step(model, opt, o1):
    @T.jit.to_static
    def train_step(x, y):
        opt.clear_grad()
        with T.amp.auto_cast(enable=o1, level="O1", dtype="bfloat16"):
            logits = model(x)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        opt.step()
        return loss, logits
    return train_step


def _optimizers(kind, ref, port):
    if kind == "vit":
        return (P.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=ref.parameters()),
                T.optimizer.AdamW(learning_rate=1e-4,
                                  parameters=port.parameters()))
    lr = 0.01
    return (P.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 parameters=ref.parameters()),
            T.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                 parameters=port.parameters()))


def _rel_close(got, want, rel=1e-4, atol=0.0):
    err = np.abs(np.asarray(got) - np.asarray(want)).max()
    assert err <= rel * max(np.abs(want).max(), 1e-6) + atol, err


def _key_bias(name, value, heads):
    """A fused qkv bias with its key part left out: the loss does not
    depend on the key bias (softmax ignores what it adds to a row), so
    its gradient is rounding noise, which AdamW's normalised step turns
    into +-lr in either package."""
    if not name.endswith("qkv.bias"):
        return value
    per_head = value.reshape(heads, 3, -1)
    return per_head[:, [0, 2]]


def _weights_close(name, got, want, init, heads):
    """Updated weights within 1e-4 of the tensor's largest magnitude plus
    1 % of its largest change over the steps."""
    got, want, init = (_key_bias(name, v, heads) for v in (got, want, init))
    _rel_close(got, want, atol=1e-2 * np.abs(want - init).max())


def _run(kind, df, o1, steps=3, pair=None):
    ref, port = pair or _pair(kind, df)
    init = {k: v.clone() for k, v in port.state_dict().items()}
    ref_opt, opt = _optimizers(kind, ref, port)
    ref_step, step = _ref_step(ref, ref_opt, o1), _port_step(port, opt, o1)
    x, y = _batch(kind, df)
    rx, ry = P.to_tensor(x), P.to_tensor(y, dtype="int64")
    tx, ty = torch.tensor(x), torch.tensor(y)
    want, got = [], []
    for i in range(steps):
        rl, rlogits = ref_step(rx, ry)
        pl, plogits = step(tx, ty)
        want.append(float(rl))
        got.append(pl.item())
        if i == 0:
            first = (np.asarray(rlogits._value.astype(np.float32)),
                     plogits.detach().float().numpy())
            ref_grads = {n: np.asarray(p.grad._value)
                         for n, p in ref.named_parameters()
                         if p.grad is not None}
            grads = numpy_grads(port)
    return ref, port, init, want, got, first, ref_grads, grads


CASES = [("resnet18", "NCHW"), ("resnet18", "NHWC"), ("vit", "NCHW")]


@pytest.mark.parametrize("kind,df", CASES)
def test_f32_train_steps_match_reference(kind, df):
    ref, port, init, want, got, (rlogits, plogits), ref_grads, grads = \
        _run(kind, df, False)
    np.testing.assert_allclose(plogits, rlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[-1] < got[0]
    assert sorted(grads) == sorted(ref_grads)
    for name, g in grads.items():
        _rel_close(g, ref_grads[name])
    want_state = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    heads = models.vit_tiny().num_heads
    for name, w in port.state_dict().items():
        _weights_close(name, w.numpy(), want_state[name],
                       init[name].numpy(), heads)
    if kind != "vit":
        stats = [k for k in want_state if k.endswith(("_mean", "_variance"))]
        assert len(stats) == 2 * sum(1 for k in want_state
                                     if k.endswith("_mean"))
        assert not all(np.array_equal(port.state_dict()[k].numpy(),
                                      np.zeros_like(want_state[k]))
                       for k in stats if k.endswith("_mean"))


def test_resnet50_first_step_and_stages_match_reference():
    """ResNet-50 NHWC: its last two stages' outputs given the same input
    (f32; the first two, at 16^2, cost the reference's eager backward
    seconds each and test nothing the last two do not), and
    its gradients (its parameters' and its input's) from the port's
    f64 run of it against the reference's f32 ones: an f32 sum in another
    order can move a ReLU input within ~2e-6 of zero across it, and one
    such flip (layer3, block 5, at this seed, between the port's f32 and
    f64) moves a gradient by up to 11 % of its tensor; the port in f64
    rounds nothing that could flip one. Then the first step's logits,
    loss and every running statistic after it."""
    ref, port = _pair("resnet50", "NHWC")
    rng = np.random.default_rng(1)
    q = RESNET_SIDE // 4                         # the stem's output side
    for i, (side, width) in ((3, (q // 2, 512)), (4, (q // 4, 1024))):
        x = rng.standard_normal((2, side, side, width)).astype(np.float32)
        rstage, stage = getattr(ref, f"layer{i}"), getattr(port, f"layer{i}")
        rx = P.to_tensor(x, stop_gradient=False)
        rout = rstage(rx)
        cot = rng.standard_normal(tuple(rout.shape)).astype(np.float32)
        (rout * P.to_tensor(cot)).sum().backward()
        _rel_close(stage(torch.tensor(x)).detach().numpy(),
                   np.asarray(rout._value), rel=1e-5)
        stage = copy.deepcopy(stage).double()
        tx = torch.tensor(x, dtype=torch.float64, requires_grad=True)
        stage(tx).backward(torch.tensor(cot, dtype=torch.float64))
        _rel_close(tx.grad.numpy(), np.asarray(rx.grad._value))
        params = dict(stage.named_parameters())
        for name, p in rstage.named_parameters():
            _rel_close(params[name].grad.numpy(), np.asarray(p.grad._value))
    ref, port, _, want, got, (rlogits, plogits), _, _ = _run(
        "resnet50", "NHWC", False, steps=1, pair=(ref, port))
    _rel_close(plogits, rlogits)
    _rel_close(got, want)
    state = port.state_dict()
    stats = [(k, np.asarray(t._value)) for k, t in ref.state_dict().items()
             if k.endswith(("_mean", "_variance"))]
    assert len(stats) == 2 * 53
    for name, want_stat in stats:
        _rel_close(state[name].numpy(), want_stat)


@pytest.mark.parametrize("kind,df", [("resnet18", "NHWC"), ("vit", "NCHW")])
def test_o1_train_steps_match_reference(kind, df):
    """Under the reference's ``auto_cast(level="O1", dtype="bfloat16")``:
    the convs and products in bf16 (logits bf16), the losses within
    2e-2 of the reference's."""
    *_, want, got, _, _, _ = _run(kind, df, True)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert np.isfinite(got).all()


def test_resnet_constructors_and_remat():
    """The reference's constructors build the same keys and shapes (ResNeXt
    by groups and width, wide by width); ``remat=True`` is not ported."""
    P.seed(0)
    for name in ("resnet34", "resnext50_32x4d", "wide_resnet50_2"):
        ref = getattr(ref_resnet, name)(num_classes=CLASSES)
        port = getattr(resnet, name)(num_classes=CLASSES, device="cpu")
        assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
            {k: tuple(v.shape) for k, v in port.state_dict().items()}, name
    with pytest.raises(NotImplementedError, match="A.3"):
        resnet.resnet50(remat=True, device="cpu")
    feats = resnet.resnet18(num_classes=0, with_pool=False, device="cpu")
    assert feats(torch.ones(2, 3, 32, 32)).shape == (2, 512, 1, 1)


def test_vit_configs():
    b = models.vit_b_16()
    assert (b.hidden_size, b.num_layers, b.num_heads, b.num_patches,
            b.hidden_size // b.num_heads) == (768, 12, 12, 196, 64)
    large = models.vit_l_16()
    assert (large.hidden_size, large.num_layers, large.num_heads) == \
        (1024, 24, 16)
    assert models.ViT is models.VisionTransformer
    m = models.VisionTransformer(models.vit_tiny(num_classes=0),
                                 device="cpu")
    assert m.head is None and m(torch.zeros(1, 3, 32, 32)).shape == \
        (1, 17, 64)
