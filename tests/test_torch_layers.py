"""paddle_tpu_torch's vision and encoder layers against paddle_tpu's:
autocast's signature and lists, the activations, the containers' keys,
the convolutions in each of paddle's padding forms, batch norm (its
output, gradients and running statistics over training steps) and the
pools, on the same numpy inputs from a seed, NCHW and NHWC.

Tolerances: f32 outputs within 1e-5 (absolute and relative), gradients
within 1e-4 of each tensor's largest magnitude (the same f32 products
summed in another order: XLA's convolution against oneDNN's); running
statistics within 1e-5; bf16 outputs within 2^-7 of the largest
magnitude (a bf16 ulp or two).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as Pnn
import paddle_tpu.nn.functional as PF
from paddle_tpu.amp.auto_cast import BLACK_LIST as REF_BLACK_LIST
from paddle_tpu.amp.auto_cast import WHITE_LIST as REF_WHITE_LIST
from paddle_tpu.amp.auto_cast import auto_cast as ref_auto_cast

import paddle_tpu_torch as T
from paddle_tpu_torch import nn
from paddle_tpu_torch.amp.auto_cast import (BLACK_LIST, WHITE_LIST,
                                             amp_guard, amp_state, auto_cast,
                                             downcast_inputs, is_enabled)
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.framework.state import state_init
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.input import ONE_HOT_ROWS


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(np.abs(want).max(), 1e-6), err


def _ref_run(fn, arrays, cot):
    """The reference's output of ``fn`` on ``arrays`` and the gradients
    of ``sum(out * cot)`` with respect to each."""
    ts = [P.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * P.to_tensor(cot)).sum().backward()
    return np.asarray(out._value), [np.asarray(t.grad._value) for t in ts]


def _port_run(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.tensor(cot))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(ref_fn, port_fn, arrays, seed=0):
    """Output and gradients of the port's ``port_fn`` against the
    reference's ``ref_fn`` on ``arrays``, for a seeded cotangent."""
    shape = tuple(ref_fn(*(P.to_tensor(a) for a in arrays)).shape)
    cot = _rng(seed + 100).standard_normal(shape).astype(np.float32)
    want, want_grads = _ref_run(ref_fn, arrays, cot)
    got, grads = _port_run(port_fn, arrays, cot)
    _close(got, want)
    for g, w in zip(grads, want_grads):
        _grad_close(g, w)


# ------------------------------------------------------------ autocast
def test_auto_cast_takes_the_reference_signature():
    """``auto_cast(level="O1", dtype="bfloat16")``, as the reference's
    train steps call it (the port's took no arguments before and raised
    TypeError), and every field restored on exit."""
    st = amp_state()
    with auto_cast(level="O1", dtype="bfloat16") as ac:
        assert is_enabled() and st.dtype == torch.bfloat16
        assert st.level == "O1" and ac.enable
        with amp_guard(enable=False, dtype="float16",
                           custom_white_list={"relu"}):
            assert not is_enabled() and st.dtype == torch.float16
            assert st.custom_white == {"relu"}
        assert is_enabled() and st.dtype == torch.bfloat16
        assert st.custom_white == set()
    assert not is_enabled()
    assert amp_guard is auto_cast and T.amp.amp_guard is auto_cast


def test_auto_cast_lists_follow_the_reference():
    """The conv ops joined the white list with their functionals; the
    custom lists act as the reference's (the black one wins)."""
    for op in ("conv1d", "conv2d", "conv3d", "linear", "matmul", "einsum"):
        assert op in WHITE_LIST and op in REF_WHITE_LIST
    for op in BLACK_LIST:
        assert op in REF_BLACK_LIST
    x, h = torch.ones(2), torch.ones(2, dtype=torch.bfloat16)
    with auto_cast(dtype="float16", custom_white_list={"relu"},
                       custom_black_list={"linear"}):
        assert downcast_inputs(x, opname="relu")[0].dtype == torch.float16
        assert downcast_inputs(h, opname="linear")[0].dtype == \
            torch.float32
        assert downcast_inputs(x, opname="conv2d")[0].dtype == \
            torch.float16
        assert downcast_inputs(h, opname="layer_norm")[0].dtype == \
            torch.float32


def test_conv_under_auto_cast_matches_the_reference():
    """A bf16 conv2d under O1: the output's type and values as the
    reference's (both round the same f32 inputs to bf16 and accumulate
    in f32)."""
    rng = _rng(1)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    with ref_auto_cast(level="O1", dtype="bfloat16"):
        want = PF.conv2d(P.to_tensor(x), P.to_tensor(w), P.to_tensor(b),
                         padding=1)
    with auto_cast(level="O1", dtype="bfloat16"):
        got = F.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                       padding=1)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want._value.astype(np.float32))
    _close(got.float().numpy(), want, rtol=0,
           atol=2.0 ** -7 * np.abs(want).max())


# --------------------------------------------------------- activations
@pytest.mark.parametrize("name,kw", [("relu", {}), ("tanh", {}),
                                     ("sigmoid", {}), ("gelu", {}),
                                     ("gelu", {"approximate": True})])
def test_activations_match_reference(name, kw):
    x = _rng(2).standard_normal((4, 9)).astype(np.float32)
    _check(lambda t: getattr(PF, name)(t, **kw),
           lambda t: getattr(F, name)(t, **kw), [x])


def test_activation_layers_take_their_arguments():
    x = torch.tensor(_rng(3).standard_normal((3, 5)).astype(np.float32))
    assert torch.equal(nn.ReLU()(x), torch.relu(x))
    assert torch.equal(nn.Tanh()(x), torch.tanh(x))
    assert torch.equal(nn.Sigmoid()(x), torch.sigmoid(x))
    tanh_gelu = torch.nn.functional.gelu(x, approximate="tanh")
    assert torch.equal(nn.GELU(True)(x), tanh_gelu)
    assert torch.equal(nn.GELU(approximate=True)(x), tanh_gelu)
    assert torch.equal(nn.GELU()(x), torch.nn.functional.gelu(x))


# ----------------------------------------------------------- embedding
@pytest.mark.parametrize("rows", [7, ONE_HOT_ROWS + 88])
def test_embedding_gradient_sums_repeated_ids(rows):
    """``F.embedding``'s backward (a one-hot product for a small table,
    ``index_put_`` with accumulation for a tall one: both in a fixed
    order on CUDA) against the reference's, with ids that repeat (a
    token-type column of zeros, as BERT's) and ids that do not."""
    rng = _rng(30)
    w = rng.standard_normal((rows, 5)).astype(np.float32)
    for ids in (np.zeros((4, 6), np.int64), rng.integers(0, rows, (4, 6))):
        _check(lambda w_: PF.embedding(P.to_tensor(ids), w_),
               lambda w_: F.embedding(torch.tensor(ids), w_), [w])
    layer = nn.Embedding(7, 5)
    ids = torch.tensor(rng.integers(0, 7, (3, 4)))
    assert torch.equal(layer(ids), layer.weight[ids])


# ---------------------------------------------------------- containers
def test_containers_keep_the_reference_keys():
    """Indexed and named children, appended and inserted ones, and
    parameter lists give the reference's state-dict keys."""
    def build(mod):
        seq = mod.Sequential(mod.Linear(2, 3), mod.ReLU(), mod.Linear(3, 2))
        named = mod.Sequential(("a", mod.Linear(2, 2)),
                               ("b", mod.Linear(2, 2)))
        lst = mod.LayerList([mod.Linear(1, 1)])
        lst.append(mod.Linear(1, 2))
        lst.insert(0, mod.Linear(2, 1))
        lst.extend([mod.Linear(2, 2)])
        d = mod.LayerDict({"x": mod.Linear(1, 1)})
        d["y"] = mod.Linear(1, 1)
        return [seq, named, lst, d]

    for ref, port in zip(build(Pnn), build(nn)):
        assert list(ref.state_dict()) == list(port.state_dict())
        assert len(ref) == len(port)
    assert [k for k in nn.LayerDict({"x": nn.Linear(1, 1)}).keys()] == ["x"]
    params = nn.ParameterList([torch.nn.Parameter(torch.zeros(2))])
    params.append(torch.nn.Parameter(torch.ones(3)))
    assert list(params.state_dict()) == ["0", "1"] and len(params) == 2
    seq = nn.Sequential(nn.Linear(2, 3), nn.ReLU())
    assert isinstance(seq[0], nn.Linear) and len(seq[0:1]) == 1


# ---------------------------------------------------------------- conv
CONV_CASES = {  # name: (kwargs, data_format)
    "int": (dict(padding=1), "NCHW"),
    "per-dim": (dict(padding=[1, 2]), "NCHW"),
    "pairs": (dict(padding=[1, 2, 0, 1]), "NCHW"),
    "nested": (dict(padding=[[1, 2], [0, 1]]), "NHWC"),
    "SAME stride 2": (dict(padding="SAME", stride=2), "NCHW"),
    "SAME stride 2 NHWC": (dict(padding="same", stride=2), "NHWC"),
    "VALID": (dict(padding="VALID", stride=(2, 1)), "NHWC"),
    "groups": (dict(padding=1, groups=2), "NHWC"),
    "dilation": (dict(padding=2, dilation=2), "NCHW"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_reference(case):
    """Forward and gradients (x, weight, bias) of conv2d on a 9 x 10
    input, whose odd sizes make "SAME" at stride 2 pad unevenly."""
    kw, df = CONV_CASES[case]
    rng = _rng(len(case))
    cin, cout = 4, 6
    shape = (2, cin, 9, 10) if df == "NCHW" else (2, 9, 10, cin)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((cout, cin // kw.get("groups", 1), 3, 3)) \
        .astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    _check(lambda x_, w_, b_: PF.conv2d(x_, w_, b_, data_format=df, **kw),
           lambda x_, w_, b_: F.conv2d(x_, w_, b_, data_format=df, **kw),
           [x, w, b])


@pytest.mark.parametrize("df,pads", [
    ("NCHW", [[0, 0], [0, 0], [1, 2], [0, 1]]),
    ("NHWC", [[0, 0], [2, 1], [1, 0], [0, 0]])])
def test_conv2d_nested_pairs_with_batch_and_channel(df, pads):
    """Nested pairs that carry the batch and channel dims: the reference
    reads a 2-D conv's four pairs as a flat list and fails on them, so
    the port is held to the reference given the two spatial pairs."""
    spatial = pads[2:] if df == "NCHW" else pads[1:-1]
    rng = _rng(21)
    shape = (2, 4, 9, 10) if df == "NCHW" else (2, 9, 10, 4)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((6, 4, 3, 3)).astype(np.float32)
    with pytest.raises(TypeError):
        PF.conv2d(P.to_tensor(x), P.to_tensor(w), padding=pads,
                  data_format=df)
    _check(lambda x_, w_: PF.conv2d(x_, w_, padding=spatial, data_format=df),
           lambda x_, w_: F.conv2d(x_, w_, padding=pads, data_format=df),
           [x, w])


@pytest.mark.parametrize("nd,df", [(1, "NCL"), (1, "NLC"), (3, "NCDHW"),
                                   (3, "NDHWC")])
def test_conv1d_conv3d_match_reference(nd, df):
    rng = _rng(nd)
    spatial = (7,) * nd
    shape = (2, 3) + spatial if df.startswith("NC") else (2,) + spatial + (3,)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((4, 3) + (3,) * nd).astype(np.float32)
    ref = PF.conv1d if nd == 1 else PF.conv3d
    port = F.conv1d if nd == 1 else F.conv3d
    _check(lambda x_, w_: ref(x_, w_, None, 2, "SAME", data_format=df),
           lambda x_, w_: port(x_, w_, None, 2, "SAME", data_format=df),
           [x, w])
    if nd == 3:                 # nested pairs with the batch and channel
        pads = [[0, 0], [1, 0], [0, 2], [1, 1]]
        pads = [[0, 0]] + pads if df == "NCDHW" else pads + [[0, 0]]
        _check(lambda x_, w_: ref(x_, w_, padding=pads, data_format=df),
               lambda x_, w_: port(x_, w_, padding=pads, data_format=df),
               [x, w])


def test_conv_layers_init_and_keys():
    """MSRA init (std sqrt(2 / fan_in)), bias zeros or absent, and the
    reference's keys and shapes."""
    g = torch.Generator().manual_seed(0)
    conv = nn.Conv2D(32, 64, 3, groups=2, device="cpu", generator=g)
    fan_in = 16 * 9
    assert abs(conv.weight.std().item() - np.sqrt(2.0 / fan_in)) < 0.005
    assert torch.equal(conv.bias, torch.zeros(64))
    ref = Pnn.Conv2D(32, 64, 3, groups=2)
    assert {k: tuple(v.shape) for k, v in ref.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in conv.state_dict().items()}
    assert nn.Conv2D(3, 8, 1, bias_attr=False).bias is None
    assert list(nn.Conv1D(3, 8, 3).state_dict()) == ["weight", "bias"]
    assert nn.Conv3D(3, 8, 3).weight.shape == (8, 3, 3, 3, 3)
    with pytest.raises(NotImplementedError):
        nn.Conv2D(3, 8, 3, padding_mode="reflect")


# ---------------------------------------------------------- batch norm
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_batch_norm_training_steps_match_reference(df):
    """BatchNorm2D in training: its output and gradients, then the
    running statistics after 3 forwards, and the eval output from them;
    the buffers keep the reference's names and are registered state."""
    rng = _rng(7)
    ref = Pnn.BatchNorm2D(5, data_format=df)
    port = nn.BatchNorm2D(5, data_format=df)
    w = rng.standard_normal(5).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    init = {"weight": w, "bias": b, "_mean": np.zeros(5, np.float32),
            "_variance": np.ones(5, np.float32)}
    ref.set_state_dict({k: P.to_tensor(v) for k, v in init.items()})
    load_numpy_state_dict(port, init)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    assert state_init(port._mean) == 0.0 and state_init(port._variance) == 1.0
    shape = (4, 5, 3, 3) if df == "NCHW" else (4, 3, 3, 5)
    for step in range(3):
        x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)
        cot = rng.standard_normal(shape).astype(np.float32)
        want, (want_gx,) = _ref_run(ref, [x], cot)
        got, (gx,) = _port_run(port, [x], cot)
        _close(got, want)
        _grad_close(gx, want_gx)
        _close(port._mean.numpy(), np.asarray(ref._mean._value))
        _close(port._variance.numpy(), np.asarray(ref._variance._value))
    _close(port.weight.grad.numpy(), np.asarray(ref.weight.grad._value),
           rtol=1e-4, atol=1e-4)
    ref.eval()
    port.eval()
    x = rng.standard_normal(shape).astype(np.float32)
    _close(port(torch.tensor(x)).detach().numpy(),
           np.asarray(ref(P.to_tensor(x))._value))


def test_batch_norm_bf16_input_keeps_its_type():
    """bf16 activations with f32 statistics and affine: the output is
    bf16 and the statistics stay f32, as the reference's."""
    x = _rng(8).standard_normal((4, 6, 2, 2)).astype(np.float32)
    port = nn.BatchNorm2D(6)
    ref = Pnn.BatchNorm2D(6)
    got = port(torch.tensor(x).bfloat16())
    want = ref(P.to_tensor(x).astype("bfloat16"))
    assert got.dtype == torch.bfloat16 and port._mean.dtype == torch.float32
    want = np.asarray(want._value.astype(np.float32))
    _close(got.float().detach().numpy(), want, rtol=0,
           atol=2.0 ** -7 * np.abs(want).max())
    _close(port._mean.numpy(), np.asarray(ref._mean._value), rtol=1e-2,
           atol=1e-3)


def test_batch_norm_layers():
    assert nn.BatchNorm1D(3)(torch.ones(4, 3)).shape == (4, 3)
    assert nn.BatchNorm3D(3)(torch.ones(2, 3, 2, 2, 2)).shape == \
        (2, 3, 2, 2, 2)
    bn = nn.BatchNorm(3, act="relu")
    assert (bn(torch.randn(4, 3, 2, 2)) >= 0).all()
    assert nn.BatchNorm2D(3, weight_attr=False).weight is None
    moved = nn.BatchNorm2D(3).double()            # new buffer tensors
    assert state_init(moved._mean) is None
    moved(torch.randn(2, 3, 2, 2, dtype=torch.float64))
    assert state_init(moved._mean) == 0.0
    assert state_init(moved._variance) == 1.0
    bn = nn.BatchNorm2D(3)
    bn.eval()
    x = torch.randn(2, 3, 2, 2)
    _close(bn(x).detach().numpy(), (x / np.sqrt(1 + 1e-5)).numpy())


def test_batch_norm_to_static_steps_equal_eager():
    """A captured-or-eager step of ``to_static`` over a conv + BatchNorm
    model: the weights and running statistics after 3 calls equal 3 eager
    steps exactly (the first call's extra run is undone for registered
    state, the buffers included)."""
    def build():
        gen = torch.Generator().manual_seed(1)
        m = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1, generator=gen),
                          nn.BatchNorm2D(4), nn.ReLU())
        opt = T.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                   parameters=m.parameters())

        def step(x):
            opt.clear_grad()
            loss = (m(x) ** 2).mean()
            loss.backward()
            opt.step()
            return loss
        return m, step

    x = torch.tensor(_rng(9).standard_normal((2, 3, 5, 5)).astype(np.float32))
    eager, step = build()
    for _ in range(3):
        step(x)
    captured, step2 = build()
    static = T.jit.to_static(step2)
    for _ in range(3):
        static(x)
    for (k, a), b in zip(eager.state_dict().items(),
                         captured.state_dict().values()):
        assert torch.equal(a, b), k


# --------------------------------------------------------------- pools
POOL_CASES = {
    "max k3 s2 p1": ("max", dict(kernel_size=3, stride=2, padding=1)),
    "max ceil": ("max", dict(kernel_size=3, stride=2, ceil_mode=True)),
    "max pairs": ("max", dict(kernel_size=2, stride=2,
                              padding=[1, 0, 0, 1])),
    "avg exclusive": ("avg", dict(kernel_size=3, stride=2, padding=1)),
    "avg inclusive": ("avg", dict(kernel_size=3, stride=2, padding=1,
                                  exclusive=False)),
    "avg ceil": ("avg", dict(kernel_size=2, stride=2, ceil_mode=True)),
    "avg divisor": ("avg", dict(kernel_size=2, divisor_override=3)),
}


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_reference(case, df):
    kind, kw = POOL_CASES[case]
    shape = (2, 3, 7, 9) if df == "NCHW" else (2, 7, 9, 3)
    x = _rng(len(case)).standard_normal(shape).astype(np.float32)
    ref = PF.max_pool2d if kind == "max" else PF.avg_pool2d
    port = F.max_pool2d if kind == "max" else F.avg_pool2d
    _check(lambda t: ref(t, data_format=df, **kw),
           lambda t: port(t, data_format=df, **kw), [x])


@pytest.mark.parametrize("size,df", [((1, 1), "NHWC"), (3, "NCHW"),
                                     ((2, None), "NCHW")])
def test_adaptive_avg_pool2d_matches_reference(size, df):
    shape = (2, 3, 7, 5) if df == "NCHW" else (2, 7, 5, 3)
    x = _rng(11).standard_normal(shape).astype(np.float32)
    _check(lambda t: PF.adaptive_avg_pool2d(t, size, data_format=df),
           lambda t: F.adaptive_avg_pool2d(t, size, data_format=df), [x])


def test_pool_1d_3d_and_layers():
    x = _rng(12).standard_normal((2, 3, 8)).astype(np.float32)
    _check(lambda t: PF.max_pool1d(t, 3, 2, 1),
           lambda t: F.max_pool1d(t, 3, 2, 1), [x])
    _check(lambda t: PF.avg_pool1d(t, 3, 2, 1),
           lambda t: F.avg_pool1d(t, 3, 2, 1), [x])
    _check(lambda t: PF.adaptive_avg_pool1d(t, 3),
           lambda t: F.adaptive_avg_pool1d(t, 3), [x])
    v = _rng(13).standard_normal((1, 2, 5, 6, 4)).astype(np.float32)
    _check(lambda t: PF.max_pool3d(t, 2, 2, ceil_mode=True),
           lambda t: F.max_pool3d(t, 2, 2, ceil_mode=True), [v])
    _check(lambda t: PF.avg_pool3d(t, 3, 1, 1),
           lambda t: F.avg_pool3d(t, 3, 1, 1), [v])
    img = torch.tensor(_rng(14).standard_normal((2, 6, 6, 3))
                       .astype(np.float32))
    assert torch.equal(nn.MaxPool2D(3, 2, 1, data_format="NHWC")(img),
                       F.max_pool2d(img, 3, 2, 1, data_format="NHWC"))
    assert torch.equal(nn.AdaptiveAvgPool2D(1, data_format="NHWC")(img),
                       img.mean(dim=(1, 2), keepdim=True))
    assert nn.AvgPool2D(2)(img.movedim(-1, 1)).shape == (2, 3, 3, 3)
    with pytest.raises(NotImplementedError):
        F.max_pool2d(img, 2, return_mask=True)
