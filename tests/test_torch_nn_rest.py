"""The rest of paddle_tpu_torch's ``nn`` for sequence models against
paddle_tpu's, on the same numpy inputs from a seed: every activation,
common, extension, distance and loss functional of the reference that
the port gained, and every such layer, one parametrised case each (each
loss at every ``reduction``), its output and the gradients of ``sum(out *
cot)`` with respect to its float inputs (and a layer's weights, which
cross by name); draws from the global key (``rrelu`` in training,
``gumbel_softmax``, ``alpha_dropout``, ``Dropout2D``) from one seed in
both. Then one test lists the public names of each reference module of
the slice and finds each in the port's counterpart and in its namespace.

Tolerances: f32 outputs within 1e-5 (absolute and relative), gradients
within 1e-4 of each tensor's largest magnitude.
"""
import importlib

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as Pnn
import paddle_tpu.nn.functional as PF

import paddle_tpu_torch as T
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.io import load_numpy_state_dict
from paddle_tpu_torch.nn import functional as F


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= rel * max(np.abs(want).max() if want.size else 0, 1e-6), \
        err


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.is_floating_point() else t).numpy()
    return np.asarray(t._value)


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _floaty(a):
    return isinstance(a, np.ndarray) and a.dtype.kind == "f"


def run_both(ref_fn, port_fn, arrays, grad=True, seed=7):
    """Each function on the arrays as tensors (from ``seed`` in both):
    the outputs compared, and with ``grad`` the gradients of
    ``sum(out * cot)`` over the float outputs with respect to each float
    array (``ref_fn`` / ``port_fn`` may also return layer weights'
    gradients through ``run_both.params``)."""
    rts = [P.to_tensor(a, stop_gradient=not (grad and _floaty(a)))
           if isinstance(a, np.ndarray) else a for a in arrays]
    pts = [torch.tensor(a, requires_grad=grad and _floaty(a))
           if isinstance(a, np.ndarray) else a for a in arrays]
    P.seed(seed)
    r_out = _flat(ref_fn(*rts))
    T.seed(seed)
    p_out = _flat(port_fn(*pts))
    assert len(r_out) == len(p_out)
    for r, p in zip(r_out, p_out):
        assert tuple(p.shape) == tuple(r.shape)
        if p.is_floating_point():
            _close(_np(p), _np(r))
        else:
            assert np.array_equal(_np(p), _np(r))
    if not grad:
        return
    rng = _rng(99)
    r_total = p_total = None
    for r, p in zip(r_out, p_out):
        if not p.is_floating_point() or not p.requires_grad:
            continue
        cot = rng.standard_normal(tuple(p.shape)).astype(np.float32)
        rt = (r * P.to_tensor(cot)).sum()
        pt = (p * torch.tensor(cot)).sum()
        r_total = rt if r_total is None else r_total + rt
        p_total = pt if p_total is None else p_total + pt
    if p_total is None:
        return
    r_total.backward()
    p_total.backward()
    for a, r, p in zip(arrays, rts, pts):
        if _floaty(a):
            _rel_close(_np(p.grad), _np(r.grad))


def _x(*shape, seed=0):
    return _rng(seed).standard_normal(shape).astype(np.float32)


def _u(*shape, lo=0.05, hi=0.95, seed=1):
    return _rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _ints(*shape, hi=4, seed=2):
    return _rng(seed).integers(0, hi, shape).astype(np.int64)


def _pm1(*shape, seed=3):
    return np.where(_rng(seed).random(shape) < 0.5, -1.0, 1.0).astype(
        np.float32)


# ------------------------------------------------------------ activations
X = _x(3, 4, 5)
ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("elu", dict(alpha=0.7)),
    ("celu", dict(alpha=1.3)), ("selu", dict(scale=1.2, alpha=1.5)),
    ("gelu", {}), ("gelu", dict(approximate=True)), ("sigmoid", {}),
    ("hardsigmoid", dict(slope=0.2, offset=0.4)), ("hardswish", {}),
    ("hardtanh", dict(min=-0.5, max=0.7)),
    ("hardshrink", dict(threshold=0.4)), ("softshrink", dict(threshold=0.3)),
    ("tanhshrink", {}), ("leaky_relu", dict(negative_slope=0.2)),
    ("rrelu", {}), ("rrelu", dict(lower=0.2, upper=0.5, training=True)),
    ("log_sigmoid", {}), ("maxout", dict(groups=2)),
    ("maxout", dict(groups=5, axis=-1)), ("softmax", dict(axis=1)),
    ("log_softmax", dict(axis=0)), ("softplus", dict(beta=2, threshold=1)),
    ("softsign", {}), ("swish", {}), ("silu", {}), ("mish", {}),
    ("tanh", {}), ("thresholded_relu", dict(threshold=0.2, value=-1.0)),
    ("glu", {}), ("glu", dict(axis=1)),
    ("gumbel_softmax", dict(temperature=0.5, hard=True, axis=0))]


@pytest.mark.parametrize("name,kw", ACTIVATIONS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ACTIVATIONS)])
def test_activation(name, kw):
    x = X[..., :4] if name == "glu" and "axis" not in kw else X
    run_both(lambda t: getattr(PF, name)(t, **kw),
             lambda t: getattr(F, name)(t, **kw), [x])


@pytest.mark.parametrize("name", ["relu_", "elu_", "softmax_", "tanh_"])
def test_inplace_activation(name):
    want = getattr(PF, name)(P.to_tensor(X.copy()))
    t = torch.tensor(X.copy())
    got = getattr(F, name)(t)
    assert got is t
    _close(_np(t), _np(want))


@pytest.mark.parametrize("fmt,w", [("NCHW", 1), ("NCHW", 4), ("NHWC", 5)])
def test_prelu(fmt, w):
    weight = _u(w, seed=4)
    run_both(lambda t, wt: PF.prelu(t, wt, fmt),
             lambda t, wt: F.prelu(t, wt, fmt), [_x(2, 4, 3, 5), weight])


def _layer_pair(ref_cls, port_cls, *args, **kw):
    P.seed(0)
    ref = ref_cls(*args, **kw)
    port = port_cls(*args, **kw)
    sd = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    load_numpy_state_dict(port, sd)
    return ref, port


def _weights_held(ref, port):
    for (k, p), (k2, r) in zip(sorted(port.named_parameters()),
                               sorted(ref.named_parameters())):
        assert k == k2
        _rel_close(_np(p.grad), _np(r.grad))


ACT_LAYERS = [
    ("ReLU", (), {}), ("ReLU6", (), {}), ("GELU", (True,), {}),
    ("Sigmoid", (), {}), ("Tanh", (), {}), ("LogSigmoid", (), {}),
    ("Hardsigmoid", (), {}), ("Hardswish", (), {}),
    ("Hardtanh", (-0.4,), dict(max=0.6)), ("ELU", (0.5,), {}),
    ("CELU", (), dict(alpha=2.0)), ("SELU", (), {}),
    ("LeakyReLU", (0.1,), {}), ("Hardshrink", (), dict(threshold=0.2)),
    ("Softshrink", (0.3,), {}), ("Tanhshrink", (), {}),
    ("Softplus", (2.0,), {}), ("Softsign", (), {}), ("Swish", (), {}),
    ("Silu", (), {}), ("Mish", (), {}), ("ThresholdedReLU", (0.3,), {}),
    ("GLU", (), dict(axis=1)), ("RReLU", (0.1, 0.2), {}),
    ("Softmax", (0,), {}), ("LogSoftmax", (), dict(axis=1)),
    ("Maxout", (2,), {}), ("Softmax2D", (), {}),
    ("PReLU", (4, 0.1), {})]


@pytest.mark.parametrize("name,args,kw", ACT_LAYERS,
                         ids=[n for n, _, _ in ACT_LAYERS])
def test_activation_layer(name, args, kw):
    ref, port = _layer_pair(getattr(Pnn, name), getattr(nn, name), *args,
                            **kw)
    run_both(ref, port, [X], grad=bool(list(port.parameters())))


# ---------------------------------------------------------------- common
IMG = _x(2, 3, 4, 5)
PADS = [
    ([1, 2], "constant", "NCL", (2, 3, 4)), ([1, 0, 2, 1], "reflect", "NCHW",
                                            None),
    ([2, 1, 1, 3], "replicate", "NHWC", None),
    ([1, 2, 0, 1], "circular", "NCHW", None),
    ([0, 0, 1, 0, 1, 2, 0, 1], "constant", "NCHW", None),
    ([3, 3, 1, 1], "reflect", "NCHW", None),
    ([1, 1, 1, 1, 1, 1], "replicate", "NCDHW", (1, 2, 3, 4, 3))]


@pytest.mark.parametrize("pad,mode,fmt,shape", PADS,
                         ids=[f"{m}-{f}-{len(p)}" for p, m, f, _ in PADS])
def test_pad(pad, mode, fmt, shape):
    x = IMG if shape is None else _x(*shape)
    run_both(lambda t: PF.pad(t, pad, mode, 0.5, fmt),
             lambda t: F.pad(t, pad, mode, 0.5, fmt), [x])


RESIZES = [
    ("nearest", dict(size=[7, 9]), "NCHW"),
    ("bilinear", dict(size=[7, 6]), "NCHW"),
    ("bilinear", dict(size=[3, 2]), "NCHW"),                 # antialiased
    ("bilinear", dict(size=[7, 8]), "NHWC"),
    ("bilinear", dict(size=[7, 6], align_corners=True), "NCHW"),
    ("bicubic", dict(size=[8, 9]), "NCHW"),
    ("bicubic", dict(scale_factor=[0.5, 0.75]), "NCHW"),
    ("bicubic", dict(size=[6, 7], align_corners=True), "NCHW"),
    ("linear", dict(size=[9]), "NCW"),
    ("trilinear", dict(size=[3, 5, 4]), "NCDHW")]


@pytest.mark.parametrize("mode,kw,fmt", RESIZES,
                         ids=[f"{m}-{i}" for i, (m, _, _) in
                              enumerate(RESIZES)])
def test_interpolate(mode, kw, fmt):
    x = {"NCW": _x(2, 3, 5), "NCDHW": _x(1, 2, 3, 4, 5)}.get(fmt, IMG)
    run_both(lambda t: PF.interpolate(t, mode=mode, data_format=fmt, **kw),
             lambda t: F.interpolate(t, mode=mode, data_format=fmt, **kw),
             [x])


COMMON = [
    ("zeropad2d", lambda m: (m.zeropad2d, [IMG], dict(padding=[1, 2, 0, 1]))),
    ("cosine_similarity", lambda m: (m.cosine_similarity,
                                     [_x(3, 5), _x(3, 5, seed=1)],
                                     dict(axis=1))),
    ("bilinear", lambda m: (m.bilinear, [_x(4, 3), _x(4, 5, seed=1),
                                         _x(2, 3, 5, seed=2),
                                         _x(1, 2, seed=3)], {})),
    ("label_smooth", lambda m: (m.label_smooth, [_u(3, 5)],
                                dict(epsilon=0.2))),
    ("label_smooth-prior", lambda m: (m.label_smooth, [_u(3, 5), _u(5)],
                                      {})),
    ("unfold", lambda m: (m.unfold, [_x(2, 3, 6, 7)],
                          dict(kernel_sizes=[2, 3], strides=[1, 2],
                               paddings=[1, 0, 1, 2], dilations=[2, 1]))),
    ("fold", lambda m: (m.fold, [_x(2, 12, 20)],
                        dict(output_sizes=[4, 5], kernel_sizes=2,
                             strides=1, paddings=[0, 1], dilations=1))),
    ("upsample", lambda m: (m.upsample, [IMG],
                            dict(scale_factor=2, mode="bilinear"))),
]


@pytest.mark.parametrize("case", COMMON, ids=[c for c, _ in COMMON])
def test_common_functional(case):
    _, make = case
    fn_r, arrays, kw = make(PF)
    fn_p = make(F)[0]
    run_both(lambda *t: fn_r(*t, **kw), lambda *t: fn_p(*t, **kw), arrays)


@pytest.mark.parametrize("nranks,rank", [(1, 0), (2, 1)])
def test_class_center_sample(nranks, rank):
    label = _ints(12, hi=10 * nranks, seed=5)
    kw = dict(num_classes=10, num_samples=6, rank=rank, nranks=nranks,
              seed=3)
    run_both(lambda t: PF.class_center_sample(t, **kw),
             lambda t: F.class_center_sample(t, **kw), [label], grad=False)
    with pytest.raises(ValueError):
        F.class_center_sample(torch.tensor(label), 4, 6)


COMMON_LAYERS = [
    ("Identity", (), {}, [IMG]), ("Flatten", (), {}, [IMG]),
    ("Flatten", (0, 2), {}, [IMG]), ("Unflatten", (2, [2, 2]), {}, [IMG]),
    ("Pad1D", ([1, 2],), dict(mode="reflect"), [_x(2, 3, 5)]),
    ("Pad2D", (1,), dict(mode="replicate"), [IMG]),
    ("Pad3D", ([1, 0, 0, 1, 2, 1],), dict(value=0.3), [_x(1, 2, 3, 4, 3)]),
    ("ZeroPad2D", ([1, 0, 2, 1],), {}, [IMG]),
    ("Upsample", (), dict(size=[8, 9], mode="bicubic"), [IMG]),
    ("UpsamplingNearest2D", (), dict(size=[7, 9]), [IMG]),
    ("UpsamplingBilinear2D", (), dict(size=[7, 6]), [IMG]),
    ("CosineSimilarity", (), {}, [_x(3, 5), _x(3, 5, seed=1)]),
    ("Unfold", ([2, 3],), dict(strides=[1, 2], paddings=[1, 0, 1, 2],
                               dilations=[2, 1]), [_x(2, 3, 6, 7)]),
    ("Fold", ([4, 5], 2), dict(paddings=[0, 1]), [_x(2, 12, 20)]),
    ("Bilinear", (3, 5, 2), {}, [_x(4, 3), _x(4, 5, seed=1)]),
    ("Bilinear", (3, 5, 2), dict(bias_attr=False),
     [_x(4, 3), _x(4, 5, seed=1)]),
    ("AlphaDropout", (0.3,), {}, [_x(4, 50)]),
    ("Dropout2D", (0.4,), {}, [IMG]),
    ("Dropout3D", (0.4,), dict(data_format="NDHWC"), [_x(2, 3, 4, 2, 5)])]


@pytest.mark.parametrize("name,args,kw,arrays", COMMON_LAYERS,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(COMMON_LAYERS)])
def test_common_layer(name, args, kw, arrays):
    ref, port = _layer_pair(getattr(Pnn, name), getattr(nn, name), *args,
                            **kw)
    run_both(ref, port, arrays)
    if list(port.parameters()):
        _weights_held(ref, port)
    if "Dropout" in name:
        ref.eval()
        port.eval()
        run_both(ref, port, arrays, grad=False)


# ------------------------------------------------ extension and distance
EXTENSION = [
    ("sequence_mask", [np.array([[2, 0], [3, 1]], np.int64)], {}, False),
    ("sequence_mask", [np.array([1, 4, 2], np.int64)],
     dict(maxlen=5, dtype="float32"), False),
    ("sequence_mask", [np.array([1, 3], np.int64)], dict(dtype="bool"),
     False),
    ("diag_embed", [_x(2, 3)], {}, True),
    ("diag_embed", [_x(2, 3)], dict(offset=-2, dim1=0, dim2=2), True),
    ("temporal_shift", [_x(4, 2, 3, 8)],
     dict(seg_num=2, shift_ratio=0.5, data_format="NHWC"), True),
    ("pairwise_distance", [_x(3, 4), _x(3, 4, seed=1)], {}, True),
    ("pairwise_distance", [_x(3, 4), _x(3, 4, seed=1)],
     dict(p=1.0, keepdim=True), True),
    # pdist's gradient is NaN in both packages: the diagonal's 0^(1/p)
    # has an infinite derivative, times its zero cotangent
    ("pdist", [_x(4, 3)], dict(p=3.0), False),
    ("cdist", [_x(2, 4, 3), _x(2, 5, 3, seed=1)], {}, True),
    ("cdist", [_x(2, 4, 3), _x(2, 5, 3, seed=1)],
     dict(compute_mode="donot_use_mm_for_euclid_dist"), True)]


@pytest.mark.parametrize("name,arrays,kw,grad", EXTENSION,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(EXTENSION)])
def test_extension_and_distance(name, arrays, kw, grad):
    run_both(lambda *t: getattr(PF, name)(*t, **kw),
             lambda *t: getattr(F, name)(*t, **kw), arrays, grad=grad)


def test_pairwise_distance_layer():
    ref, port = _layer_pair(Pnn.PairwiseDistance, nn.PairwiseDistance, 1.0,
                            keepdim=True)
    run_both(ref, port, [_x(3, 4), _x(3, 4, seed=1)])


# ------------------------------------------------------------------ losses
def _ctc_inputs():
    rng = _rng(6)
    return [rng.standard_normal((5, 3, 5)).astype(np.float32),
            rng.integers(1, 5, (3, 2)).astype(np.int64),
            np.array([5, 4, 5], np.int64), np.array([2, 2, 1], np.int64)]


def _hs_paths():
    table = np.array([[0, 1, -1], [0, 2, 3], [1, -1, -1], [0, 3, 2]],
                     np.int64)
    code = np.array([[1, 0, -1], [0, 1, 1], [1, -1, -1], [1, 1, 0]],
                    np.int64)
    return table, code


LOGP = np.log(np.asarray(P.nn.functional.softmax(P.to_tensor(_x(3, 4)))
                         ._value)).astype(np.float32)
LOSSES = [
    # (name, arrays, kwargs; the kwargs take "reduction")
    ("nll_loss", [LOGP, _ints(3, hi=4)], {}),
    ("nll_loss", [LOGP, np.array([1, -100, 3])], dict(weight=_u(4))),
    ("nll_loss", [_x(2, 4, 3), _ints(2, 3, hi=4)], {}),
    ("mse_loss", [_x(3, 4), _x(3, 4, seed=1)], {}),
    ("l1_loss", [_x(3, 4), _x(3, 4, seed=1)], {}),
    ("smooth_l1_loss", [_x(3, 4), _x(3, 4, seed=1)], dict(delta=0.7)),
    ("huber_loss", [_x(3, 4), _x(3, 4, seed=1)], dict(delta=0.5)),
    ("bce_loss", [_u(3, 4), _u(3, 4, seed=2)], {}),
    ("binary_cross_entropy", [_u(3, 4), _u(3, 4, seed=2)],
     dict(weight=_u(4, seed=5))),
    ("binary_cross_entropy_with_logits", [_x(3, 4), _u(3, 4, seed=2)], {}),
    ("binary_cross_entropy_with_logits", [_x(3, 4), _u(3, 4, seed=2)],
     dict(weight=_u(4, seed=5), pos_weight=_u(4, seed=6))),
    ("kl_div", [LOGP, _u(3, 4)], {}),
    ("margin_ranking_loss", [_x(6), _x(6, seed=1), _pm1(6)],
     dict(margin=0.2)),
    ("hinge_embedding_loss", [_x(3, 4), _pm1(3, 4).astype(np.int64)],
     dict(margin=0.5)),
    ("cosine_embedding_loss",
     [_x(3, 4), _x(3, 4, seed=1), _pm1(3).astype(np.int64)],
     dict(margin=0.1)),
    ("triplet_margin_loss", [_x(3, 4), _x(3, 4, seed=1), _x(3, 4, seed=2)],
     {}),
    ("triplet_margin_loss", [_x(3, 4), _x(3, 4, seed=1), _x(3, 4, seed=2)],
     dict(p=1.0, swap=True, margin=2.0)),
    ("triplet_margin_with_distance_loss",
     [_x(3, 4), _x(3, 4, seed=1), _x(3, 4, seed=2)], dict(swap=True)),
    ("soft_margin_loss", [_x(3, 4), _pm1(3, 4)], {}),
    ("multi_label_soft_margin_loss", [_x(3, 4), _u(3, 4) > 0.5], {}),
    ("multi_label_soft_margin_loss", [_x(3, 4), _u(3, 4) > 0.5],
     dict(weight=_u(4, seed=7))),
    ("poisson_nll_loss", [_x(3, 4), _u(3, 4, hi=3.0)], {}),
    ("poisson_nll_loss", [_u(3, 4, lo=0.5, hi=2), _u(3, 4, lo=0.2, hi=3.0)],
     dict(log_input=False, full=True)),
    ("gaussian_nll_loss", [_x(3, 4), _x(3, 4, seed=1), _u(3, 4)], {}),
    ("gaussian_nll_loss", [_x(3, 4), _x(3, 4, seed=1), _u(3, 4)],
     dict(full=True, epsilon=0.1)),
    ("ctc_loss", _ctc_inputs(), dict(blank=0)),
    ("sigmoid_focal_loss", [_x(3, 4), _u(3, 4) > 0.5], {}),
    ("sigmoid_focal_loss", [_x(3, 4), _u(3, 4) > 0.5],
     dict(normalizer=np.array([3.0], np.float32), gamma=1.5)),
    ("multi_margin_loss", [_x(3, 4), _ints(3, hi=4)], {}),
    ("multi_margin_loss", [_x(3, 4), _ints(3, hi=4)],
     dict(p=2, margin=0.5, weight=_u(4))),
    ("margin_cross_entropy", [_u(3, 4, lo=-0.9, hi=0.9), _ints(3, hi=4)],
     {}),
    ("margin_cross_entropy", [_u(3, 4, lo=-0.9, hi=0.9), _ints(3, hi=4)],
     dict(return_softmax=True, margin1=0.9, margin3=0.1, scale=8.0)),
]
REDUCTIONS = ["mean", "sum", "none"]


def _as_float(a):
    return a.astype(np.float32) if isinstance(a, np.ndarray) \
        and a.dtype == bool else a


def _loss_args(arrays, kw):
    """Tensors among the kwargs go through as arrays (so their gradients
    are compared too): returns (arrays, names of the array kwargs, the
    rest)."""
    arrays = [_as_float(a) for a in arrays]
    extra = [k for k, v in kw.items() if isinstance(v, np.ndarray)]
    return arrays + [kw[k] for k in extra], extra, \
        {k: v for k, v in kw.items() if k not in extra}


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name,arrays,kw", LOSSES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LOSSES)])
def test_loss(name, arrays, kw, reduction):
    arrays, extra, rest = _loss_args(arrays, kw)
    n = len(arrays) - len(extra)

    def call(mod):
        def fn(*t):
            return getattr(mod, name)(*t[:n], **dict(zip(extra, t[n:])),
                                      reduction=reduction, **rest)
        return fn
    run_both(call(PF), call(F), arrays)


def test_kl_div_batchmean():
    run_both(lambda a, b: PF.kl_div(a, b, "batchmean"),
             lambda a, b: F.kl_div(a, b, "batchmean"), [LOGP, _u(3, 4)])


def test_triplet_margin_with_a_distance_function():
    run_both(lambda *t: PF.triplet_margin_with_distance_loss(
        *t, distance_function=lambda a, b: PF.pairwise_distance(a, b, 1.0),
        margin=0.5, swap=True),
        lambda *t: F.triplet_margin_with_distance_loss(
            *t, distance_function=lambda a, b: F.pairwise_distance(a, b,
                                                                   1.0),
            margin=0.5, swap=True),
        [_x(3, 4), _x(3, 4, seed=1), _x(3, 4, seed=2)])


UNREDUCED = [
    ("dice_loss", [_u(3, 4, 5), _ints(3, 4, 1, hi=5)], dict(epsilon=1e-4)),
    ("log_loss", [_u(3, 1), _u(3, 1) > 0.5], {}),
    ("square_error_cost", [_x(3, 4), _x(3, 4, seed=1)], {}),
    ("npair_loss", [_x(3, 4), _x(3, 4, seed=1), np.array([0, 1, 0])],
     dict(l2_reg=0.01)),
    ("softmax_with_cross_entropy", [_x(3, 4), _ints(3, 1, hi=4)], {}),
    ("softmax_with_cross_entropy", [_x(3, 4), _u(3, 4)],
     dict(soft_label=True, return_softmax=True)),
    ("hsigmoid_loss", [_x(4, 3), _ints(4, hi=6), _x(5, 3, seed=3),
                       _x(5, seed=4)], dict(num_classes=6)),
    ("hsigmoid_loss", [_x(4, 3), _ints(4, hi=5), _x(4, 3, seed=3),
                       _x(4, seed=4), *_hs_paths()], dict(num_classes=5)),
]


@pytest.mark.parametrize("name,arrays,kw", UNREDUCED,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(UNREDUCED)])
def test_loss_without_reduction(name, arrays, kw):
    """The losses that take no ``reduction``."""
    arrays = [_as_float(a) for a in arrays]
    if name == "hsigmoid_loss":
        def call(mod):
            def fn(x, y, w, *rest):
                b = rest[0] if rest else None
                paths = rest[1:] if len(rest) > 1 else (None, None)
                return mod.hsigmoid_loss(x, y, kw["num_classes"], w, b,
                                         *paths)
            return fn
        run_both(call(PF), call(F), arrays)
        return
    run_both(lambda *t: getattr(PF, name)(*t, **kw),
             lambda *t: getattr(F, name)(*t, **kw), arrays)


def test_margin_cross_entropy_refuses_a_group():
    with pytest.raises(NotImplementedError, match="A.4"):
        F.margin_cross_entropy(torch.zeros(2, 3), torch.zeros(2), group="tp")


LOSS_LAYERS = [
    ("CrossEntropyLoss", dict(label_smoothing=0.1), [_x(3, 4),
                                                      _ints(3, hi=4)]),
    ("MSELoss", {}, [_x(3, 4), _x(3, 4, seed=1)]),
    ("L1Loss", {}, [_x(3, 4), _x(3, 4, seed=1)]),
    ("NLLLoss", dict(ignore_index=1), [LOGP, _ints(3, hi=4)]),
    ("BCELoss", {}, [_u(3, 4), _u(3, 4, seed=2)]),
    ("BCEWithLogitsLoss", {}, [_x(3, 4), _u(3, 4, seed=2)]),
    ("KLDivLoss", {}, [LOGP, _u(3, 4)]),
    ("SmoothL1Loss", dict(delta=2.0), [_x(3, 4), _x(3, 4, seed=1)]),
    ("HuberLoss", dict(delta=0.3), [_x(3, 4), _x(3, 4, seed=1)]),
    ("MarginRankingLoss", dict(margin=0.1), [_x(6), _x(6, seed=1), _pm1(6)]),
    ("CTCLoss", {}, _ctc_inputs()),
    ("HingeEmbeddingLoss", {}, [_x(3, 4), _pm1(3, 4).astype(np.int64)]),
    ("CosineEmbeddingLoss", {}, [_x(3, 4), _x(3, 4, seed=1),
                                 _pm1(3).astype(np.int64)]),
    ("TripletMarginLoss", dict(p=1.0), [_x(3, 4), _x(3, 4, seed=1),
                                        _x(3, 4, seed=2)]),
    ("TripletMarginWithDistanceLoss", dict(margin=0.3),
     [_x(3, 4), _x(3, 4, seed=1), _x(3, 4, seed=2)]),
    ("SoftMarginLoss", {}, [_x(3, 4), _pm1(3, 4)]),
    ("MultiLabelSoftMarginLoss", {}, [_x(3, 4), _as_float(_u(3, 4) > 0.5)]),
    ("PoissonNLLLoss", dict(full=True), [_x(3, 4), _u(3, 4, hi=3.0)]),
    ("GaussianNLLLoss", {}, [_x(3, 4), _x(3, 4, seed=1), _u(3, 4)]),
    ("MultiMarginLoss", dict(p=2), [_x(3, 4), _ints(3, hi=4)]),
]


@pytest.mark.parametrize("name,kw,arrays,reduction", [
    c + (REDUCTIONS[i % 3],) for i, c in enumerate(LOSS_LAYERS)],
    ids=[c[0] for c in LOSS_LAYERS])
def test_loss_layer(name, kw, arrays, reduction):
    """Each layer at one reduction (its functional is held at all
    three)."""
    ref, port = _layer_pair(getattr(Pnn, name), getattr(nn, name),
                            reduction=reduction, **kw)
    run_both(ref, port, arrays)


@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_loss_layer(bias):
    kw = {} if bias else dict(bias_attr=False)
    ref, port = _layer_pair(Pnn.HSigmoidLoss, nn.HSigmoidLoss, 3, 6, **kw)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    run_both(ref, port, [_x(4, 3), _ints(4, hi=6)])
    _weights_held(ref, port)


# ------------------------------------------------------------------ names
SLICE = ["nn.functional.activation", "nn.functional.common",
         "nn.functional.extension", "nn.functional.distance",
         "nn.functional.loss", "nn.layer.activation", "nn.layer.common",
         "nn.layer.distance", "nn.layer.loss", "nn.layer.rnn",
         "nn.layer.transformer"]


def _public(mod):
    """The names a reference module defines (functions, classes and the
    aliases bound to them), without those it imports."""
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and getattr(getattr(mod, n), "__module__", None)
                  == mod.__name__)


@pytest.mark.parametrize("path", SLICE)
def test_every_public_name_of_the_reference_is_ported(path):
    ref = importlib.import_module(f"paddle_tpu.{path}")
    port = importlib.import_module(f"paddle_tpu_torch.{path}")
    space = F if ".functional." in path else nn
    names = _public(ref)
    assert names
    assert [n for n in names if not hasattr(port, n)] == []
    assert [n for n in names if not hasattr(space, n)] == []
    assert [n for n in names if n not in space.__all__] == []
