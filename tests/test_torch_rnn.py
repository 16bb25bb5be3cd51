"""paddle_tpu_torch's recurrent layers against paddle_tpu's, on the same
numpy inputs from a seed and the reference's weights crossing by
state-dict name: every cell for one step, ``SimpleRNN`` (tanh and relu),
``LSTM`` and ``GRU`` at 2 layers forward, backward and bidirect, batch
major and ``time_major``, with and without ``initial_states``, the
inter-layer dropout drawn from the same seed, ``RNN`` / ``BiRNN`` over a
cell, and the reference's behaviour both packages share: a
``sequence_length`` that changes nothing, and a cell other than the three
built-in ones refused. Last, ``chip_smoke.py``'s PTB LSTM language model
(``lstm_build``) at a tiny width against the same model from the
reference's public layers: 3 ``to_static`` steps of SGD with the global
norm clip, dropout 0.65 from one seed.

Tolerances: f32 outputs and final states within 1e-5 (absolute and
relative), gradients within 1e-4 of each tensor's largest magnitude.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as Pnn
from paddle_tpu.framework import state as ref_state

import paddle_tpu_torch as T
from paddle_tpu_torch import nn
from paddle_tpu_torch.framework.io import load_numpy_state_dict

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

B, L, IN, HID = 2, 5, 6, 8
KINDS = {"rnn_tanh": ("SimpleRNN", dict(activation="tanh")),
         "rnn_relu": ("SimpleRNN", dict(activation="relu")),
         "lstm": ("LSTM", {}), "gru": ("GRU", {})}
CELLS = {"rnn_tanh": ("SimpleRNNCell", dict(activation="tanh")),
         "rnn_relu": ("SimpleRNNCell", dict(activation="relu")),
         "lstm": ("LSTMCell", {}), "gru": ("GRUCell", {})}


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
        return t.detach().numpy()
    return np.asarray(t._value, np.float32)


def _flat(states):
    if isinstance(states, (tuple, list)):
        return [s for x in states for s in _flat(x)]
    return [states]


def _pair(name, *args, **kw):
    P.seed(0)
    ref = getattr(Pnn, name)(*args, **kw)
    port = getattr(nn, name)(*args, device="cpu", **kw)
    load_numpy_state_dict(port, {k: np.asarray(t._value)
                                 for k, t in ref.state_dict().items()})
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    return ref, port


def _run_ref(layer, x, states, cots):
    """Output, final states, and the gradients of ``sum(out * cot)`` (and
    of each final state times its cotangent) for the input, the initial
    states and every parameter."""
    xt = P.to_tensor(x, stop_gradient=False)
    st = None if states is None else _nest(
        states, lambda a: P.to_tensor(a, stop_gradient=False))
    out, fin = layer(xt, st)
    total = (out * P.to_tensor(cots[0])).sum()
    for f, c in zip(_flat(fin), cots[1:]):
        total = total + (f * P.to_tensor(c)).sum()
    total.backward()
    grads = [_np(xt.grad)] + ([] if st is None else
                              [_np(s.grad) for s in _flat(st)])
    params = {k: _np(p.grad) for k, p in layer.named_parameters()}
    return _np(out), [_np(f) for f in _flat(fin)], grads, params


def _run_port(layer, x, states, cots):
    xt = torch.tensor(x, requires_grad=True)
    st = None if states is None else _nest(
        states, lambda a: torch.tensor(a, requires_grad=True))
    out, fin = layer(xt, st)
    total = (out * torch.tensor(cots[0])).sum()
    for f, c in zip(_flat(fin), cots[1:]):
        total = total + (f * torch.tensor(c)).sum()
    total.backward()
    grads = [_np(xt.grad)] + ([] if st is None else
                              [_np(s.grad) for s in _flat(st)])
    params = {k: _np(p.grad) for k, p in layer.named_parameters()}
    return _np(out), [_np(f) for f in _flat(fin)], grads, params


def _nest(states, fn):
    if isinstance(states, (tuple, list)):
        return type(states)(_nest(s, fn) for s in states)
    return fn(states)


def _held(want, got):
    _close(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for g, w in zip(got[1], want[1]):
        _close(g, w)
    for g, w in zip(got[2], want[2]):
        _rel_close(g, w)
    assert sorted(got[3]) == sorted(want[3])
    for k in want[3]:
        _rel_close(got[3][k], want[3][k])


def _cots(out_shape, n_states, state_shape, seed=2):
    rng = _rng(seed)
    return [rng.standard_normal(out_shape).astype(np.float32)] + [
        rng.standard_normal(state_shape).astype(np.float32)
        for _ in range(n_states)]


@pytest.mark.parametrize("kind", list(CELLS))
def test_cell_step(kind):
    name, kw = CELLS[kind]
    ref, port = _pair(name, IN, HID, **kw)
    rng = _rng(1)
    x = rng.standard_normal((B, IN)).astype(np.float32)
    n = 2 if kind == "lstm" else 1
    h0 = [rng.standard_normal((B, HID)).astype(np.float32)
          for _ in range(n)]
    states = tuple(h0) if n == 2 else h0[0]
    cots = _cots((B, HID), n, (B, HID))
    _held(_run_ref(ref, x, states, cots), _run_port(port, x, states, cots))
    # no states: zeros of the cell's state shape
    _close(port(torch.tensor(x))[0].detach(), _np(ref(P.to_tensor(x))[0]))


DIRECTIONS = ["forward", "backward", "bidirect"]


@pytest.mark.parametrize("time_major", [False, True], ids=["batch", "time"])
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_two_layers(kind, direction, time_major):
    name, kw = KINDS[kind]
    ref, port = _pair(name, IN, HID, num_layers=2, direction=direction,
                      time_major=time_major, **kw)
    nd = 2 if direction == "bidirect" else 1
    x = _rng(3).standard_normal(
        (L, B, IN) if time_major else (B, L, IN)).astype(np.float32)
    out_shape = (L, B, nd * HID) if time_major else (B, L, nd * HID)
    n_states = 2 if kind == "lstm" else 1
    cots = _cots(out_shape, n_states, (2 * nd, B, HID))
    _held(_run_ref(ref, x, None, cots), _run_port(port, x, None, cots))


@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
def test_initial_states(kind, direction):
    """Given initial states ``[layers * directions, B, h]`` (a pair for
    LSTM): outputs, final states and their gradients."""
    name, kw = KINDS[kind]
    ref, port = _pair(name, IN, HID, num_layers=2, direction=direction)
    nd = 2 if direction == "bidirect" else 1
    rng = _rng(4)
    x = rng.standard_normal((B, L, IN)).astype(np.float32)
    shape = (2 * nd, B, HID)
    h0 = rng.standard_normal(shape).astype(np.float32)
    states = (h0, rng.standard_normal(shape).astype(np.float32)) \
        if kind == "lstm" else h0
    cots = _cots((B, L, nd * HID), 2 if kind == "lstm" else 1, shape)
    _held(_run_ref(ref, x, states, cots), _run_port(port, x, states, cots))


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn_tanh"])
def test_inter_layer_dropout_from_a_shared_seed(kind):
    """Dropout 0.5 between 3 layers in training: the masks come from the
    global key, so both packages drop the same elements and leave the key
    at the same words."""
    name, kw = KINDS[kind]
    ref, port = _pair(name, IN, HID, num_layers=3, dropout=0.5, **kw)
    x = _rng(5).standard_normal((B, L, IN)).astype(np.float32)
    cots = _cots((B, L, HID), 2 if kind == "lstm" else 1, (3, B, HID))
    P.seed(7)
    want = _run_ref(ref, x, None, cots)
    T.seed(7)
    got = _run_port(port, x, None, cots)
    _held(want, got)
    assert np.array_equal(np.asarray(ref_state.get_rng_state()),
                          T.get_rng_state().numpy())
    port.eval()
    ref.eval()
    _close(port(torch.tensor(x))[0].detach(), _np(ref(P.to_tensor(x))[0]))


@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_and_birnn_over_a_cell(reverse):
    P.seed(0)
    rcell, rcell_bw = Pnn.GRUCell(IN, HID), Pnn.GRUCell(IN, HID)
    ref = Pnn.RNN(rcell, is_reverse=reverse)
    ref_bi = Pnn.BiRNN(rcell, rcell_bw)
    port = nn.RNN(nn.GRUCell(IN, HID, device="cpu"), is_reverse=reverse)
    port_bi = nn.BiRNN(port.cell, nn.GRUCell(IN, HID, device="cpu"))
    load_numpy_state_dict(port_bi, {k: np.asarray(t._value) for k, t in
                                    ref_bi.state_dict().items()})
    x = _rng(6).standard_normal((B, L, IN)).astype(np.float32)
    cots = _cots((B, L, HID), 1, (B, HID))
    _held(_run_ref(ref, x, None, cots), _run_port(port, x, None, cots))
    cots = _cots((B, L, 2 * HID), 2, (B, HID))
    _held(_run_ref(ref_bi, x, None, cots),
          _run_port(port_bi, x, None, cots))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_state_dict_names(kind, direction):
    name, kw = KINDS[kind]
    P.seed(0)
    ref = getattr(Pnn, name)(IN, HID, num_layers=2, direction=direction, **kw)
    port = getattr(nn, name)(IN, HID, num_layers=2, direction=direction,
                             device="cpu", **kw)
    want = {k: tuple(t.shape) for k, t in ref.state_dict().items()}
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == want


@pytest.mark.parametrize("kind", list(KINDS))
def test_a_default_build_draws_every_parameter_apart(kind):
    """Built without a generator, a stack draws all its parameters from
    one generator in turn: no two start equal (``bias_ih`` and
    ``bias_hh``, a second layer's ``weight_ih`` and ``weight_hh``, the
    two directions), as the reference draws each from its global key."""
    name, kw = KINDS[kind]
    port = getattr(nn, name)(HID, HID, num_layers=2, direction="bidirect",
                             device="cpu", **kw)
    params = list(port.state_dict().items())
    assert len(params) == 2 * 2 * 4
    for i, (k, t) in enumerate(params):
        for k2, t2 in params[i + 1:]:
            assert t.shape != t2.shape or not torch.equal(t, t2), (k, k2)
    cell = getattr(nn, CELLS[kind][0])(IN, HID, device="cpu",
                                       **CELLS[kind][1])
    assert not torch.equal(cell.bias_ih, cell.bias_hh)


def test_sequence_length_is_not_read_as_in_the_reference():
    """``sequence_length`` is accepted and never read, in both packages:
    every step of every row runs whatever the lengths say."""
    ref, port = _pair("LSTM", IN, HID, num_layers=2, direction="bidirect")
    x = _rng(8).standard_normal((B, L, IN)).astype(np.float32)
    lengths = np.array([2, 4])
    r_full, _ = ref(P.to_tensor(x))
    r_len, _ = ref(P.to_tensor(x), sequence_length=P.to_tensor(lengths))
    p_full, _ = port(torch.tensor(x))
    p_len, _ = port(torch.tensor(x), sequence_length=torch.tensor(lengths))
    assert np.array_equal(_np(r_full), _np(r_len))
    assert torch.equal(p_full, p_len)
    _close(p_len.detach(), _np(r_len))


def test_a_custom_cell_is_refused_as_in_the_reference():
    class RefCell(Pnn.RNNCellBase):
        state_shape = (HID,)

    class PortCell(nn.RNNCellBase):
        pass

    x = np.zeros((B, L, IN), np.float32)
    with pytest.raises(TypeError):
        Pnn.RNN(RefCell())(P.to_tensor(x))
    with pytest.raises(TypeError):
        nn.RNN(PortCell(IN, HID, device="cpu"))(torch.tensor(x))


def test_param_attrs():
    with pytest.raises(NotImplementedError, match="A.7"):
        nn.LSTMCell(IN, HID, weight_ih_attr=object())
    cell = nn.GRUCell(IN, HID, bias_ih_attr=False, device="cpu")
    assert tuple(cell.bias_ih.shape) == (3 * HID,)       # as the reference


# -------------------------------------------------- the PTB LSTM harness
PTB = dict(vocab=50, hidden=16, layers=2, dropout=chip_smoke.PTB_DROPOUT)
PB, PT = 3, 7


class RefPTB(Pnn.Layer):
    """``chip_smoke.PTBLarge`` from the reference's public layers."""

    def __init__(self, vocab, hidden, layers, dropout):
        super().__init__()
        self.embed = Pnn.Embedding(vocab, hidden)
        self.drop = Pnn.Dropout(dropout)
        self.lstm = Pnn.LSTM(hidden, hidden, num_layers=layers,
                             dropout=dropout)
        self.head = Pnn.Linear(hidden, vocab)

    def forward(self, ids):
        out, _ = self.lstm(self.drop(self.embed(ids)))
        return self.head(self.drop(out))


def test_ptb_harness_to_static_steps_match_the_reference():
    """Three ``to_static`` steps of ``chip_smoke.lstm_build`` (on the CPU:
    eager under ``to_static``) from the reference's weights against the
    reference's own step, the global key seeded alike after building:
    losses within 1e-5, the weights after them within 1e-4 of each
    tensor's largest magnitude, the key at the same words."""
    P.seed(0)
    ref = RefPTB(**PTB)
    opt = P.optimizer.SGD(
        learning_rate=1.0, parameters=ref.parameters(),
        grad_clip=Pnn.ClipGradByGlobalNorm(chip_smoke.PTB_CLIP))
    vocab = PTB["vocab"]

    @P.jit.to_static
    def ref_step(ids, labels):
        opt.clear_grad()
        loss = P.nn.functional.cross_entropy(
            ref(ids).reshape([-1, vocab]), labels.reshape([-1]))
        loss.backward()
        opt.step()
        return loss

    init = {k: np.asarray(t._value) for k, t in ref.state_dict().items()}
    model, step, _opt, _after = chip_smoke.lstm_build(
        device="cpu", vocab=vocab,
        **{k: v for k, v in PTB.items() if k != "vocab"})
    assert sorted(model.state_dict()) == sorted(init)
    load_numpy_state_dict(model, init)
    ids = _rng(10).integers(0, vocab, (PB, PT + 1))
    batch = (ids[:, :-1], ids[:, 1:])
    P.seed(chip_smoke.TB_SEED)
    want = [float(ref_step(*(P.to_tensor(a, dtype="int64") for a in batch)))
            for _ in range(3)]
    got = [step(*(torch.tensor(a) for a in batch)).item() for _ in range(3)]
    _close(got, want)
    state = model.state_dict()
    for k, t in ref.state_dict().items():
        _rel_close(_np(state[k]), _np(t))
    assert np.array_equal(np.asarray(ref_state.get_rng_state()),
                          T.get_rng_state().numpy())
