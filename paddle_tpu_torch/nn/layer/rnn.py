"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``).

The cells keep the reference's weights and names: ``weight_ih [G h,
in]``, ``weight_hh [G h, h]``, ``bias_ih``, ``bias_hh [G h]`` with G = 1
(SimpleRNN), 4 (LSTM, gates i, f, g, o) or 3 (GRU, gates r, z, c), drawn
from Uniform(-1/sqrt(h), 1/sqrt(h)) with an explicit generator (None:
one seeded 0, which a cell, or a stack of them, draws all its parameters
from in turn).

:class:`RNN` runs a cell over time as a plain loop of torch operations
(the reference's ``lax.scan``; no cuDNN RNN, whose numerics differ):
the input projection ``x W_ih^T + b_ih`` of every step in one product
first, then per step ``+ h W_hh^T + b_hh`` and the gates, in the
reference's order of additions. Nothing in the loop reads the device
from the host, so ``to_static`` captures it. Shared with the reference:
``sequence_length`` is accepted and never read (every step of every row
runs), and a cell other than the three built-in ones raises TypeError.
The stacked layers' inter-layer dropout draws from the global key
(:func:`paddle_tpu_torch.nn.functional.dropout`), so a shared seed
gives the reference's masks.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from paddle_tpu_torch.nn.functional import common as F_common
from paddle_tpu_torch.nn.layer.common import (module_generator, param_attrs,
                                             uniform_parameter)

__all__ = ["BiRNN", "GRU", "GRUCell", "LSTM", "LSTMCell", "RNN",
           "RNNCellBase", "SimpleRNN", "SimpleRNNCell"]

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16}


class RNNCellBase(nn.Module):
    """A cell: ``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``
    for ``gates`` gates of ``hidden_size``."""

    gates = 1

    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, device=None, dtype=None, generator=None):
        super().__init__()
        # the reference keeps both biases whatever their attrs say
        param_attrs(type(self).__name__, weight_ih_attr=weight_ih_attr,
                    weight_hh_attr=weight_hh_attr, bias_ih_attr=bias_ih_attr,
                    bias_hh_attr=bias_hh_attr)
        self.input_size = input_size
        self.hidden_size = hidden_size
        g = self.gates * hidden_size
        bound = 1.0 / math.sqrt(hidden_size)
        make = dict(bound=bound, device=device, dtype=dtype,
                    generator=module_generator(generator, device))
        self.weight_ih = uniform_parameter((g, input_size), **make)
        self.weight_hh = uniform_parameter((g, hidden_size), **make)
        self.bias_ih = uniform_parameter((g,), **make)
        self.bias_hh = uniform_parameter((g,), **make)

    @property
    def state_shape(self):
        return (self.hidden_size,)

    def get_initial_states(self, batch_ref, shape=None, dtype="float32",
                           init_value=0.0, batch_dim_idx=0):
        """States of ``init_value`` for ``batch_ref``'s batch (its axis
        ``batch_dim_idx``), on its device: one tensor, or a tuple for a
        nested ``shape``."""
        b = batch_ref.shape[batch_dim_idx]
        shape = shape or self.state_shape
        dt = _DTYPES.get(dtype, dtype)

        def full(s):
            return torch.full([b] + list(s), init_value, dtype=dt,
                              device=batch_ref.device)
        if isinstance(shape[0], (list, tuple)):
            return tuple(full(s) for s in shape)
        return full(shape)

    def _project(self, x):
        """The input projection ``x W_ih^T + b_ih``."""
        return x @ self.weight_ih.t() + self.bias_ih

    def forward(self, inputs, states=None):
        if states is None:
            states = self.get_initial_states(inputs)
        single = not isinstance(states, (tuple, list))
        h, carry = self._step(self._project(inputs),
                              (states,) if single else tuple(states))
        return h, (carry[0] if single else carry)


class SimpleRNNCell(RNNCellBase):
    """``h' = act(x W_ih^T + b_ih + h W_hh^T + b_hh)``, act tanh or
    relu."""

    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, **factory):
        super().__init__(input_size, hidden_size, weight_ih_attr,
                         weight_hh_attr, bias_ih_attr, bias_hh_attr, name,
                         **factory)
        self.activation = activation

    def _step(self, xw, carry):
        (h,) = carry
        act = torch.tanh if self.activation == "tanh" else torch.relu
        new_h = act(xw + h @ self.weight_hh.t() + self.bias_hh)
        return new_h, (new_h,)


class LSTMCell(RNNCellBase):
    gates = 4

    @property
    def state_shape(self):
        return ((self.hidden_size,), (self.hidden_size,))

    def _step(self, xw, carry):
        h, c = carry
        gates = xw + h @ self.weight_hh.t() + self.bias_hh
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        new_c = f * c + i * torch.tanh(g)
        new_h = o * torch.tanh(new_c)
        return new_h, (new_h, new_c)


class GRUCell(RNNCellBase):
    gates = 3

    def _step(self, xw, carry):
        (h,) = carry
        gh = h @ self.weight_hh.t() + self.bias_hh
        ir, iz, ic = xw.chunk(3, dim=-1)
        hr, hz, hc = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        c = torch.tanh(ic + r * hc)
        new_h = (1 - z) * c + z * h
        return new_h, (new_h,)


_CELLS = (SimpleRNNCell, LSTMCell, GRUCell)


class RNN(nn.Module):
    """Runs ``cell`` over the time axis (axis 1, or 0 with
    ``time_major``), from the last step back with ``is_reverse``.
    Returns ``(outputs, final_states)``."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        cell = self.cell
        if type(cell) not in _CELLS:
            raise TypeError(f"unsupported cell {type(cell)}")
        if initial_states is None:
            initial_states = cell.get_initial_states(
                inputs, batch_dim_idx=1 if self.time_major else 0)
        single = not isinstance(initial_states, (tuple, list))
        carry = (initial_states,) if single else tuple(initial_states)
        xm = inputs if self.time_major else inputs.transpose(0, 1)
        xw = cell._project(xm)                     # [T, B, G h]
        steps = range(xw.shape[0] - 1, -1, -1) if self.is_reverse \
            else range(xw.shape[0])
        outs = [None] * xw.shape[0]
        for t in steps:
            outs[t], carry = cell._step(xw[t], carry)
        out = torch.stack(outs, dim=0)
        if not self.time_major:
            out = out.transpose(0, 1)
        return out, (carry[0] if single else tuple(carry))


class BiRNN(nn.Module):
    """A forward and a reversed :class:`RNN`, outputs concatenated on the
    last axis, final states ``(forward's, backward's)``."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.rnn_fw = RNN(cell_fw, is_reverse=False, time_major=time_major)
        self.rnn_bw = RNN(cell_bw, is_reverse=True, time_major=time_major)
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        fw_states, bw_states = (None, None) if initial_states is None \
            else initial_states
        out_fw, st_fw = self.rnn_fw(inputs, fw_states, sequence_length)
        out_bw, st_bw = self.rnn_bw(inputs, bw_states, sequence_length)
        return torch.cat([out_fw, out_bw], dim=-1), (st_fw, st_bw)


class _RNNBase(nn.Module):
    """``num_layers`` stacked :class:`RNN` (or :class:`BiRNN` with
    ``direction="bidirect"``) layers in ``layer_list``, the reference's
    names; ``dropout`` between layers in training. States are stacked
    ``[num_layers * num_directions, B, h]`` (a pair for LSTM)."""

    _cell_cls = None

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 device=None, dtype=None, generator=None, **cell_kwargs):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        bidirect = direction in ("bidirect", "bidirectional")
        self.num_directions = 2 if bidirect else 1
        self.direction = direction
        factory = dict(device=device, dtype=dtype,
                       generator=module_generator(generator, device))

        def cell(in_size):
            return self._cell_cls(in_size, hidden_size, **cell_kwargs,
                                  **factory)
        layers = []
        for i in range(num_layers):
            in_size = input_size if i == 0 \
                else hidden_size * self.num_directions
            if bidirect:
                layers.append(BiRNN(cell(in_size), cell(in_size),
                                    time_major))
            else:
                layers.append(RNN(cell(in_size),
                                  is_reverse=(direction == "backward"),
                                  time_major=time_major))
        self.layer_list = nn.ModuleList(layers)

    def _is_lstm(self):
        return self._cell_cls is LSTMCell

    def forward(self, inputs, initial_states=None, sequence_length=None):
        out, finals = inputs, []
        for i, rnn in enumerate(self.layer_list):
            st = None if initial_states is None else _layer_states(
                initial_states, i, self.num_directions, self._is_lstm())
            out, fs = rnn(out, st, sequence_length)
            finals.append(fs)
            if self.dropout > 0 and i < self.num_layers - 1:
                out = F_common.dropout(out, self.dropout,
                                       training=self.training)
        return out, _stack_states(finals, self.num_directions,
                                  self._is_lstm())


def _layer_states(initial_states, i, num_directions, is_lstm):
    if is_lstm:
        h, c = initial_states
        if num_directions == 2:
            return ((h[2 * i], c[2 * i]), (h[2 * i + 1], c[2 * i + 1]))
        return (h[i], c[i])
    h = initial_states
    if num_directions == 2:
        return (h[2 * i], h[2 * i + 1])
    return h[i]


def _stack_states(finals, num_directions, is_lstm):
    if is_lstm:
        hs, cs = [], []
        for fs in finals:
            for h, c in (fs if num_directions == 2 else (fs,)):
                hs.append(h)
                cs.append(c)
        return torch.stack(hs, 0), torch.stack(cs, 0)
    hs = []
    for fs in finals:
        hs += list(fs) if num_directions == 2 else [fs]
    return torch.stack(hs, 0)


class SimpleRNN(_RNNBase):
    _cell_cls = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, activation=activation, **kw)


class LSTM(_RNNBase):
    _cell_cls = LSTMCell


class GRU(_RNNBase):
    _cell_cls = GRUCell
