"""Recurrent layers (port of ``paddle_tpu/nn/layer/rnn.py``): the cells
``SimpleRNNCell``, ``LSTMCell`` and ``GRUCell``, the sequence wrappers
``RNN`` and ``BiRNN``, and the stacked ``SimpleRNN``, ``LSTM`` and
``GRU``, under the reference's parameter names (``weight_ih``,
``weight_hh``, ``bias_ih``, ``bias_hh``; ``_cells.{i}`` in a stack, layer
by layer, forward before backward).

The gate math is the reference's, which is PyTorch's: an LSTM's gates
split ``[i, f, c, o]`` (c' = f*c + i*tanh(g_c), h' = o*tanh(c')), a GRU's
``[r, z, c]`` (c = tanh(x_c + r*h_c), h' = (h - c)*z + c), the weights in
``[gates * hidden, in]``.

Two routes, chosen by the device and nothing else:

- the step loop (:func:`_scan_rnn`), which mirrors the reference's
  ``_scan_rnn`` and ``_scan_bidir``: the input projection of every step
  in one product before the loop, then the recurrence one step at a
  time; a step at ``t >= sequence_length`` keeps the previous state and
  emits zeros, in both directions. It runs on the CPU, and on the card
  for ``SimpleRNN``, the ``RNN``/``BiRNN`` wrappers, a ``sequence_length``
  and a bidirectional layer whose two cells differ (the reference's
  ``_cells_fusable``);
- on the card, every other layer of ``LSTM`` and ``GRU`` is one call of
  PyTorch's fused recurrence (``torch._VF.lstm``/``gru``, cuDNN for a
  float32 or float16 computation), both directions together, counted in
  :data:`cudnn_calls`. Layers run one at a time so that the dropout
  between them is the port's own (``F.dropout``, from ``core.generator``).

Dtypes follow the reference's promotion: the default initial states are
float32, so a bfloat16 input computes in float32, as the reference's
``lax.scan`` does; the outputs and final states come back in the input's
dtype (the reference returns the promoted float32).
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core.dtype import convert_dtype
from paddle_tpu_torch.device import resolve_device
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.nn.containers import LayerList
from paddle_tpu_torch.param_attr import ParamAttr, create_parameter

__all__ = ["RNNCellBase", "SimpleRNNCell", "LSTMCell", "GRUCell", "RNN",
           "BiRNN", "SimpleRNN", "LSTM", "GRU"]

#: calls of PyTorch's fused recurrence (one per LSTM/GRU layer a forward
#: on the card)
cudnn_calls = 0


def _as_tuple(states):
    return tuple(states) if isinstance(states, (tuple, list)) else (states,)


def _compute_dtype(x, states):
    """The dtype the reference's arithmetic promotes ``x`` and ``states``
    to."""
    dt = x.dtype
    for s in _as_tuple(states):
        dt = torch.promote_types(dt, s.dtype)
    return dt


def _cast(params, dt):
    return tuple(None if p is None else p.to(dt) for p in params)


class RNNCellBase(torch.nn.Module):
    def get_initial_states(self, batch_ref, shape=None, dtype=None,
                           init_value=0.0):
        """States of ``init_value`` for ``batch_ref``'s batch (its first
        axis), float32 unless ``dtype`` says otherwise, on its device."""
        b = batch_ref.shape[0]
        kw = dict(dtype=convert_dtype(dtype or "float32"),
                  device=batch_ref.device)
        shapes = self.state_shape
        if isinstance(shapes, tuple):
            return tuple(torch.full([b] + list(s), init_value, **kw)
                         for s in shapes)
        return torch.full([b] + list(shapes), init_value, **kw)

    def _params(self):
        return (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh)

    def forward(self, inputs, states=None):
        """One step: ``(output, new_states)``."""
        if states is None:
            states = self.get_initial_states(inputs)
        dt = _compute_dtype(inputs, states)
        wih, whh, bih, bhh = _cast(self._params(), dt)
        xg = inputs.to(dt) @ wih.T
        if bih is not None:
            xg = xg + bih
        st = tuple(s.to(dt) for s in _as_tuple(states))
        out, new = self._step_pre(whh, bhh, xg, st if len(st) > 1 else st[0])
        new = tuple(s.to(inputs.dtype) for s in _as_tuple(new))
        return out.to(inputs.dtype), new if len(new) > 1 else new[0]


def _make_cell_params(cell, input_size, hidden_size, n_gates, attrs, kw):
    """The reference's four parameters, each U(-1/sqrt(hidden),
    1/sqrt(hidden)); a bias attr of ``False`` leaves that bias out."""
    std = 1.0 / math.sqrt(hidden_size)
    u = I.Uniform(-std, std)
    wih, whh, bih, bhh = attrs
    cell.weight_ih = create_parameter([n_gates * hidden_size, input_size],
                                      attr=wih, default_initializer=u, **kw)
    cell.weight_hh = create_parameter([n_gates * hidden_size, hidden_size],
                                      attr=whh, default_initializer=u, **kw)
    cell.bias_ih = None if ParamAttr._to_attr(bih) is False else \
        create_parameter([n_gates * hidden_size], attr=bih,
                         default_initializer=u, **kw)
    cell.bias_hh = None if ParamAttr._to_attr(bhh) is False else \
        create_parameter([n_gates * hidden_size], attr=bhh,
                         default_initializer=u, **kw)


def _recurrent(whh, bhh, h):
    g = h @ whh.T
    return g if bhh is None else g + bhh


class SimpleRNNCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, activation="tanh",
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        if activation not in ("tanh", "relu"):
            raise ValueError(f"activation {activation!r} (want tanh|relu)")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.activation = activation
        _make_cell_params(
            self, input_size, hidden_size, 1,
            (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
            dict(device=resolve_device(device), dtype=convert_dtype(dtype)))

    @property
    def state_shape(self):
        return [self.hidden_size]

    def _step_pre(self, whh, bhh, xg, h):
        """One step over the pre-projected input ``xg = x @ W_ih^T
        (+ b_ih)``."""
        g = xg + _recurrent(whh, bhh, h)
        h = torch.tanh(g) if self.activation == "tanh" else torch.relu(g)
        return h, h


class LSTMCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _make_cell_params(
            self, input_size, hidden_size, 4,
            (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
            dict(device=resolve_device(device), dtype=convert_dtype(dtype)))

    @property
    def state_shape(self):
        return ([self.hidden_size], [self.hidden_size])

    def _step_pre(self, whh, bhh, xg, state):
        h, c = state
        i, f, gc, o = (xg + _recurrent(whh, bhh, h)).chunk(4, -1)
        c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gc)
        h2 = torch.sigmoid(o) * torch.tanh(c2)
        return h2, (h2, c2)


class GRUCell(RNNCellBase):
    def __init__(self, input_size, hidden_size, weight_ih_attr=None,
                 weight_hh_attr=None, bias_ih_attr=None, bias_hh_attr=None,
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        _make_cell_params(
            self, input_size, hidden_size, 3,
            (weight_ih_attr, weight_hh_attr, bias_ih_attr, bias_hh_attr),
            dict(device=resolve_device(device), dtype=convert_dtype(dtype)))

    @property
    def state_shape(self):
        return [self.hidden_size]

    def _step_pre(self, whh, bhh, xg, h):
        x_r, x_z, x_c = xg.chunk(3, -1)
        h_r, h_z, h_c = _recurrent(whh, bhh, h).chunk(3, -1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        c = torch.tanh(x_c + r * h_c)
        h = (h - c) * z + c
        return h, h


def _scan_rnn(cell, inputs, initial_states, sequence_length=None,
              is_reverse=False, time_major=False):
    """The step loop over the time axis (the reference's ``_scan_rnn``):
    ``(outputs, final_states)`` in the promoted dtype. The input
    projection of every step is one product before the loop."""
    tuple_state = isinstance(initial_states, (tuple, list))
    dt = _compute_dtype(inputs, initial_states)
    wih, whh, bih, bhh = _cast(cell._params(), dt)
    xt = (inputs if time_major else inputs.transpose(0, 1)).to(dt)
    xg = xt @ wih.T  # [T, B, gates * H]
    if bih is not None:
        xg = xg + bih
    states = tuple(s.to(dt) for s in _as_tuple(initial_states))
    T = xt.shape[0]
    outs = [None] * T
    for t in (reversed(range(T)) if is_reverse else range(T)):
        out, new = cell._step_pre(whh, bhh, xg[t],
                                  states if tuple_state else states[0])
        new = _as_tuple(new)
        if sequence_length is not None:
            keep = (t < sequence_length)[:, None]
            new = tuple(torch.where(keep, n, s) for n, s in zip(new, states))
            out = torch.where(keep, out, torch.zeros_like(out))
        states = new
        outs[t] = out
    out = torch.stack(outs, 0)
    if not time_major:
        out = out.transpose(0, 1)
    return out, states if tuple_state else states[0]


def _cells_fusable(cell_fw, cell_bw) -> bool:
    """Reference :347: two cells can run as one bidirectional layer when
    they agree in class, activation, which biases they have and every
    parameter shape."""
    if type(cell_fw) is not type(cell_bw):
        return False
    if getattr(cell_fw, "activation", None) != \
            getattr(cell_bw, "activation", None):
        return False
    for a, b in zip(cell_fw._params(), cell_bw._params()):
        if (a is None) != (b is None):
            return False
        if a is not None and tuple(a.shape) != tuple(b.shape):
            return False
    return True


def _fused_layer(mode, cells, x, states, time_major):
    """One layer of ``cells`` (one, or forward and backward) in one call of
    PyTorch's fused recurrence, in the promoted dtype: ``(outputs,
    [final state per direction])``. A bias the cells leave out while
    keeping the other is zeros."""
    global cudnn_calls
    dt = _compute_dtype(x, [s for st in states for s in _as_tuple(st)])
    has_bias = any(p is not None for c in cells for p in c._params()[2:])
    flat = []
    for c in cells:
        wih, whh, bih, bhh = _cast(c._params(), dt)
        flat += [wih, whh]
        if has_bias:
            flat += [b if b is not None else
                     torch.zeros(wih.shape[0], dtype=dt, device=wih.device)
                     for b in (bih, bhh)]
    per_dir = [_as_tuple(st) for st in states]
    hx = [torch.stack([st[k] for st in per_dir]).to(dt)
          for k in range(len(per_dir[0]))]
    args = (flat, has_bias, 1, 0.0, torch.is_grad_enabled(), len(cells) == 2,
            not time_major)
    cudnn_calls += 1
    if mode == "lstm":
        out, h, c = torch._VF.lstm(x.to(dt), hx, *args)
        return out, [(h[d], c[d]) for d in range(len(cells))]
    out, h = torch._VF.gru(x.to(dt), hx[0], *args)
    return out, [h[d] for d in range(len(cells))]


def _back(out, fin, dtype):
    """Outputs and final states (a tensor, a tuple, or lists of either)
    cast to ``dtype``."""
    def cast(v):
        if isinstance(v, (tuple, list)):
            return type(v)(cast(e) for e in v)
        return v.to(dtype)
    return out.to(dtype), cast(fin)


class RNN(torch.nn.Module):
    """``cell`` over a sequence (the step loop on every device)."""

    def __init__(self, cell, is_reverse=False, time_major=False):
        super().__init__()
        self.cell = cell
        self.is_reverse = is_reverse
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None,
                **kwargs):
        if initial_states is None:
            batch_ref = inputs.transpose(0, 1) if self.time_major else inputs
            initial_states = self.cell.get_initial_states(batch_ref)
        out, fin = _scan_rnn(self.cell, inputs, initial_states,
                             sequence_length, self.is_reverse,
                             self.time_major)
        return _back(out, fin, inputs.dtype)


class BiRNN(torch.nn.Module):
    """``cell_fw`` forward and ``cell_bw`` backward over a sequence, the
    outputs concatenated (the step loop on every device)."""

    def __init__(self, cell_fw, cell_bw, time_major=False):
        super().__init__()
        self.cell_fw = cell_fw
        self.cell_bw = cell_bw
        self.time_major = time_major

    def forward(self, inputs, initial_states=None, sequence_length=None):
        states_fw, states_bw = initial_states if initial_states is not None \
            else (None, None)
        if states_fw is None:
            batch_ref = inputs.transpose(0, 1) if self.time_major else inputs
            states_fw = self.cell_fw.get_initial_states(batch_ref)
            states_bw = self.cell_bw.get_initial_states(batch_ref)
        out_fw, fin_fw = _scan_rnn(self.cell_fw, inputs, states_fw,
                                   sequence_length, False, self.time_major)
        out_bw, fin_bw = _scan_rnn(self.cell_bw, inputs, states_bw,
                                   sequence_length, True, self.time_major)
        return _back(torch.cat([out_fw, out_bw.to(out_fw.dtype)], -1),
                     (fin_fw, fin_bw), inputs.dtype)


class _RNNBase(torch.nn.Module):
    """A stack of ``num_layers`` recurrent layers, each forward or
    bidirectional; dropout between layers in training. Initial and final
    states are ``[num_layers * num_directions, batch, hidden]`` (an LSTM's
    a pair of them)."""

    _cell_cls = None
    _n_states = 1
    _fused_mode = None  # "lstm"/"gru": the card runs PyTorch's recurrence

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 weight_ih_attr=None, weight_hh_attr=None, bias_ih_attr=None,
                 bias_hh_attr=None, name=None, *, device=None,
                 dtype=torch.float32, **cell_kwargs):
        super().__init__()
        if direction in ("bidirect", "bidirectional"):
            self.num_directions = 2
        elif direction == "forward":
            self.num_directions = 1
        else:
            raise ValueError(f"unknown direction {direction!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.time_major = time_major
        self.dropout = dropout
        attrs = dict(weight_ih_attr=weight_ih_attr,
                     weight_hh_attr=weight_hh_attr,
                     bias_ih_attr=bias_ih_attr, bias_hh_attr=bias_hh_attr,
                     device=device, dtype=dtype)
        self._cells = LayerList()
        for layer_i in range(num_layers):
            in_sz = input_size if layer_i == 0 else \
                hidden_size * self.num_directions
            for _ in range(self.num_directions):
                self._cells.append(
                    self._cell_cls(in_sz, hidden_size, **cell_kwargs, **attrs))

    def _cell_at(self, layer_i, direction):
        return self._cells[layer_i * self.num_directions + direction]

    def _fused(self, x, cells, sequence_length):
        return (self._fused_mode is not None and x.is_cuda
                and sequence_length is None
                and (len(cells) == 1 or _cells_fusable(*cells)))

    def forward(self, inputs, initial_states=None, sequence_length=None):
        D = self.num_directions
        n_total = self.num_layers * D
        if initial_states is None:
            batch_ref = inputs.transpose(0, 1) if self.time_major else inputs
            init = [self._cells[0].get_initial_states(batch_ref)
                    for _ in range(n_total)]
        elif self._n_states == 2:
            h0, c0 = initial_states
            init = [(h0[i], c0[i]) for i in range(n_total)]
        else:
            init = [initial_states[i] for i in range(n_total)]
        out = inputs
        finals = []
        for layer_i in range(self.num_layers):
            if layer_i > 0 and self.dropout > 0:
                out = F.dropout(out, self.dropout, training=self.training)
            cells = [self._cell_at(layer_i, d) for d in range(D)]
            states = init[layer_i * D:(layer_i + 1) * D]
            if self._fused(out, cells, sequence_length):
                out, fins = _fused_layer(self._fused_mode, cells, out, states,
                                         self.time_major)
            else:
                runs = [_scan_rnn(c, out, s, sequence_length, d == 1,
                                  self.time_major)
                        for d, (c, s) in enumerate(zip(cells, states))]
                out = runs[0][0] if D == 1 else \
                    torch.cat([o for o, _ in runs], -1)
                fins = [f for _, f in runs]
            finals.extend(fins)
        if self._n_states == 2:
            final = (torch.stack([f[0] for f in finals]),
                     torch.stack([f[1] for f in finals]))
        else:
            final = torch.stack(finals)
        return _back(out, final, inputs.dtype)


class SimpleRNN(_RNNBase):
    _cell_cls = SimpleRNNCell

    def __init__(self, input_size, hidden_size, num_layers=1,
                 direction="forward", time_major=False, dropout=0.0,
                 activation="tanh", weight_ih_attr=None, weight_hh_attr=None,
                 bias_ih_attr=None, bias_hh_attr=None, name=None, **kw):
        super().__init__(input_size, hidden_size, num_layers, direction,
                         time_major, dropout, weight_ih_attr, weight_hh_attr,
                         bias_ih_attr, bias_hh_attr, name,
                         activation=activation, **kw)


class LSTM(_RNNBase):
    _cell_cls = LSTMCell
    _n_states = 2
    _fused_mode = "lstm"


class GRU(_RNNBase):
    _cell_cls = GRUCell
    _fused_mode = "gru"
