"""The port's recurrent layers (``paddle_tpu_torch.nn.layer.rnn``) against
the JAX package's, on the CPU, where they run the step loop: SimpleRNN,
LSTM and GRU of 2 layers, forward and bidirectional, batch- and
time-major, with explicit initial states and with ``sequence_length``;
the ``RNN`` and ``BiRNN`` wrappers (the bidirectional one with two cells
that cannot fuse) and single cell steps. Outputs, final states and the
gradients of the input and every parameter are compared.

The card's route (PyTorch's fused recurrence, ``_fused_layer``) is also
held here against the step loop, called directly on CPU tensors: it
checks that the weights, biases and states are laid out as PyTorch
expects. Weights cross through numpy; float32; the tolerance of the
reference's ``tests/test_layers.py`` (rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn as jnn
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.nn.layer import rnn
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

TOL = dict(rtol=1e-4, atol=1e-5)
B, T, IN, H = 3, 5, 4, 6


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _flat(v):
    if isinstance(v, (tuple, list)):
        return [e for x in v for e in _flat(x)]
    return [v]


def _rand(*shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _run(layer, x, states, seqlen, to_t, grads_of):
    """Outputs, final states and the gradients of sum(out * c) + the same
    over each final state, with seeded cotangents."""
    xt = to_t(x, True)
    st = None if states is None else \
        tuple(to_t(s, True) for s in states) if isinstance(states, tuple) \
        else to_t(states, True)
    args = [xt, st] + ([to_t(seqlen, False)] if seqlen is not None else [])
    out, fin = layer(*args)
    outs = [out] + _flat(fin)
    total = None
    for i, o in enumerate(outs):
        c = to_t(_rand(*tuple(o.shape), seed=50 + i), False)
        term = (o * c).sum()
        total = term if total is None else total + term
    total.backward()
    return [_np(o) for o in outs], grads_of(
        layer, [xt] + ([] if st is None else _flat(st)))


def _torch_t(a, grad):
    t = torch.from_numpy(np.asarray(a))
    return t.requires_grad_(True) if grad and t.is_floating_point() else t


def _jax_t(a, grad):
    return pt.to_tensor(np.asarray(a), stop_gradient=not grad)


def _grads(layer, inputs):
    return ([_np(t.grad) for t in inputs],
            {n: _np(p.grad) for n, p in layer.named_parameters()})


def _assert_same(jl, tl, x, states=None, seqlen=None):
    ref = _run(jl, x, states, seqlen, _jax_t, _grads)
    ours = _run(tl, x, states, seqlen, _torch_t, _grads)
    assert len(ours[0]) == len(ref[0])
    for a, b in zip(ours[0], ref[0]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(ours[1][0], ref[1][0]):
        np.testing.assert_allclose(a, b, **TOL)
    assert sorted(ours[1][1]) == sorted(ref[1][1])
    for n, g in ref[1][1].items():
        np.testing.assert_allclose(ours[1][1][n], g, err_msg=n, **TOL)


def _pair(name, direction="forward", time_major=False, **kw):
    pt.seed(7)
    jl = getattr(jnn, name)(IN, H, num_layers=2, direction=direction,
                            time_major=time_major, **kw)
    tl = getattr(tnn, name)(IN, H, num_layers=2, direction=direction,
                            time_major=time_major, device="cpu", **kw)
    load_numpy_state(tl, state_dict_from_jax(jl))
    return jl, tl


def _initial(name, direction, seed=3):
    n = 2 * (2 if direction == "bidirect" else 1)
    h = 0.5 * _rand(n, B, H, seed=seed)
    return (h, 0.5 * _rand(n, B, H, seed=seed + 1)) if name == "LSTM" else h


NAMES = ["SimpleRNN", "LSTM", "GRU"]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
def test_stacked_rnn_matches_jax(name, direction):
    jl, tl = _pair(name, direction)
    assert sorted(n for n, _ in tl.named_parameters())[:4] == [
        "_cells.0.bias_hh", "_cells.0.bias_ih", "_cells.0.weight_hh",
        "_cells.0.weight_ih"]
    _assert_same(jl, tl, _rand(B, T, IN, seed=1))


@pytest.mark.parametrize("name", NAMES)
def test_time_major_with_initial_states(name):
    jl, tl = _pair(name, "bidirect", time_major=True)
    _assert_same(jl, tl, _rand(T, B, IN, seed=2),
                 states=_initial(name, "bidirect"))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
def test_sequence_length(name, direction):
    """Steps past a sample's length keep its state and emit zeros, in
    both directions (the backward direction starts at the last real
    step)."""
    jl, tl = _pair(name, direction)
    seqlen = np.array([5, 2, 3], np.int64)
    _assert_same(jl, tl, _rand(B, T, IN, seed=4),
                 states=_initial(name, direction, seed=5), seqlen=seqlen)
    out, _ = tl(torch.from_numpy(_rand(B, T, IN, seed=4)),
                sequence_length=torch.from_numpy(seqlen))
    assert bool(torch.all(out[1, 2:] == 0)) and bool(torch.all(out[2, 3:] == 0))


def test_simple_rnn_relu():
    jl, tl = _pair("SimpleRNN", "bidirect", activation="relu")
    _assert_same(jl, tl, _rand(B, T, IN, seed=6))


def test_birnn_with_cells_that_do_not_fuse():
    """A GRU cell forward and a SimpleRNN cell backward (the reference runs
    two scans), and a fusable pair (its one bidirectional scan)."""
    for make_bw in (lambda m, **kw: m.SimpleRNNCell(IN, H, **kw),
                    lambda m, **kw: m.GRUCell(IN, H, **kw)):
        pt.seed(8)
        jl = jnn.BiRNN(jnn.GRUCell(IN, H), make_bw(jnn))
        tl = tnn.BiRNN(tnn.GRUCell(IN, H, device="cpu"),
                       make_bw(tnn, device="cpu"))
        load_numpy_state(tl, state_dict_from_jax(jl))
        _assert_same(jl, tl, _rand(B, T, IN, seed=9))


def test_rnn_wrapper_reverse_and_lstm_cell():
    pt.seed(9)
    jl = jnn.RNN(jnn.LSTMCell(IN, H), is_reverse=True)
    tl = tnn.RNN(tnn.LSTMCell(IN, H, device="cpu"), is_reverse=True)
    load_numpy_state(tl, state_dict_from_jax(jl))
    _assert_same(jl, tl, _rand(B, T, IN, seed=10),
                 states=(_rand(B, H, seed=11), _rand(B, H, seed=12)))


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_one_cell_step(cell):
    pt.seed(10)
    jl = getattr(jnn, cell)(IN, H)
    tl = getattr(tnn, cell)(IN, H, device="cpu")
    load_numpy_state(tl, state_dict_from_jax(jl))
    x = _rand(B, IN, seed=13)
    jo, js = jl(pt.to_tensor(x))
    to, ts = tl(torch.from_numpy(x))
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    for a, b in zip(_flat(ts), _flat(js)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("name", ["LSTM", "GRU"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("time_major", [False, True])
def test_fused_layer_lays_out_weights_as_pytorch_expects(name, direction,
                                                         time_major):
    """``_fused_layer`` (the card's route, here on CPU tensors) against
    the step loop layer by layer: outputs, final states and gradients;
    a cell without ``bias_ih`` runs with zeros in its place."""
    ptt.seed(11)
    kw = dict(num_layers=2, direction=direction, time_major=time_major,
              device="cpu")
    loop = getattr(tnn, name)(IN, H, bias_ih_attr=False, **kw)
    x = _rand(*((T, B, IN) if time_major else (B, T, IN)), seed=14)
    states = _initial(name, direction, seed=15)
    ref = _run(loop, x, states, None, _torch_t, _grads)

    def fused_forward(inputs, initial_states):
        D = loop.num_directions
        per_cell = [tuple(s[i] for s in initial_states)
                    for i in range(2 * D)] if name == "LSTM" else \
            [initial_states[i] for i in range(2 * D)]
        out, finals = inputs, []
        for layer_i in range(2):
            cells = [loop._cell_at(layer_i, d) for d in range(D)]
            out, fins = rnn._fused_layer(name.lower(), cells, out,
                                         per_cell[layer_i * D:
                                                  (layer_i + 1) * D],
                                         time_major)
            finals += fins
        if name == "LSTM":
            return out, (torch.stack([f[0] for f in finals]),
                         torch.stack([f[1] for f in finals]))
        return out, torch.stack(finals)
    loop.zero_grad()
    before = rnn.cudnn_calls
    ours = _run(lambda *a: fused_forward(*a), x, states, None, _torch_t,
                lambda _, inputs: _grads(loop, inputs))
    assert rnn.cudnn_calls == before + 2
    for a, b in zip(ours[0], ref[0]):
        np.testing.assert_allclose(a, b, **TOL)
    for a, b in zip(ours[1][0], ref[1][0]):
        np.testing.assert_allclose(a, b, **TOL)
    for n, g in ref[1][1].items():
        np.testing.assert_allclose(ours[1][1][n], g, err_msg=n, **TOL)


def test_cpu_takes_the_step_loop_and_dropout_is_seeded():
    """On CPU tensors no layer takes the fused route; the dropout between
    layers draws from ``core.generator``, so a seed repeats it, and it is
    off at inference."""
    lstm = tnn.LSTM(IN, H, num_layers=2, dropout=0.5, device="cpu")
    x = torch.from_numpy(_rand(B, T, IN, seed=16))
    before = rnn.cudnn_calls
    ptt.seed(1)
    a, _ = lstm(x)
    ptt.seed(1)
    b, _ = lstm(x)
    assert rnn.cudnn_calls == before
    assert torch.equal(a, b)
    lstm.eval()
    c, _ = lstm(x)
    lstm.dropout = 0.0
    d, _ = lstm(x)
    assert torch.equal(c, d) and not torch.equal(a, c)


def test_bfloat16_input_computes_in_float32_and_returns_bfloat16():
    """The default states are float32, so a bfloat16 input computes in
    float32, as the reference promotes; the result comes back in
    bfloat16."""
    lstm = tnn.LSTM(IN, H, device="cpu")
    x = torch.from_numpy(_rand(B, T, IN, seed=17))
    with torch.no_grad():
        out32, _ = lstm(x)
        out, (h, c) = lstm.to(torch.bfloat16)(x.to(torch.bfloat16))
    assert out.dtype == h.dtype == c.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _np(out32), atol=2e-2)
