"""``paddle.amp`` of the port (``amp/auto_cast.py``, ``amp/grad_scaler.py``)
held against the JAX package: the two lists name for name; every listed
op the port has, run under ``auto_cast`` at O1 and O2 in both low dtypes,
with the reference's output dtype; the policy's routing of every listed
name; custom lists and nesting; ``decorate``; the ``GradScaler`` scale
trajectory on the same gradients; and ``tests/test_amp.py``'s two
end-to-end loops on twin models."""
import importlib

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.core.tensor import Tensor
from test_torch_bridge import one_torch_thread  # noqa: F401
from torch_api_common import on_cpu  # noqa: F401

# the modules (each package's ``amp.auto_cast`` attribute is the function)
ref_ac = importlib.import_module("paddle_tpu.amp.auto_cast")
port_ac = importlib.import_module("paddle_tpu_torch.amp.auto_cast")


def _r(*shape, seed=0, low=None):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.abs(x) + 0.5 if low == "pos" else x


def _i(*shape, high=4):
    return np.random.RandomState(1).randint(0, high, shape).astype(np.int64)


# name -> (call(pkg, args), numpy inputs): each listed op the port has,
# reached the way a user reaches it
OPS = {
    "matmul": (lambda p, a: p.matmul(*a), [_r(4, 4), _r(4, 4, seed=1)]),
    "mm": (lambda p, a: p.mm(*a), [_r(4, 4), _r(4, 4, seed=1)]),
    "bmm": (lambda p, a: p.bmm(*a), [_r(2, 3, 4), _r(2, 4, 5)]),
    "einsum": (lambda p, a: p.einsum("ij,jk->ik", *a),
               [_r(3, 4), _r(4, 2)]),
    "addmm": (lambda p, a: p.addmm(*a), [_r(3, 2), _r(3, 4), _r(4, 2)]),
    "mv": (lambda p, a: p.mv(*a), [_r(3, 4), _r(4)]),
    "exp": (lambda p, a: p.exp(*a), [_r(3, 4)]),
    "log": (lambda p, a: p.log(*a), [_r(3, 4, low="pos")]),
    "log2": (lambda p, a: p.log2(*a), [_r(3, 4, low="pos")]),
    "log10": (lambda p, a: p.log10(*a), [_r(3, 4, low="pos")]),
    "log1p": (lambda p, a: p.log1p(*a), [_r(3, 4, low="pos")]),
    "pow": (lambda p, a: p.pow(a[0], 2.0), [_r(3, 4)]),
    "square": (lambda p, a: p.square(*a), [_r(3, 4)]),
    "sqrt": (lambda p, a: p.sqrt(*a), [_r(3, 4, low="pos")]),
    "rsqrt": (lambda p, a: p.rsqrt(*a), [_r(3, 4, low="pos")]),
    "mean": (lambda p, a: p.mean(*a), [_r(3, 4)]),
    "sum": (lambda p, a: p.sum(*a), [_r(3, 4)]),
    "cumsum": (lambda p, a: p.cumsum(a[0], axis=0), [_r(3, 4)]),
    "prod": (lambda p, a: p.prod(*a), [_r(3, 4)]),
    "norm": (lambda p, a: p.norm(*a), [_r(3, 4)]),
    "erf": (lambda p, a: p.erf(*a), [_r(3, 4)]),
    "erfinv": (lambda p, a: p.erfinv(a[0] * 0.1), [_r(3, 4)]),
    "dist": (lambda p, a: p.dist(*a), [_r(3, 4), _r(3, 4, seed=1)]),
    "logsumexp": (lambda p, a: p.logsumexp(*a), [_r(3, 4)]),
    "conv1d": (lambda p, a: p.nn.functional.conv1d(*a),
               [_r(1, 2, 8), _r(3, 2, 3)]),
    "conv2d": (lambda p, a: p.nn.functional.conv2d(*a),
               [_r(1, 2, 6, 6), _r(3, 2, 3, 3)]),
    "conv3d": (lambda p, a: p.nn.functional.conv3d(*a),
               [_r(1, 2, 4, 4, 4), _r(3, 2, 3, 3, 3)]),
    "conv1d_transpose": (lambda p, a: p.nn.functional.conv1d_transpose(*a),
                         [_r(1, 2, 8), _r(2, 3, 3)]),
    "conv2d_transpose": (lambda p, a: p.nn.functional.conv2d_transpose(*a),
                         [_r(1, 2, 5, 5), _r(2, 3, 3, 3)]),
    "conv3d_transpose": (lambda p, a: p.nn.functional.conv3d_transpose(*a),
                         [_r(1, 2, 3, 3, 3), _r(2, 3, 3, 3, 3)]),
    "linear": (lambda p, a: p.nn.functional.linear(*a),
               [_r(2, 4), _r(4, 3), _r(3)]),
    "flash_attention": (lambda p, a: p.nn.functional.flash_attention(
        *a, causal=True), [_r(1, 8, 2, 16), _r(1, 8, 2, 16, seed=1),
                           _r(1, 8, 2, 16, seed=2)]),
    "scaled_dot_product_attention": (
        lambda p, a: p.nn.functional.scaled_dot_product_attention(*a),
        [_r(1, 8, 2, 16), _r(1, 8, 2, 16, seed=1), _r(1, 8, 2, 16, seed=2)]),
    "softmax": (lambda p, a: p.nn.functional.softmax(*a), [_r(3, 4)]),
    "log_softmax": (lambda p, a: p.nn.functional.log_softmax(*a),
                    [_r(3, 4)]),
    "cross_entropy": (lambda p, a: p.nn.functional.cross_entropy(*a),
                      [_r(4, 5), _i(4)]),
    "nll_loss": (lambda p, a: p.nn.functional.nll_loss(*a),
                 [_r(4, 5), _i(4)]),
    "binary_cross_entropy": (
        lambda p, a: p.nn.functional.binary_cross_entropy(
            p.nn.functional.sigmoid(a[0]), a[1]),
        [_r(4, 3), (_i(4, 3, high=2)).astype(np.float32)]),
    "binary_cross_entropy_with_logits": (
        lambda p, a: p.nn.functional.binary_cross_entropy_with_logits(*a),
        [_r(4, 3), (_i(4, 3, high=2)).astype(np.float32)]),
    "kl_div": (lambda p, a: p.nn.functional.kl_div(*a),
               [_r(4, 3), _r(4, 3, low="pos")]),
    "ctc_loss": (lambda p, a: p.nn.functional.ctc_loss(
        a[0], a[1], a[2], a[3]),
        [_r(6, 2, 5), _i(2, 2, high=4) + 1,
         np.array([6, 5], np.int64), np.array([2, 1], np.int64)]),
    "layer_norm": (lambda p, a: p.nn.functional.layer_norm(
        a[0], [4], a[1], a[2]), [_r(3, 4), _r(4), _r(4)]),
    "rms_norm": (lambda p, a: p.nn.functional.rms_norm(*a),
                 [_r(3, 4), _r(4)]),
    "batch_norm": (lambda p, a: p.nn.functional.batch_norm(
        a[0], a[1], a[2], training=True),
        [_r(4, 3), np.zeros(3, np.float32), np.ones(3, np.float32)]),
    "instance_norm": (lambda p, a: p.nn.functional.instance_norm(*a),
                      [_r(2, 3, 4, 4)]),
    "group_norm": (lambda p, a: p.nn.functional.group_norm(a[0], 2),
                   [_r(2, 4, 3, 3)]),
    "local_response_norm": (
        lambda p, a: p.nn.functional.local_response_norm(a[0], 3),
        [_r(1, 4, 3, 3)]),
    "smooth_l1_loss": (lambda p, a: p.nn.functional.smooth_l1_loss(*a),
                       [_r(3, 4), _r(3, 4, seed=1)]),
    "mse_loss": (lambda p, a: p.nn.functional.mse_loss(*a),
                 [_r(3, 4), _r(3, 4, seed=1)]),
    "l1_loss": (lambda p, a: p.nn.functional.l1_loss(*a),
                [_r(3, 4), _r(3, 4, seed=1)]),
    "softplus": (lambda p, a: p.nn.functional.softplus(*a), [_r(3, 4)]),
}
# listed names with no op in the port: the JAX package has no op named
# conv_nd or softmax_with_cross_entropy, and the port has no
# cosine_similarity or sigmoid_focal_loss yet (ROADMAP §1 item 3); their
# routing is held by test_policy_routes_every_name
NOT_PORTED = {"conv_nd", "softmax_with_cross_entropy", "cosine_similarity",
              "sigmoid_focal_loss"}


def _dtype_name(out):
    out = out[0] if isinstance(out, (tuple, list)) else out
    return str(out.dtype).replace("paddle.", "").replace("torch.", "")


def test_lists_are_the_references():
    assert port_ac.white_list() == ref_ac.white_list()
    assert port_ac.black_list() == ref_ac.black_list()
    assert set(OPS) | NOT_PORTED == ref_ac.WHITE_LIST | ref_ac.BLACK_LIST


@pytest.mark.parametrize("level,dtype", [("O1", "bfloat16"),
                                         ("O2", "bfloat16"),
                                         ("O1", "float16"),
                                         ("O2", "float16")])
@pytest.mark.parametrize("name", sorted(OPS))
def test_listed_op_gives_the_references_dtype(name, level, dtype):
    call, arrays = OPS[name]
    port_in = [ptt.to_tensor(a) for a in arrays]

    def reference(*arrs):
        with pt.amp.auto_cast(level=level, dtype=dtype):
            out = call(pt, [Tensor(a) for a in arrs])
        return (out[0] if isinstance(out, (tuple, list)) else out).data
    # the reference's result type, from an abstract evaluation of the
    # same calls (no XLA compile per op and dtype)
    want = str(jax.eval_shape(reference, *arrays).dtype)
    with ptt.amp.auto_cast(level=level, dtype=dtype):
        got = _dtype_name(call(ptt, port_in))
    assert got == want


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", sorted(ref_ac.WHITE_LIST
                                        | ref_ac.BLACK_LIST))
def test_policy_routes_every_name(name, level):
    """The target dtype of every listed name (and of an unlisted op)."""
    for dtype in ("bfloat16", "float16"):
        for op in (name, "add"):
            with pt.amp.auto_cast(level=level, dtype=dtype):
                want = ref_ac._policy_dtype(ref_ac.amp_state(), op)
            with ptt.amp.auto_cast(level=level, dtype=dtype):
                got = port_ac._policy_dtype(port_ac.amp_state(), op)
            assert got == want


def test_o1_keeps_and_o2_casts_other_ops():
    a = ptt.to_tensor(_r(4, 4))
    with ptt.amp.auto_cast(level="O1"):
        assert (a + a).dtype == ptt.float32
        assert ptt.add(a, a).dtype == ptt.float32
    with ptt.amp.auto_cast(level="O2"):
        assert ptt.add(a, a).dtype == ptt.bfloat16
    with ptt.amp.auto_cast(level="O0"):
        assert ptt.matmul(a, a).dtype == ptt.float32


def test_disabled_and_nested_restore():
    a = ptt.to_tensor(_r(4, 4))
    with ptt.amp.auto_cast(enable=False):
        assert ptt.matmul(a, a).dtype == ptt.float32
    with ptt.amp.auto_cast(dtype="bfloat16"):
        with ptt.amp.auto_cast(enable=False):
            assert ptt.matmul(a, a).dtype == ptt.float32
        with ptt.amp.amp_guard(dtype="float16"):
            assert ptt.matmul(a, a).dtype == ptt.float16
        assert ptt.matmul(a, a).dtype == ptt.bfloat16
    assert ptt.matmul(a, a).dtype == ptt.float32
    assert port_ac._open[0] == 0
    with pytest.raises(ValueError, match="level"):
        with ptt.amp.auto_cast(level="O3"):
            pass
    with pytest.raises(ValueError, match="dtype"):
        with ptt.amp.auto_cast(dtype="float64"):
            pass


def test_custom_lists():
    a = ptt.to_tensor(_r(4, 4))
    with ptt.amp.auto_cast(custom_black_list={"matmul"}, dtype="bfloat16"):
        assert ptt.matmul(a, a).dtype == ptt.float32
    with ptt.amp.auto_cast(custom_white_list={"softmax"}, dtype="bfloat16"):
        assert ptt.nn.functional.softmax(a).dtype == ptt.bfloat16
    # white is applied first, then black: a name on both ends black
    with ptt.amp.auto_cast(custom_white_list={"exp"},
                           custom_black_list={"exp"}):
        assert ptt.exp(a).dtype == ptt.float32


def test_layers_and_the_llama_logits_follow_the_policy():
    """A port layer's inner calls (``Linear`` through ``F.linear``) and
    the tied Llama head's product (a direct ``torch.matmul``, the
    reference's ``ops.matmul``) cast as the reference's ops do."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    lin = ptt.nn.Linear(4, 3)
    x = ptt.to_tensor(_r(2, 4))
    with ptt.amp.auto_cast(dtype="float16"):
        assert lin(x).dtype == ptt.float16
    m = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=True),
                         device="cpu")
    ids = torch.as_tensor(_i(2, 8, high=256))
    with ptt.amp.auto_cast(dtype="bfloat16"), torch.no_grad():
        logits, loss = m(ids, labels=ids)
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32


def test_decorate_o2_casts_params():
    m = ptt.nn.Linear(4, 4)
    o = ptt.optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
    m2, o2 = ptt.amp.decorate(m, o, level="O2", dtype="bfloat16")
    assert m2 is m and o2 is o
    assert m.weight.dtype == torch.bfloat16 and o._multi_precision
    ms = ptt.amp.decorate([ptt.nn.Linear(2, 2)], level="O1")
    assert ms[0].weight.dtype == torch.float32
    assert ptt.amp.is_bfloat16_supported("cpu")
    assert ptt.amp.is_float16_supported("cpu")


def test_grad_scaler_trajectory_equals_the_reference():
    """The same gradients (finite, and with an inf) through both scalers:
    the same scale after every update, the same steps skipped, the same
    parameters, and ``state_dict`` round trips across the packages."""
    grads = [np.ones((2, 2), np.float32)] * 3 + \
        [np.array([[np.inf, 1], [1, 1]], np.float32)] + \
        [np.full((2, 2), 0.5, np.float32)] * 4
    jp = pt.Parameter(np.ones((2, 2), np.float32))
    tp = ptt.Parameter(np.ones((2, 2), np.float32))
    jo = pt.optimizer.SGD(learning_rate=0.1, parameters=[jp])
    to = ptt.optimizer.SGD(learning_rate=0.1, parameters=[tp])
    kw = dict(init_loss_scaling=8.0, incr_ratio=2.0, decr_ratio=0.5,
              incr_every_n_steps=2)
    js, ts = pt.amp.GradScaler(**kw), ptt.amp.GradScaler(**kw)
    for g in grads:
        jp.grad = pt.to_tensor(g * js.get_loss_scaling())
        tp.grad = ptt.to_tensor(g * ts.get_loss_scaling())
        js.step(jo)
        ts.step(to)
        js.update()
        ts.update()
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        np.testing.assert_allclose(tp.numpy(), jp.numpy(), rtol=1e-6)
    assert ts.state_dict() == js.state_dict()
    back = ptt.amp.GradScaler()
    back.load_state_dict(js.state_dict())
    assert back.state_dict() == js.state_dict()
    assert ptt.amp.AmpScaler is ptt.amp.GradScaler


def test_scaler_scales_and_skips():
    p = ptt.Parameter(np.ones((2, 2), np.float32))
    o = ptt.optimizer.SGD(learning_rate=0.1, parameters=[p])
    scaler = ptt.amp.GradScaler(init_loss_scaling=8.0)
    loss = (p * ptt.to_tensor(np.ones((2, 2), np.float32))).sum()
    scaler.scale(loss).backward()
    np.testing.assert_allclose(p.grad.numpy(), 8 * np.ones((2, 2)))
    scaler.minimize(o, loss)
    np.testing.assert_allclose(p.numpy(), 0.9, rtol=1e-6)
    off = ptt.amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()


def _loop(pkg, X, Y, use_amp, steps, opt, amp_dtype, scaler_kw=None,
          seed=5):
    """``tests/test_amp.py``'s loops; the port's model starts from the
    reference's weights (``seed`` draws the reference's)."""
    pt.seed(seed)
    jm = pt.nn.Sequential(pt.nn.Linear(X.shape[1], 2 * X.shape[1]),
                          pt.nn.ReLU(), pt.nn.Linear(2 * X.shape[1],
                                                     Y.shape[1]))
    if pkg is pt:
        m = jm
    else:
        m = ptt.nn.Sequential(ptt.nn.Linear(X.shape[1], 2 * X.shape[1]),
                              ptt.nn.ReLU(), ptt.nn.Linear(2 * X.shape[1],
                                                           Y.shape[1]))
        m.set_state_dict({k: np.asarray(v.numpy())
                          for k, v in jm.state_dict().items()})
    o = opt(pkg, m)
    scaler = pkg.amp.GradScaler(**scaler_kw) if scaler_kw else None
    x, y = pkg.to_tensor(X), pkg.to_tensor(Y)
    losses = []
    for _ in range(steps):
        with pkg.amp.auto_cast(enable=use_amp, dtype=amp_dtype):
            loss = pkg.nn.MSELoss()(m(x), y)
        if scaler is not None:
            scaler.scale(loss).backward()
            scaler.step(o)
            scaler.update()
        else:
            loss.backward()
            o.step()
        o.clear_grad()
        losses.append(float(loss.numpy()))
    return np.array(losses)


def test_bf16_training_tracks_fp32():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 16).astype(np.float32)
    Y = X @ rng.randn(16, 4).astype(np.float32)

    def adamw(pkg, m):
        return pkg.optimizer.AdamW(learning_rate=0.01,
                                   parameters=m.parameters())
    base = _loop(ptt, X, Y, False, 30, adamw, "bfloat16")
    mixed = _loop(ptt, X, Y, True, 30, adamw, "bfloat16")
    ref = _loop(pt, X, Y, True, 30, adamw, "bfloat16")
    assert mixed[-1] < base[0] * 0.1  # converges
    assert abs(mixed[-1] - base[-1]) / base[0] < 0.05
    # the reference's bf16 trajectory, within bf16 rounding of the loss
    np.testing.assert_allclose(mixed, ref, rtol=5e-2, atol=5e-3 * ref[0])


def test_fp16_scaler_loop():
    rng = np.random.RandomState(1)
    X = rng.randn(32, 8).astype(np.float32)
    Y = X @ rng.randn(8, 2).astype(np.float32)

    def momentum(pkg, m):
        return pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                      parameters=m.parameters())
    kw = dict(init_loss_scaling=1024.0)
    losses = _loop(ptt, X, Y, True, 60, momentum, "float16", kw, seed=2)
    ref = _loop(pt, X, Y, True, 60, momentum, "float16", kw, seed=2)
    assert losses[-1] < losses[0] * 0.2
    np.testing.assert_allclose(losses, ref, rtol=5e-2, atol=5e-3 * ref[0])
