"""The port's DiT (``paddle_tpu_torch.models.dit``) against the JAX
package's, on the CPU: a fresh model outputs exactly 0 (adaLN-Zero, as
the reference's ``tests/test_models.py:113-127`` checks); on bridged
non-zero weights the forward and every gradient match; the timestep
embedding and unpatchify match; and a head_dim of 72 (DiT-XL/2's) goes
through the flash wrapper's plain path on the CPU, forward and
backward, against the JAX package's attention.

Tolerances, float32 on both sides: outputs rtol 1e-4 / atol 1e-5,
gradients rtol 2e-4 / atol 2e-5 (the layer tests' and their double for a
backward); attention at the flash tests' rtol 2e-4 / atol 2e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.nn.functional as JF
from paddle_tpu.models import dit as jd
import paddle_tpu_torch as ptt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.models import dit as td
from paddle_tpu_torch.ops.pallas import flash_attention as fa
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import state_dict_from_jax

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
ATTN = dict(rtol=2e-4, atol=2e-5)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.data if hasattr(t, "data") else t)


def _inputs(cfg, seed=0, B=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, cfg.in_channels, cfg.input_size,
                  cfg.input_size).astype(np.float32)
    t = rng.randint(0, 1000, B).astype(np.int32)
    y = rng.randint(0, cfg.num_classes, B).astype(np.int32)
    return x, t, y


def test_fresh_model_outputs_exactly_zero():
    ptt.seed(5)
    cfg = td.DiTConfig.tiny()
    model = td.DiT(cfg, device="cpu")
    out = model(*[torch.from_numpy(a) for a in _inputs(cfg, 3)])
    assert tuple(out.shape) == (2, 2 * cfg.in_channels, cfg.input_size,
                                cfg.input_size)
    assert bool(torch.all(out == 0))
    loss = torch.mean(torch.square(out))
    loss.backward()
    # only the final linear's parameters see a gradient at init
    assert float(model.final_layer.linear.bias.grad.abs().sum()) == 0.0
    assert model.pos_embed.shape == (1, 16, cfg.hidden_size)
    assert abs(float(model.pos_embed.detach().std()) - 0.02) < 0.005


def _bridged(cfg_kw, seed):
    """A JAX DiT with every weight moved off its init (so adaLN-Zero
    paths carry signal) and its port twin."""
    pt.seed(seed)
    jm = jd.DiT(jd.DiTConfig.tiny(**cfg_kw))
    rng = np.random.RandomState(seed)
    state = {n: (v + 0.05 * rng.randn(*v.shape)).astype(np.float32)
             for n, v in state_dict_from_jax(jm).items()}
    jm.set_state_dict({n: pt.to_tensor(v) for n, v in state.items()})
    tm = td.DiT(td.DiTConfig.tiny(**cfg_kw), device="cpu")
    assert [n for n, _ in tm.named_parameters()] == list(state)
    load_numpy_state(tm, state)
    return jm, tm


@pytest.mark.parametrize("cfg_kw", [
    {},
    # head_dim 72, as DiT-XL/2 (1152 / 16): the plain flash path
    dict(hidden_size=144, num_heads=2, depth=1)],
    ids=["tiny", "head_dim_72"])
def test_forward_and_every_gradient_match_jax(cfg_kw):
    jm, tm = _bridged(cfg_kw, 6)
    cfg = tm.cfg
    x, t, y = _inputs(cfg, 7)
    target = np.random.RandomState(8).randn(
        2, 2 * cfg.in_channels, cfg.input_size,
        cfg.input_size).astype(np.float32)
    jx = pt.to_tensor(x, stop_gradient=False)
    jout = jm(jx, pt.to_tensor(t), pt.to_tensor(y))
    JF.mse_loss(jout, pt.to_tensor(target)).backward()
    tx = torch.from_numpy(x).requires_grad_()
    out = tm(tx, torch.from_numpy(t), torch.from_numpy(y))
    F.mse_loss(out, torch.from_numpy(target)).backward()
    np.testing.assert_allclose(_np(out), _np(jout), **FWD)
    np.testing.assert_allclose(_np(tx.grad), _np(jx.grad), **GRAD)
    jg = {n: _np(p.grad) for n, p in jm.named_parameters()}
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), jg[n], err_msg=n, **GRAD)


def test_timestep_embedding_and_unpatchify_match_jax():
    t = np.array([0, 1, 10, 500, 999], np.int32)
    ref = _np(jd.timestep_embedding(pt.to_tensor(t), 256))
    ours = td.timestep_embedding(torch.from_numpy(t), 256)
    assert ours.dtype == torch.float32
    # cos/sin of arguments up to 999 rad: the frameworks' exp may differ
    # by one ulp of a frequency, which moves an argument by up to an ulp
    # of 999 and the result by as much; two such ulps are the limit
    np.testing.assert_allclose(_np(ours), ref, rtol=0,
                               atol=2 * float(np.spacing(np.float32(999))))
    jm, tm = _bridged({}, 9)
    x = np.random.RandomState(10).randn(2, 16, 32).astype(np.float32)
    np.testing.assert_array_equal(_np(tm.unpatchify(torch.from_numpy(x))),
                                  _np(jm.unpatchify(pt.to_tensor(x))))


def test_head_dim_72_attention_matches_jax_on_the_cpu():
    """The flash wrapper at head_dim 72 on CPU tensors: no padding (the
    plain version runs at the caller's width), no launch counted, and
    the JAX package's attention reproduced, forward and backward."""
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(2, 40, 3, 72).astype(np.float32) for _ in range(3))
    do = rng.randn(2, 40, 3, 72).astype(np.float32)
    jq, jk, jv = (pt.to_tensor(a, stop_gradient=False) for a in (q, k, v))
    jo = JF.scaled_dot_product_attention(jq, jk, jv)
    (jo * pt.to_tensor(do)).sum().backward()
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
              fa.launches_padded)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = F.scaled_dot_product_attention(tq, tk, tv)
    (to * torch.from_numpy(do)).sum().backward()
    assert (fa.launches_fwd, fa.launches_dq, fa.launches_dkv,
            fa.launches_padded) == before
    np.testing.assert_allclose(_np(to), _np(jo), **ATTN)
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), **ATTN)


def test_zero_padding_to_the_kernel_width_changes_nothing():
    """What the card does at head_dim 72, run through the plain
    versions: q, k and v zero-padded to 128 with the scale of 72 give the
    same o and lse, zeros in the padded columns, and through the pad's
    and the slice's autograd the same gradients."""
    rng = np.random.RandomState(12)
    leaves = [torch.from_numpy(rng.randn(2, 3, 33, 72).astype(np.float32))
              .requires_grad_() for _ in range(3)]
    do = torch.from_numpy(rng.randn(2, 3, 33, 72).astype(np.float32))
    o72, lse72 = fa.flash_attention_reference(*leaves)
    g72 = torch.autograd.grad(o72, leaves, do)
    pad = [torch.nn.functional.pad(t, (0, 56)) for t in leaves]
    o128, lse128 = fa.flash_attention_reference(*pad, sm_scale=72 ** -0.5)
    assert bool(torch.all(o128[..., 72:] == 0))
    g128 = torch.autograd.grad(o128[..., :72], leaves, do)
    torch.testing.assert_close(o128[..., :72], o72, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse128, lse72, rtol=1e-5, atol=1e-6)
    for a, b in zip(g128, g72):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.DiT(td.DiTConfig.tiny())
