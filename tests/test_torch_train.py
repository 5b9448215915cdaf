"""The port's training path against the JAX package's, on the CPU.

The same bridged weights go through ``paddle_tpu``'s Llama (its
attention on the CPU is the composite the flash kernel is tested
against) and the port's cacheless Llama (the flash wrappers' plain
versions): logits with and without segment ids and per-token positions,
both loss routes (cross entropy over the logits, and the fused chunked
CE of a tied vocab of at least 32768) with every parameter gradient,
and three ``TrainStep`` steps of AdamW with a global-norm clip, after
which every parameter and moment must match. Everything is float32.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops.fused_ce import matmul_cross_entropy
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.utils.bridge import (load_optimizer_state,
                                           optimizer_state_to_numpy)

from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import bridged, jax_tiny, state_dict_from_jax

# f32 on both sides; the two frameworks sum in other orders, and a
# backward through 2 layers compounds that to a few ulps of the values
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _np(t):
    return np.asarray(t.data if hasattr(t, "data") else t)


def _jax_grads(jm, ids, **kw):
    """Loss and ``{name: grad}`` of the JAX model's eager tape."""
    _, loss = jm(pt.to_tensor(ids), labels=pt.to_tensor(kw.pop("labels")),
                 **{k: pt.to_tensor(v) for k, v in kw.items()})
    loss.backward()
    return float(_np(loss)), {n: _np(p.grad)
                              for n, p in jm.named_parameters()}


def _port_grads(tm, ids, **kw):
    kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    _, loss = tm(torch.from_numpy(ids), **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in tm.named_parameters()}


def _packed_batch(rng, vocab, B=2, S=16):
    """Ids, two documents per row as segment ids (1, 2, 0 = pad), and
    positions that restart in each document."""
    ids = rng.randint(1, vocab, (B, S)).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pos = np.zeros((B, S), np.int32)
    for b, (n1, n2) in enumerate(((6, 10), (9, 4))):
        seg[b, :n1], seg[b, n1:n1 + n2] = 1, 2
        pos[b, :n1], pos[b, n1:n1 + n2] = np.arange(n1), np.arange(n2)
    return ids, seg, pos


@pytest.mark.parametrize("masks", ["none", "segments", "segments+positions"])
def test_cacheless_logits_match_jax(masks):
    jm = jax_tiny(21)
    tm = bridged(jm)
    ids, seg, pos = _packed_batch(np.random.RandomState(1), jm.cfg.vocab_size)
    kw = {}
    if masks != "none":
        kw["attention_mask"] = seg
    if masks == "segments+positions":
        kw["position_ids"] = pos
    ref = _np(jm(pt.to_tensor(ids),
                 **{k: pt.to_tensor(v) for k, v in kw.items()}))
    with torch.no_grad():
        ours = tm(torch.from_numpy(ids),
                  **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert ours.shape == (2, 16, jm.cfg.vocab_size)
    np.testing.assert_allclose(ours.numpy(), ref, **FWD_TOL)


@pytest.mark.parametrize("route", ["logits_ce", "fused_ce"])
def test_loss_and_every_gradient_match_jax(route):
    """Untied tiny Llama: cross entropy over the logits. Tied, vocab
    32768, hidden 64: the fused chunked CE, which returns no logits.
    Labels of -100 are ignored in both."""
    kw = dict(tie_word_embeddings=True, vocab_size=32768) \
        if route == "fused_ce" else {}
    jm = jax_tiny(22, **kw)
    jm.train()
    tm = bridged(jm)
    rng = np.random.RandomState(2)
    ids, seg, _ = _packed_batch(rng, jm.cfg.vocab_size)
    labels = ids.copy()
    labels[0, 3:7] = -100
    jl, jg = _jax_grads(jm, ids, labels=labels, attention_mask=seg)
    out, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert (out is None) is (route == "fused_ce")
    tl_, tg = _port_grads(tm, ids, labels=labels, attention_mask=seg)
    np.testing.assert_allclose(tl_, jl, rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], err_msg=n, **GRAD_TOL)


def test_ignored_labels_give_zero_loss_and_zero_gradient():
    rng = np.random.RandomState(3)
    h = torch.from_numpy(rng.randn(6, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
    h.requires_grad_()
    w.requires_grad_()
    labels = torch.tensor([3, -100, 31, -100, 0, 17])
    loss = matmul_cross_entropy(h, w, labels, n_chunks=4)
    ref = torch.nn.functional.cross_entropy(h @ w.t(), labels,
                                            reduction="none")
    np.testing.assert_allclose(loss.detach().numpy(),
                               ref.detach().numpy(), rtol=1e-5, atol=1e-6)
    assert loss[1] == 0 and loss[3] == 0
    loss.sum().backward()
    assert torch.all(h.grad[[1, 3]] == 0)
    # every label ignored: zero loss and zero gradient everywhere
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(
        tie_word_embeddings=True, vocab_size=32768, num_hidden_layers=1),
        device="cpu")
    ids = torch.from_numpy(rng.randint(0, 32768, (1, 8)))
    _, loss = tm(ids, labels=torch.full((1, 8), -100))
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert all(torch.all(p.grad == 0) for p in tm.parameters())
    with pytest.raises(ValueError, match="length >= 2"):
        tm(ids[:, :1], labels=ids[:, :1])


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.RandomState(4)
    logits = rng.randn(10, 7).astype(np.float32)
    labels = rng.randint(0, 7, 10).astype(np.int32)
    labels[[2, 5]] = -100
    ref = _np(JF.cross_entropy(pt.to_tensor(logits), pt.to_tensor(labels),
                               reduction=reduction))
    ours = F.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), reduction=reduction)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="hard labels"):
        F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        label_smoothing=0.1)


@pytest.mark.parametrize("mask", ["bool", "float"])
def test_sdpa_with_a_mask_matches_jax(mask):
    rng = np.random.RandomState(5)
    q = rng.randn(2, 16, 4, 16).astype(np.float32)
    kv = rng.randn(2, 16, 2, 16).astype(np.float32)
    if mask == "bool":
        m = rng.rand(2, 1, 16, 16) > 0.3
        m[..., 0] = True
    else:
        m = rng.randn(2, 4, 16, 16).astype(np.float32)
    ref = _np(JF.scaled_dot_product_attention(
        pt.to_tensor(q), pt.to_tensor(kv), pt.to_tensor(kv),
        attn_mask=pt.to_tensor(m)))
    ours = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
        attn_mask=torch.from_numpy(m))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=2e-4, atol=2e-5)
    trainable = torch.zeros(16, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="trainable"):
        F.scaled_dot_product_attention(torch.from_numpy(q),
                                       torch.from_numpy(kv),
                                       torch.from_numpy(kv),
                                       attn_mask=trainable)


def test_three_train_steps_match_jax():
    """AdamW (lr 1e-4, decay 0.01) with a global-norm clip of 1.0 through
    TrainStep in both packages. Tolerances: the loss at rtol 1e-5 and
    parameters and moments at rtol 1e-4, atol 1e-6 (f32 sums in other
    orders, through 3 updates whose Adam step divides by sqrt(v))."""
    jm = jax_tiny(23)
    jm.train()
    tm = bridged(jm)
    ids = np.random.RandomState(6).randint(
        0, jm.cfg.vocab_size, (2, 16)).astype(np.int32)

    def jloss(m, x):
        return m(x, labels=x)[1]
    jopt = pt.optimizer.AdamW(learning_rate=1e-4,
                              parameters=jm.parameters(),
                              grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    jstep = pt.jit.TrainStep(jm, jloss, jopt)
    topt = AdamW(learning_rate=1e-4, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, jloss, topt)
    for _ in range(3):
        jl = float(_np(jstep(pt.to_tensor(ids))))
        ours = tstep(torch.from_numpy(ids))
        assert ours.shape == () and not ours.requires_grad
        np.testing.assert_allclose(float(ours), jl, rtol=1e-5)
    assert tstep.last_grad_norm is not None
    jstate = state_dict_from_jax(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jstate[n],
                                   err_msg=n, **GRAD_TOL)
    jsd = {k: (v if isinstance(v, int) else _np(v))
           for k, v in jopt.state_dict().items()}
    tsd = optimizer_state_to_numpy(topt)
    assert sorted(tsd) == sorted(jsd) and tsd["@step_count"] == 3
    for key in jsd:
        if key != "@step_count":
            np.testing.assert_allclose(tsd[key], jsd[key], err_msg=key,
                                       **GRAD_TOL)


def test_eager_adam_groups_and_decay_match_jax():
    """Eager ``step()`` of Adam with an L2 decay and AdamW with
    per-group lr, ``apply_decay_param_fun`` and ``lr_ratio``, two steps
    on the same gradients in both packages."""
    rng = np.random.RandomState(7)
    w0 = [rng.randn(5, 3).astype(np.float32), rng.randn(4).astype(
        np.float32)]
    grads = [[rng.randn(*w.shape).astype(np.float32) for w in w0]
             for _ in range(2)]

    def run(jax_side, make):
        if jax_side:
            ps = [pt.Parameter(jnp.asarray(w)) for w in w0]
        else:
            ps = [torch.nn.Parameter(torch.from_numpy(w.copy()))
                  for w in w0]
        opt = make(ps, pt.optimizer if jax_side else None)
        for gs in grads:
            for p, g in zip(ps, gs):
                p.grad = pt.to_tensor(g) if jax_side else torch.from_numpy(g)
            opt.step()
        return [_np(p) if jax_side else p.detach().numpy() for p in ps]

    def adam(ps, mod):
        cls = mod.Adam if mod else Adam
        return cls(learning_rate=0.01, parameters=ps, weight_decay=0.1)

    def adamw(ps, mod):
        cls = mod.AdamW if mod else AdamW
        return cls(learning_rate=0.01,
                   parameters=[{"params": ps[:1], "learning_rate": 0.5},
                               {"params": ps[1:]}],
                   weight_decay=0.2, lr_ratio=lambda p: 0.7,
                   apply_decay_param_fun=lambda name: False)

    for make in (adam, adamw):
        for a, b in zip(run(False, make), run(True, make)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_master_weights_state_round_trip_and_refusals():
    """multi_precision keeps f32 masters of bf16 parameters, the bf16
    parameter is the master rounded, and the state survives a numpy
    round trip. A scheduler and ``fused=True`` are accepted; options not
    ported raise."""
    torch.manual_seed(0)
    p = torch.nn.Parameter(torch.randn(8, 4).to(torch.bfloat16))
    opt = AdamW(learning_rate=1e-2, parameters=[p], multi_precision=True)
    for _ in range(2):
        p.grad = torch.randn(8, 4).to(torch.bfloat16)
        opt.step()
    master = opt.state_dict()["param_0.master_weight"]
    assert master.dtype == torch.float32
    assert opt.state_dict()["param_0.moment1"].dtype == torch.float32
    assert torch.equal(p.detach(), master.to(torch.bfloat16))
    state = optimizer_state_to_numpy(opt)
    opt2 = AdamW(learning_rate=1e-2, parameters=[p], multi_precision=True)
    load_optimizer_state(opt2, state)
    for k, v in optimizer_state_to_numpy(opt2).items():
        assert np.array_equal(v, state[k]), k
    opt.clear_grad()
    assert torch.all(p.grad == 0)
    opt.clear_grad(set_to_zero=False)
    assert p.grad is None
    opt.set_lr(0.5)
    assert opt.get_lr() == 0.5
    # a scheduler is accepted, as the optimizer's lr and by set_lr_scheduler
    sched = StepDecay(0.1, step_size=1, gamma=0.5)
    opt.set_lr_scheduler(sched)
    assert opt.get_lr() == 0.1
    assert AdamW(learning_rate=sched, parameters=[p]).get_lr() == 0.1
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu")
    # fused=True builds (the fused update is the default)
    assert TrainStep(tm, lambda m, x: m(x), opt, fused=True)._fused
    for kw in ({"mesh": object()}, {"bucketed": True}, {"donate": False}):
        with pytest.raises(NotImplementedError, match="not ported"):
            TrainStep(tm, lambda m, x: m(x), opt, **kw)
    with pytest.raises(NotImplementedError, match="recompute"):
        tl.LlamaForCausalLM(tl.LlamaConfig.tiny(recompute=True),
                            device="cpu")


def test_train_step_trains_only_the_optimizer_parameters():
    tm = tl.LlamaForCausalLM(tl.LlamaConfig.tiny(), device="cpu", seed=3)
    frozen = tm.model.embed_tokens.weight
    before = frozen.detach().clone()
    others = [p for p in tm.parameters() if p is not frozen]
    step = TrainStep(tm, lambda m, x: m(x, labels=x)[1],
                     AdamW(learning_rate=1e-3, parameters=others))
    ids = torch.from_numpy(np.random.RandomState(8).randint(0, 256, (2, 8)))
    losses = [float(step(ids)) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert torch.equal(frozen.detach(), before) and frozen.grad is None


@pytest.mark.parametrize("form", ["offset", "positions"])
def test_rotary_matches_jax(form):
    from paddle_tpu.models import llama as jl
    rng = np.random.RandomState(9)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    if form == "offset":
        ref = jl.apply_rotary(pt.to_tensor(q), pt.to_tensor(k), 10000.0,
                              pos_offset=5, table_len=64)
        ours = tl.apply_rotary(torch.from_numpy(q), torch.from_numpy(k),
                               10000.0, pos_offset=5, table_len=64)
    else:
        pos = rng.randint(0, 80, (2, 12)).astype(np.int32)  # some past 64
        ref = jl.apply_rotary_positions(pt.to_tensor(q), pt.to_tensor(k),
                                        pt.to_tensor(pos), 10000.0,
                                        table_len=64)
        ours = tl.apply_rotary_positions(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(pos), 10000.0,
                                         table_len=64)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-6, atol=1e-6)


def test_global_norm_clip_leaves_the_given_gradients():
    """The clipped gradients are new tensors scaled by clip / max(norm,
    clip); the norm is taken in f32 over every gradient."""
    ps = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(
        torch.zeros(2, 2))]
    gs = [torch.tensor([3.0, 0.0, 4.0]), torch.full((2, 2), 6.0)]
    out, norm = ClipGradByGlobalNorm(1.0)._clip_with_norm(list(zip(ps, gs)))
    assert float(norm) == pytest.approx(13.0)
    assert torch.allclose(out[0][1], gs[0] / 13.0)
    assert torch.equal(gs[0], torch.tensor([3.0, 0.0, 4.0]))
    out, _ = ClipGradByGlobalNorm(100.0)._clip_with_norm(list(zip(ps, gs)))
    assert torch.equal(out[1][1], gs[1])


def test_flops_per_token_equals_the_reference():
    for cfg in (tl.LlamaConfig.tiny(), tl.LlamaConfig.llama3_8b(),
                tl.LlamaConfig(vocab_size=128256, hidden_size=2048,
                               intermediate_size=7168, num_hidden_layers=8,
                               num_attention_heads=16,
                               num_key_value_heads=4,
                               tie_word_embeddings=True)):
        jcfg = type(jax_tiny(0).cfg)(**{
            f: getattr(cfg, f) for f in tl.LlamaConfig.__dataclass_fields__})
        assert tl.LlamaForCausalLM.flops_per_token(cfg) == \
            JaxLM.flops_per_token(jcfg)
