"""LoRA on the port against ``paddle_tpu`` (``tests/test_lora.py``'s
cases): three ``TrainStep`` steps of the adapters over a frozen base give
the reference's losses and adapter gradients at rtol 1e-5; a trained
adapter served from a slot gives the JAX engine's streams; eight tenants
on one ``int8_wo`` engine give the JAX engine's streams; and the slot
hygiene holds, including the prefix-cache seed: KV computed under one
adapter, or under an earlier load of a slot, never answers a request of
another. Weights cross through the bridge; LoRA leaves keep the
reference's names (``...q_proj.lora_A``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import tuning as jtuning
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch import tuning
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.utils.bridge import load_numpy_state

from test_torch_bridge import (jax_tiny, jax_value_and_grads,  # noqa: F401
                               one_torch_thread, state_dict_from_jax)

LORA = dict(rank=4, alpha=8.0)
KW = dict(max_batch=4, max_blocks=32, block_size=4, prefill_chunk=4)
# f32 on both sides. An adapter gradient entry near zero is the end of a
# sum of larger terms taken in another order, so each tensor's absolute
# limit is 1e-4 of its largest entry (the readings here reach 5.1e-5 of
# it); everything else is held at rtol 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-4


def _tiny(seed):
    """The reference test's widths (vocab 128, hidden 64, 2 layers, 4/2
    heads), with an untied head: the tied tiny model's greedy streams
    repeat one token whatever the adapter."""
    return jax_tiny(seed, vocab_size=128)


def _port_twin(jm, n_slots=0):
    """The port's twin of a JAX Llama that ``apply_lora`` prepared with
    ``n_slots``: the same adapters, every weight through the bridge."""
    cfg = tl.LlamaConfig(**{f: getattr(jm.cfg, f) for f in
                            tl.LlamaConfig.__dataclass_fields__})
    tm = tl.LlamaForCausalLM(cfg, device="cpu")
    tm.eval()
    tuning.apply_lora(tm, tuning.LoRAConfig(**LORA), n_slots=n_slots)
    load_numpy_state(tm, state_dict_from_jax(jm))
    return tm


def _streams(engine, jobs, n):
    """Greedy streams of ``(prompt, adapter_id)`` jobs, all submitted at
    once."""
    handles = [engine.submit(list(p), max_new_tokens=n, adapter_id=a)
               for p, a in jobs]
    engine.run_until_idle()
    out = [h.result(30)["token_ids"] for h in handles]
    engine.cache.allocator.assert_no_leaks()
    return out


def _loss(m, x):
    return m(x, labels=x)[1]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three TrainStep steps of Adam over the adapters in both packages,
    from the same weights; the JAX adapter is saved for the serving
    case."""
    jm = _tiny(0)
    jtuning.apply_lora(jm, jtuning.LoRAConfig(**LORA))
    jm.train()
    tm = _port_twin(jm)
    tm.train()
    base = {n: p.detach().clone() for n, p in tm.named_parameters()
            if "lora_" not in n}
    ids = np.random.RandomState(0).randint(1, 128, (4, 16)).astype(np.int32)
    grads = [(jax_value_and_grads(jm, lambda m, x: (_loss(m, x), None),
                                  ids), _port_grads(tm, ids))]
    jstep = pt.jit.TrainStep(jm, _loss, pt.optimizer.Adam(
        learning_rate=2e-2, parameters=jm.parameters()))
    tstep = TrainStep(tm, _loss, Adam(learning_rate=2e-2,
                                      parameters=tm.parameters()))
    losses = [(float(np.asarray(jstep(pt.to_tensor(ids)).data)),
               float(tstep(torch.from_numpy(ids)))) for _ in range(3)]
    grads.append((jax_value_and_grads(jm, lambda m, x: (_loss(m, x), None),
                                      ids), _port_grads(tm, ids)))
    path = str(tmp_path_factory.mktemp("adapter") / "tenant-a")
    jtuning.save_adapter(jm, path)
    return dict(jm=jm, tm=tm, base=base, grads=grads, losses=losses,
                path=path)


def _port_grads(tm, ids):
    tm.zero_grad(set_to_none=True)
    loss = _loss(tm, torch.from_numpy(ids))
    loss.backward()
    out = {n: p.grad.clone() for n, p in tm.named_parameters()
           if p.grad is not None}
    tm.zero_grad(set_to_none=True)
    return float(loss.detach()), out


def test_adapter_training_matches_jax(trained):
    """Only the adapters train (2 x 2 layers x 7 targets), a sliver of
    the model; the losses of three steps and the adapter gradients before
    and after them equal the reference's at rtol 1e-5; the frozen base
    is bit for bit unchanged."""
    tm = trained["tm"]
    lora = tuning.lora_state_dict(tm)
    assert len(lora) == 2 * 2 * 7
    assert [p for p in tm.parameters() if p.requires_grad] == \
        [p for n, p in tm.named_parameters() if "lora_" in n]
    total = sum(p.numel() * 4 for p in tm.parameters())
    assert tuning.lora_param_bytes(tm) < 0.1 * total
    for (jl, _, jg, _), (tl_, tg) in trained["grads"]:
        np.testing.assert_allclose(tl_, float(jl), rtol=1e-5)
        assert sorted(tg) == sorted(jg)
        for n, g in tg.items():
            np.testing.assert_allclose(
                g.numpy(), jg[n], err_msg=n, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_OF_MAX * float(np.abs(jg[n]).max()))
    for jl, tl_ in trained["losses"]:
        np.testing.assert_allclose(tl_, jl, rtol=1e-5)
    assert trained["losses"][-1][1] < trained["losses"][0][1]
    for n, p in tm.named_parameters():
        if "lora_" not in n:
            assert torch.equal(p, trained["base"][n]), n
    assert any(float(v.abs().max()) > 0 for k, v in lora.items()
               if k.endswith("lora_B"))


def test_trained_adapter_serves_from_a_slot(trained, tmp_path):
    """The reference's saved adapter, read by the port
    (``load_adapter_state``) into slot 1 of an engine over the same base:
    slot 1's and slot 0's streams equal the JAX engine's with the same
    adapter in its slot 1; the port's ``save_adapter`` round-trips bit
    for bit, and its 2-D leaves land in a stack row through the bridge."""
    jbase = _tiny(0)
    jtuning.apply_lora(jbase, jtuning.LoRAConfig(**LORA), n_slots=2)
    tm = _port_twin(jbase, n_slots=2)
    jeng = JaxEngine(jbase, **KW)
    jeng.load_adapter(1, jtuning.load_adapter_state(trained["path"]),
                      name="tenant-a")
    eng = ServingEngine(tm, device="cpu", **KW)
    state = tuning.load_adapter_state(trained["path"], device="cpu")
    assert sorted(state) == sorted(tuning.lora_state_dict(trained["tm"]))
    eng.load_adapter(1, state, name="tenant-a")
    prompt = list(np.random.RandomState(1).randint(1, 128, 10))
    jobs = [(prompt, 0), (prompt, 1)]
    ref = _streams(jeng, jobs, 6)
    got = _streams(eng, jobs, 6)
    assert got == ref and got[0] != got[1]
    st = eng.stats()
    assert st["adapter_slots"] == 2 and st["adapters"]["loaded"] == 1
    assert st["adapters"]["occupancy"] == {"1": "tenant-a"}
    # the port's own adapter checkpoint, and the bridge's slot form
    path = tuning.save_adapter(trained["tm"], str(tmp_path / "port"))
    back = tuning.load_adapter_state(path, device="cpu")
    for k, v in tuning.lora_state_dict(trained["tm"]).items():
        assert torch.equal(back[k], v), k
    twin = _port_twin(jbase, n_slots=2)
    load_numpy_state(twin, dict(state_dict_from_jax(jbase), **{
        k: v.numpy() for k, v in state.items()}), adapter_slot=2)
    for k, v in state.items():
        stack = dict(twin.named_parameters())[k]
        assert torch.equal(stack[2], v) and not bool(stack[1].any())


def _tenant(stacks, seed, scale=0.5):
    """A synthetic tenant: random rows for every LoRA stack."""
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape[1:]) * scale).astype(np.float32)
            for k, v in stacks.items()}


def test_eight_tenants_on_one_quantized_engine():
    """Eight adapters at once on one ``int8_wo`` engine: every tenant's
    stream equals the JAX engine's with the same adapters and
    quantization, and the tenants are distinct programs."""
    n = 8
    rng = np.random.RandomState(3)
    jobs = [(list(rng.randint(1, 128, 8 + s % 3)), s)
            for s in range(1, n + 1)]
    jm = _tiny(9)
    jtuning.apply_lora(jm, jtuning.LoRAConfig(**LORA), n_slots=n)
    tm = _port_twin(jm, n_slots=n)
    jeng = JaxEngine(jm, quantize="int8_wo", **KW)
    eng = ServingEngine(tm, device="cpu", quantize="int8_wo", **KW)
    stacks = {k: v for k, v in tm.named_parameters() if "lora_" in k}
    for s in range(1, n + 1):
        tenant = _tenant(stacks, 100 + s)
        jeng.load_adapter(s, tenant, name=f"tenant-{s}")
        eng.load_adapter(s, tenant, name=f"tenant-{s}")
    assert eng.stats()["adapters"]["loaded"] == n
    got = _streams(eng, jobs, 6)
    assert got == _streams(jeng, jobs, 6)
    assert len({tuple(t) for t in got}) > 1


def test_adapter_slot_hygiene_and_the_prefix_cache_seed():
    """Submitting to an empty or out-of-range slot, a load with an
    unknown leaf or a wrong shape, and a reload under a request in flight
    all refuse. With the prefix cache on, the same prompt under the base,
    under tenant A in slot 1 and then under tenant B loaded into the same
    slot gives, each time, the JAX engine's stream for that adapter: the
    blocks cached under one never answer another (the chain is seeded by
    slot and load generation). Unloading restores the base stream."""
    jm = _tiny(11)
    jtuning.apply_lora(jm, jtuning.LoRAConfig(**LORA), n_slots=2)
    tm = _port_twin(jm, n_slots=2)
    eng = ServingEngine(tm, device="cpu", **KW)
    jeng = JaxEngine(jm, **KW)
    stacks = {k: v for k, v in tm.named_parameters() if "lora_" in k}
    prompt = [2, 4, 6, 8, 10, 12, 14, 16, 18]  # two full blocks
    base = _streams(eng, [(prompt, 0)], 4)
    assert base == _streams(jeng, [(prompt, 0)], 4)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(prompt, adapter_id=1)
    with pytest.raises(ValueError, match="out of range"):
        eng.submit(prompt, adapter_id=9)
    with pytest.raises(KeyError):
        eng.load_adapter(1, {"nonsense.lora_A": np.zeros((4, 4))})
    key = next(iter(stacks))
    with pytest.raises(ValueError, match="shape"):
        eng.load_adapter(1, {key: np.zeros((3, 3), np.float32)})
    for tenant_seed in (5, 6):  # tenant A, then tenant B in the same slot
        tenant = _tenant(stacks, tenant_seed)
        eng.load_adapter(1, tenant, name=f"t{tenant_seed}")
        jeng.load_adapter(1, tenant, name=f"t{tenant_seed}")
        hits = eng.stats()["prefix_cache"]["hits"]
        got = _streams(eng, [(prompt, 1)], 4)
        assert got == _streams(jeng, [(prompt, 1)], 4) and got != base
        assert eng.stats()["prefix_cache"]["hits"] == hits
    h = eng.submit(prompt, max_new_tokens=2, adapter_id=1)
    with pytest.raises(RuntimeError, match="in flight"):
        eng.load_adapter(1, tenant)
    eng.run_until_idle()
    h.result(30)
    eng.unload_adapter(1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(prompt, adapter_id=1)
    assert not any(bool(p[1].any()) for p in stacks.values())
    assert _streams(eng, [(prompt, 0)], 4) == base
