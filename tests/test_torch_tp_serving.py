"""The port's tensor-parallel serving against ``paddle_tpu``'s, on the CPU.

Two gloo ranks of ``tests/torch_ep_worker.py`` (suite ``tps``, started
once for the file) serve through ``ServingEngine(mesh=)`` on
``{"mp": 2}``: rank 0 drives (schedules, samples, runs the loop) and
rank 1 follows each step it broadcasts. The oracle is the reference's
own (``tests/test_prefix_cache.py:258-289``): its engine on
``init_mesh({"mp": 2})`` over 2 of the conftest's virtual devices, with
the same weights, whose greedy streams equal its eager decoding. The
port's streams must equal both, token for token: the tiny
tensor-parallel Llama with plain weights and with ``int8_wo``, the same
Llama built without ``tensor_parallel`` (served whole on every rank),
the tiny tensor-parallel MoE, one request through ``Server`` on the
driver, and one request after the driver idled past the group's
collective timeout. Every rank's allocator ends without a leak.
"""
import pytest

from paddle_tpu.models import moe as jmoe
from paddle_tpu.models.llama import LlamaConfig as JaxCfg
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLM
from paddle_tpu.serving import ServingEngine as JaxEngine

import torch_dist_worker as W
import torch_ep_worker as EW
from test_torch_bridge import one_torch_thread  # noqa: F401
from test_torch_bridge import undrawn_jax_init
from test_torch_distributed import jax_mesh


@pytest.fixture(scope="module")
def ranks():
    world = W.Ranks("tps", 2, script=EW.__file__)
    yield world
    world.close()


def port(ranks, case, rank=0):
    return ranks.results()[rank][case]


def _jax_streams(model, mesh, **kw):
    eng = JaxEngine(model, mesh=mesh, **dict(EW.SERVE_KW, **kw))
    handles = [eng.submit(p, max_new_tokens=EW.SERVE_NEW)
               for p in EW.serve_prompts()]
    eng.run_until_idle()
    assert eng.stats()["tensor_parallel"] == 2
    return [h.result(60)["token_ids"] for h in handles]


def _jax_llama(tensor_parallel):
    with undrawn_jax_init():
        m = JaxLM(JaxCfg(**dict(EW.SERVE_LLAMA,
                                tensor_parallel=tensor_parallel)))
    m.set_state_dict(EW.llama_serve_state())
    m.eval()
    return m


def _eager_streams():
    """Eager decoding of the same Llama on one device (the port's
    ``generate``, whose greedy tokens equal the reference's,
    ``tests/test_torch_generate.py``)."""
    import torch
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.utils.bridge import load_numpy_state
    model = LlamaForCausalLM(LlamaConfig(**EW.SERVE_LLAMA), device="cpu")
    load_numpy_state(model, EW.llama_serve_state())
    model.eval()
    out = []
    with torch.no_grad():
        for p in EW.serve_prompts():
            ids = model.generate(torch.tensor([p]),
                                 max_new_tokens=EW.SERVE_NEW,
                                 temperature=0.0)
            out.append([int(t) for t in ids[0, len(p):]])
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference engine's streams on its mp mesh, and eager decoding
    on one device."""
    mesh = jax_mesh({"mp": 2})
    tp = _jax_llama(True)
    out = {"plain": _jax_streams(tp, mesh),
           "int8_wo": _jax_streams(_jax_llama(True), mesh,
                                   quantize="int8_wo")}
    with undrawn_jax_init():
        moe = jmoe.MoeForCausalLM(jmoe.MoeConfig(**dict(
            EW.SERVE_MOE, tensor_parallel=True)))
    moe.set_state_dict(EW.moe_state(EW.SERVE_MOE, seed=2))
    moe.eval()
    out["moe"] = _jax_streams(moe, mesh)
    out["eager"] = _eager_streams()
    return out


@pytest.mark.parametrize("case", ["plain", "int8_wo", "whole"])
def test_llama_streams_equal_the_reference(ranks, reference, case):
    """The driver's greedy streams equal the reference engine's on its mp
    mesh (and, with plain weights, its eager decoding), with the prefix
    cache taking part; the follower ran every one of the driver's
    steps."""
    want = reference["int8_wo" if case == "int8_wo" else "plain"]
    if case != "int8_wo":
        assert reference["plain"] == reference["eager"]
    got = port(ranks, "tp_serve")[case]
    assert got["driver"] and got["streams"] == want
    assert got["prefix_hits"] >= 1
    follower = port(ranks, "tp_serve", 1)[case]
    assert not follower["driver"] and follower["streams"] == []
    assert follower["steps"] == got["steps"]


def test_moe_tensor_parallel_streams_equal_the_reference(ranks, reference):
    """``MoeConfig(tensor_parallel=True)`` served at mp 2."""
    got = port(ranks, "tp_moe_serve")
    assert got["streams"] == reference["moe"]
    assert port(ranks, "tp_moe_serve", 1)["steps"] == got["steps"]


def test_one_request_through_the_server(ranks, reference):
    """``Server`` on the driver (``start()``/``close()``), the follower in
    ``start()``/``shutdown()``: the response's tokens are the stream."""
    got = port(ranks, "tp_server")
    assert got["token_ids"] == reference["plain"][0]
    assert port(ranks, "tp_server", 1)["steps"] == got["steps"] > 0


def test_idle_driver_keeps_its_followers(ranks, reference):
    """With the ``mp`` group's collective timeout cut to 2 s, the driver
    idles 6 s in its run loop, then serves one request: its keep-alive
    words (every half second, a quarter of the timeout) keep the
    follower's wait alive, and the follower runs every step."""
    got = port(ranks, "tp_idle")
    assert got["keepalive_s"] == 0.5
    assert got["token_ids"] == reference["plain"][0]
    assert port(ranks, "tp_idle", 1)["steps"] == got["steps"] > 0


def test_heads_split_and_refusals(ranks):
    """``stats()["tensor_parallel"]`` is 2 and each rank's pools hold one
    of the two KV heads; a model built without ``tensor_parallel`` warns
    and keeps both on every rank; ``submit`` on a follower raises; ``mp``
    must divide the KV heads, as in the reference; LoRA slots and the KV
    handoff are not ported under a mesh and raise."""
    for r in range(2):
        d = port(ranks, "tp_serve", r)
        assert d["plain"]["tensor_parallel"] == 2
        assert d["plain"]["pool_heads"] == 1 and d["whole"]["pool_heads"] == 2
        assert any("stay whole" in w for w in d["whole_warning"])
        assert "must divide" in d["n_kv_check"]
        assert "not ported" in d["lora"] and "not ported" in d["handoff"]
    assert "follower" in port(ranks, "tp_serve", 1)["follower_submit"]


def test_serving_mp_environment_is_not_read(monkeypatch):
    """The reference's ``PADDLE_TPU_SERVING_MP`` builds a mesh from the
    environment; the port's mesh is an argument only."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    monkeypatch.setenv("PADDLE_TPU_SERVING_MP", "2")
    model = LlamaForCausalLM(LlamaConfig(**EW.SERVE_LLAMA), device="cpu")
    eng = ServingEngine(model, device="cpu", **EW.SERVE_KW)
    assert eng.stats()["tensor_parallel"] == 1 and eng.is_driver
    assert eng.mesh is None
