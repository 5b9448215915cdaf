"""Package-level contract of the PyTorch/CUDA port (``paddle_tpu_torch``):
it imports neither JAX nor the JAX package, its entry points default to
the CUDA card and raise where there is none, the engine refuses the JAX
engine's options it has not ported, and no library attention kernel or
compiler stands in for its own kernels."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "paddle_tpu_torch"


def _forbidden(mod: str) -> bool:
    # exact module match: paddle_tpu_torch itself starts with "paddle_tpu"
    return any(mod == m or mod.startswith(m + ".")
               for m in ("jax", "jaxlib", "paddle_tpu"))


def _port_modules():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 15
    return files


def test_no_module_imports_jax_or_the_jax_package():
    """Neither the port's modules nor ``chip_smoke.py``, which drives the
    port on the card, import JAX or the JAX package."""
    bad = []
    for path in _port_modules() + [REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if _forbidden(node.module or ""):
                    bad.append((path.name, node.module))
    assert bad == []


def test_import_in_a_fresh_process_loads_no_jax():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.serving.engine, "
        "paddle_tpu_torch.serving.server, paddle_tpu_torch.models.llama, "
        "paddle_tpu_torch.utils.bridge, "
        "paddle_tpu_torch.ops.pallas.ragged_paged_attention, "
        "paddle_tpu_torch.ops.pallas.flash_attention, "
        "paddle_tpu_torch.ops.pallas.grouped_matmul, "
        "paddle_tpu_torch.distributed.fleet.moe, "
        "paddle_tpu_torch.models.moe, "
        "paddle_tpu_torch.ops.fused_ce, paddle_tpu_torch.jit, "
        "paddle_tpu_torch.optimizer, paddle_tpu_torch.nn.clip, "
        "paddle_tpu_torch.io, paddle_tpu_torch.data, "
        "paddle_tpu_torch.checkpoint, paddle_tpu_torch.framework, "
        "paddle_tpu_torch.hapi, paddle_tpu_torch.resilience, "
        "paddle_tpu_torch.observability, paddle_tpu_torch.metric, "
        "paddle_tpu_torch.nn.initializer, paddle_tpu_torch.nn.containers, "
        "paddle_tpu_torch.nn.layer.transformer, "
        "paddle_tpu_torch.nn.layer.conv, paddle_tpu_torch.core.generator, "
        "paddle_tpu_torch.models.ernie, paddle_tpu_torch.models.dit, "
        "paddle_tpu_torch.models.ppocr, paddle_tpu_torch.vision, "
        "paddle_tpu_torch.vision.models, paddle_tpu_torch.vision.transforms, "
        "paddle_tpu_torch.vision.datasets, "
        "paddle_tpu_torch.nn.layer.pooling, paddle_tpu_torch.nn.layer.rnn, "
        "paddle_tpu_torch.nn.layer.norm, paddle_tpu_torch.core.tensor, "
        "paddle_tpu_torch.core.autograd, paddle_tpu_torch.core.flags, "
        "paddle_tpu_torch.core.enforce, paddle_tpu_torch.core.dtype, "
        "paddle_tpu_torch.autograd, paddle_tpu_torch.autograd.py_layer, "
        "paddle_tpu_torch.ops, paddle_tpu_torch.ops.math, "
        "paddle_tpu_torch.ops.creation, paddle_tpu_torch.ops.reduction, "
        "paddle_tpu_torch.ops.manipulation, paddle_tpu_torch.ops.linalg, "
        "paddle_tpu_torch.ops.array, paddle_tpu_torch.ops.extras, "
        "paddle_tpu_torch.nn.layer_base, paddle_tpu_torch.linalg, "
        "paddle_tpu_torch.batch, paddle_tpu_torch.callbacks, "
        "paddle_tpu_torch.device.cuda, paddle_tpu_torch.models.generation, "
        "paddle_tpu_torch.jit.api, paddle_tpu_torch.jit.functional, "
        "paddle_tpu_torch.jit.cuda_graph, paddle_tpu_torch.amp, "
        "paddle_tpu_torch.ops.pallas.counters, "
        "paddle_tpu_torch.amp.auto_cast, paddle_tpu_torch.amp.grad_scaler, "
        "paddle_tpu_torch.distributed.fleet.utils, "
        "paddle_tpu_torch.quantization, paddle_tpu_torch.quantization.int8, "
        "paddle_tpu_torch.quantization.weight_only, paddle_tpu_torch.tuning, "
        "paddle_tpu_torch.observability.numerics, "
        "paddle_tpu_torch.ops.pallas.autotune, paddle_tpu_torch.incubate, "
        "paddle_tpu_torch.incubate.nn, paddle_tpu_torch.incubate.optimizer, "
        "paddle_tpu_torch.incubate.checkpoint, "
        "paddle_tpu_torch.incubate.autograd, paddle_tpu_torch.incubate.asp, "
        "paddle_tpu_torch.jit.serialization, paddle_tpu_torch.static, "
        "paddle_tpu_torch.static.graph, paddle_tpu_torch.static.nn, "
        "paddle_tpu_torch.inference\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.distributed.fleet import MoELayer
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.models.moe import MoeConfig, MoeForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoeForCausalLM(MoeConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MoELayer(8, 16, 4)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, max_blocks=8, block_size=4, prefill_chunk=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(MoeForCausalLM(MoeConfig.tiny(), device="cpu"),
                      max_blocks=8, block_size=4, prefill_chunk=4)
    from paddle_tpu_torch.incubate import nn as inn
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inn.FusedMultiTransformer(8, 2, 16)
    assert resolve_device("cpu") == torch.device("cpu")
    # capture (compiled_generate's decode step, to_static's calls) runs
    # on the card: with no tensor to say otherwise it resolves to the
    # card, and asking for the CPU is refused, not run eagerly behind
    # the caller's back
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.jit.cuda_graph import CapturedGraph
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CapturedGraph(lambda: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_static(lambda: 1)()
    with pytest.raises(ValueError, match="card"):
        CapturedGraph(lambda: None, "cpu")
    # the CPU route of compiled_generate is the model's device, asked for
    out = model.generate_compiled(torch.ones(1, 3, dtype=torch.long),
                                  max_new_tokens=2)
    assert out.device.type == "cpu" and tuple(out.shape) == (1, 5)


def test_data_and_checkpoint_entry_points_default_to_cuda(tmp_path):
    """The fit slice's entry points that place tensors (the device
    prefetch, ``to_device``, checkpoint restore and ``framework.io.load``)
    resolve ``device=None`` to the card and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    import numpy as np
    from paddle_tpu_torch.checkpoint import CheckpointManager, load_state_dir
    from paddle_tpu_torch.data import DataPipeline, DevicePrefetcher, to_device
    from paddle_tpu_torch.framework import load, save
    docs = [np.arange(1, 9, dtype=np.int32)] * 4
    calls = [
        lambda: DataPipeline(docs, 2, seq_len=8, pack=True,
                             device_prefetch=2),
        lambda: DevicePrefetcher([docs[0]]),
        lambda: to_device({"x": docs[0]})]
    mgr = CheckpointManager(str(tmp_path / "ck"), async_=False)
    mgr.save(1, {"w": torch.ones(2)})
    save({"w": torch.ones(2)}, str(tmp_path / "w.pdparams"))
    calls += [mgr.restore, lambda: load_state_dir(str(tmp_path / "ck")),
              lambda: load(str(tmp_path / "w.pdparams")),
              lambda: load(str(tmp_path / "ck"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert DataPipeline(docs, 2, seq_len=8, pack=True, device_prefetch=2,
                        device="cpu").device == torch.device("cpu")


def test_layer_set_entry_points_default_to_cuda():
    """The layer set (norms and recurrent layers too), its initializers,
    the ERNIE, DiT and PP-OCR models and the vision zoo resolve
    ``device=None`` to the card and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.models import (DiT, DiTConfig, ErnieConfig,
                                         ErnieForPretraining, PPOCRRecConfig,
                                         PPOCRRecModel)
    from paddle_tpu_torch.vision import LeNet, resnet18
    calls = [
        lambda: nn.Linear(4, 4), lambda: nn.Embedding(8, 4),
        lambda: nn.LayerNorm(4), lambda: nn.Conv2D(2, 4, 3),
        lambda: nn.Conv2DTranspose(2, 4, 3), lambda: nn.PReLU(),
        lambda: nn.MultiHeadAttention(8, 2),
        lambda: nn.TransformerEncoderLayer(8, 2, 16),
        lambda: nn.Transformer(8, 2, 1, 1, 16),
        lambda: nn.Transformer.generate_square_subsequent_mask(4),
        lambda: nn.initializer.XavierUniform()([4, 4]),
        lambda: ErnieForPretraining(ErnieConfig.tiny()),
        lambda: DiT(DiTConfig.tiny()),
        lambda: nn.BatchNorm2D(4), lambda: nn.GroupNorm(2, 4),
        lambda: nn.InstanceNorm2D(4), lambda: nn.SpectralNorm([4, 4]),
        lambda: nn.LSTM(4, 4), lambda: nn.GRUCell(4, 4),
        lambda: PPOCRRecModel(PPOCRRecConfig.tiny()),
        lambda: resnet18(), lambda: LeNet()]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert nn.Linear(4, 4, device="cpu").weight.device.type == "cpu"


@pytest.mark.parametrize("kwarg", [
    {"quantize": "int8"}, {"kv_dtype": "int8"}, {"mesh": object()},
    {"warm_start_from": "/nonexistent"}, {"calibration": {}}])
def test_engine_refuses_unported_options(kwarg):
    """Every option of the reference engine is taken, and each refuses
    what it cannot serve: ``mesh=`` anything but a device mesh (the
    tensor-parallel engine itself is held against the reference in
    ``tests/test_torch_tp_serving.py``), a quantize mode outside
    ``WEIGHT_MODES``, a checkpoint that is not there. ``kv_dtype="int8"``
    pins the gather read path with the reference's warning, and an empty
    calibration gates nothing."""
    import warnings
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    kw = dict(max_blocks=8, block_size=4, prefill_chunk=4, device="cpu",
              **kwarg)
    if "mesh" in kwarg:
        with pytest.raises(TypeError, match="device mesh"):
            ServingEngine(model, **kw)
    elif "quantize" in kwarg:
        with pytest.raises(ValueError, match="int8_wo"):
            ServingEngine(model, **kw)
    elif "warm_start_from" in kwarg:
        with pytest.raises(FileNotFoundError):
            ServingEngine(model, **kw)
    elif "kv_dtype" in kwarg:
        with pytest.warns(RuntimeWarning, match="gather"):
            eng = ServingEngine(model, **kw)
        assert eng.attn_impl == "gather" and \
            eng.cache.k_pools[0].dtype == torch.int8
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            eng = ServingEngine(model, **kw)
        assert eng.quantize is None and eng._qleaves == {}


def test_engine_refuses_lora_slots_and_unknown_impls():
    """A model that claims LoRA slots without the adapter stacks of
    ``tuning.apply_lora(n_slots=)`` is refused, naming LoRA, as is an
    unknown read path."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model._lora_slots = 2
    with pytest.raises(ValueError, match="LoRA"):
        ServingEngine(model, max_blocks=8, block_size=4, prefill_chunk=4,
                      device="cpu")
    del model._lora_slots
    with pytest.raises(ValueError, match="attn_impl"):
        ServingEngine(model, max_blocks=8, block_size=4, prefill_chunk=4,
                      device="cpu", attn_impl="auto")


def test_no_library_attention_or_compiler_stands_in_for_a_kernel():
    """No port module reaches PyTorch's fused attention (the port's own
    ``nn.functional.scaled_dot_product_attention`` routes to the flash
    kernels), a compiler or a kernel library; and the CUDA paths of the
    kernel wrappers and of the recurrent layers hold no try/except that
    could fall back to a plain version."""
    banned = ("torch.nn.functional.scaled_dot_product_attention",
              "torch._C._nn", "_scaled_dot_product", "torch.compile",
              "flash_attn", "cudnn_attention", "torch.utils.cpp_extension",
              "_grouped_mm")
    hits = [(p.name, b) for p in _port_modules()
            for b in banned if b in p.read_text()]
    assert hits == []
    # the only sdpa call sites in the port are its own functional module's
    for path in _port_modules():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and \
                    (node.module or "").startswith("torch"):
                assert "scaled_dot_product_attention" not in \
                    [a.name for a in node.names], path.name
    from paddle_tpu_torch.jit import api, cuda_graph
    from paddle_tpu_torch.models import generation
    from paddle_tpu_torch.nn.layer import rnn
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    # the recurrent layers pick their route by device; no failure of the
    # fused recurrence sends a CUDA tensor to the step loop
    # nor does capture: a call on the card replays or captures, and a
    # capture that fails raises
    for mod, names in ((rnn, ("_fused_layer", "_scan_rnn", "_RNNBase")),
                       (cuda_graph, ("CapturedGraph",)),
                       (api, ("StaticFunction",)),
                       (generation, ("compiled_generate", "_Compiled")),
                       (rpa, ("ragged_paged_attention",)),
                       (fa, ("flash_attention_fwd", "flash_attention_dq",
                             "flash_attention_dkv", "_launch")),
                       (gm, ("_gmm_fwd", "_tgmm_fwd", "_gmm_aligned_fwd",
                             "_tgmm_aligned_fwd", "_launch", "gmm",
                             "gmm_aligned", "tgmm"))):
        src = Path(mod.__file__).read_text()
        for fn in ast.parse(src).body:
            if isinstance(fn, (ast.FunctionDef, ast.ClassDef)) and \
                    fn.name in names:
                assert not any(isinstance(n, ast.Try)
                               for n in ast.walk(fn)), fn.name


def test_kernel_wrapper_counts_launches_only():
    """On CPU tensors the wrapper computes the plain version and counts
    nothing; a device it has no kernel for raises."""
    import numpy as np
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    T, H, hd, bs = 8, 2, 64, 4
    q = torch.randn(T, H, hd)
    pool = torch.randn(3, bs, 1, hd)
    bt = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    cu = torch.tensor([0, 5, 5], dtype=torch.int32)
    ctx = torch.tensor([2, 0], dtype=torch.int32)
    ssq, sbk = rpa.build_step_maps(np.array([0, 5]), [7], total_tokens=T,
                                   tile_q=8, block_size=bs, max_steps=2,
                                   max_seqs=1)
    before = rpa.ragged_paged_attention.launches
    out = rpa.ragged_paged_attention(q, pool, pool, bt, cu, ctx,
                                     torch.from_numpy(ssq),
                                     torch.from_numpy(sbk))
    assert out.shape == q.shape and bool(torch.all(out[5:] == 0))
    assert rpa.ragged_paged_attention.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        rpa.ragged_paged_attention(q.to("meta"), pool, pool, bt, cu, ctx,
                                   torch.from_numpy(ssq),
                                   torch.from_numpy(sbk))

    # the grouped-matmul wrappers: CPU calls, forward and backward, count
    # nothing; a device with no kernel raises
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    names = ("launches_gmm", "launches_tgmm", "launches_gmm_aligned",
             "launches_tgmm_aligned")
    before = [getattr(gm, n) for n in names]
    lhs = torch.randn(16, 8, requires_grad=True)
    rhs = torch.randn(2, 8, 4, requires_grad=True)
    sizes = torch.tensor([8, 8], dtype=torch.int32)
    (gm.gmm(lhs, rhs, sizes, bm=8).sum()
     + gm.gmm_aligned(lhs, rhs, sizes, bm=8).sum()).backward()
    gm.tgmm(lhs.detach(), torch.randn(16, 4), sizes, 2, bm=8)
    assert [getattr(gm, n) for n in names] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        gm.gmm(lhs.to("meta"), rhs.to("meta"), sizes.to("meta"), bm=8)


def test_every_launch_counter_is_registered():
    """A launch counter is a module-level integer named ``launches...``
    or ``cudnn_calls`` (or one kept on a function, ``f.launches... =
    0``). Each must be in ``ops/pallas/counters``' registry: a CUDA-graph
    replay adds its captured counts only to registered counters, and an
    unregistered one would count once at capture and never again."""
    import importlib
    from paddle_tpu_torch.ops.pallas import counters
    found = set()
    for f in _port_modules():
        module = ".".join(f.relative_to(REPO).with_suffix("").parts)
        module = module.removesuffix(".__init__")
        for node in ast.parse(f.read_text()).body:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    path = t.id
                elif isinstance(t, ast.Attribute) and isinstance(
                        t.value, ast.Name):
                    path = f"{t.value.id}.{t.attr}"
                else:
                    continue
                last = path.rsplit(".", 1)[-1]
                if last.startswith("launches") or last == "cudnn_calls":
                    found.add((module, path))
                    importlib.import_module(module)
    # the counters of the K1-K8 wrappers, the fused update and the fused
    # recurrence, at least
    assert len(found) >= 13, sorted(found)
    assert found <= set(counters.registered()), \
        sorted(found - set(counters.registered()))


# the reference's top-level names whose subsystems the port has not
# ported yet: they stay unexported (ROADMAP §1)
UNPORTED_TOP_LEVEL = {
    "sparse", "text", "audio", "fft", "distribution",
    "geometric", "hub", "onnx", "reader", "sysconfig", "version", "signal",
}


def test_top_level_exports_what_the_reference_does():
    """``import paddle_tpu_torch as paddle`` exposes every name of the
    reference's top level (``paddle_tpu/__init__.py``) for the subsystems
    the port has: the dtypes, ``Tensor``/``to_tensor``, autograd, flags,
    every op, ``nn``, ``optimizer``, ``jit``, ``amp``, ``io``,
    ``save``/``load``,
    ``Model``, ``ParamAttr``, the device functions, ``linalg``, ``batch``,
    ``callbacks``, ``summary`` and ``flops``, ``static``, ``inference``
    and the static mode's switches. An unported subsystem raises
    ``AttributeError``."""
    import types

    import paddle_tpu as pt
    import paddle_tpu_torch as paddle

    # the names the reference's __init__.py binds, read from its source
    # (a package's attributes also grow with every submodule another
    # test imports)
    tree = ast.parse((REPO / "paddle_tpu" / "__init__.py").read_text())
    ref = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.names[0].name != "*":
            ref |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.Assign)):
            ref |= {node.name} if isinstance(node, ast.FunctionDef) else \
                {t.id for t in node.targets if isinstance(t, ast.Name)}
    # and what its star import of the op library binds, less what that
    # import carries along: jax/numpy handles, the op modules, renamed defs
    ref |= {n for n, v in vars(pt.ops).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)
            and not n.endswith("_") and n not in ("LONG", "builtins_sum")}
    ref -= {"annotations", "_mode"}
    missing = sorted(n for n in ref - UNPORTED_TOP_LEVEL
                     if not hasattr(paddle, n))
    assert missing == []
    for name in UNPORTED_TOP_LEVEL:
        assert not hasattr(paddle, name), name
    # amp, jit, static and inference: every name of the reference's
    for ref_mod, port_mod in ((pt.amp, paddle.amp), (pt.jit, paddle.jit),
                              (pt.static, paddle.static),
                              (pt.inference, paddle.inference)):
        assert set(ref_mod.__all__) <= set(dir(port_mod)), ref_mod
    assert set(pt.static.nn.__all__) <= set(dir(paddle.static.nn))
    assert paddle.static.InputSpec([None, 2]).shape == (-1, 2)
    assert paddle.in_dynamic_mode()
    paddle.enable_static()
    try:
        assert not paddle.in_dynamic_mode()
    finally:
        paddle.disable_static()
    assert paddle.in_dynamic_mode()
    assert paddle.Model is paddle.hapi.Model
    assert paddle.nn.Layer is paddle.nn.layer_base.Layer
    net = paddle.nn.Linear(4, 3, device="cpu")
    assert paddle.flops(net, [2, 4]) == 2 * 2 * 4 * 3
    assert paddle.summary(net)["total_params"] == 15


def test_layer_vision_and_dtype_leftovers_are_exported():
    """The names ported with the layer, vision and dtype leftovers stand
    where the reference exports them: ``nn.functional``'s whole list,
    every layer and loss of ``nn``, ``nn.clip_grad_norm_`` and
    ``nn.utils``, ``vision.ops``, the dtype table, the device helpers,
    ``ops.paged_attention``'s per-row path and override, and
    ``ops.pallas``'s ``flash_attention_bshd`` (its
    ``ragged_paged_attention`` stays the submodule, a divergence).
    ``device``'s XLA tuning names
    (``XLA_TUNING_FLAGS``, ``apply_xla_tuning``, ``applied_xla_tuning``)
    stay unexported: they tune XLA, which the port has no counterpart
    of."""
    import paddle_tpu as pt
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.ops import pallas

    assert set(pt.nn.functional.__all__) <= set(paddle.nn.functional.__all__)
    assert set(pt.nn.layer.__all__) <= set(paddle.nn.__all__)
    assert paddle.nn.clip_grad_norm_ is paddle.nn.utils.clip_grad_norm_
    utils = {n for n in dir(pt.nn.utils) if not n.startswith("_")
             and callable(getattr(pt.nn.utils, n))}
    assert utils <= set(paddle.nn.utils.__all__)
    assert set(pt.vision.ops.__all__) == set(paddle.vision.ops.__all__)
    assert set(pt.core.dtype.__all__) <= set(paddle.core.dtype.__all__)
    assert set(pt.ops.paged_attention.__all__) <= set(
        paddle.ops.paged_attention.__all__)
    xla = {"XLA_TUNING_FLAGS", "apply_xla_tuning", "applied_xla_tuning"}
    assert set(pt.device.__all__) - set(paddle.device.__all__) == \
        xla - {"XLA_TUNING_FLAGS"}
    for name in xla:
        assert hasattr(pt.device, name) and not hasattr(paddle.device, name)
    assert paddle.device.get_all_custom_device_type() == []
    assert paddle.device.get_available_custom_device() == []
    from paddle_tpu_torch.ops.pallas.flash_attention import \
        flash_attention_bshd
    assert pallas.flash_attention_bshd is flash_attention_bshd
    # divergence: ragged_paged_attention stays the submodule (the port's
    # modules import it under that name); its entry point is inside it
    import types
    rpa = pallas.ragged_paged_attention
    assert type(rpa) is types.ModuleType
    assert callable(rpa.ragged_paged_attention)
    assert rpa.ragged_paged_attention.launches >= 0
