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
        "paddle_tpu_torch.nn.layer.norm\n"
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
    assert resolve_device("cpu") == torch.device("cpu")


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
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(model, max_blocks=8, block_size=4, prefill_chunk=4,
                      device="cpu", **kwarg)


def test_engine_refuses_lora_slots_and_unknown_impls():
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import ServingEngine
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    model._lora_slots = 2
    with pytest.raises(NotImplementedError, match="LoRA"):
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
    from paddle_tpu_torch.nn.layer import rnn
    from paddle_tpu_torch.ops.pallas import flash_attention as fa
    from paddle_tpu_torch.ops.pallas import grouped_matmul as gm
    from paddle_tpu_torch.ops.pallas import ragged_paged_attention as rpa
    # the recurrent layers pick their route by device; no failure of the
    # fused recurrence sends a CUDA tensor to the step loop
    for mod, names in ((rnn, ("_fused_layer", "_scan_rnn", "_RNNBase")),
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
