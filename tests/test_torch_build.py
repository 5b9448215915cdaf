"""The port's kernel build (``paddle_tpu_torch/ops/pallas/_build.py``) on
the CPU: which files a library's name depends on. No ``nvcc`` runs here;
the tests point the build at a directory of their own."""
import pytest

from paddle_tpu_torch.ops.pallas import _build


@pytest.fixture
def src_dir(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "shared.cuh").write_text("// version 1\n")
    monkeypatch.setattr(_build, "_SRC_DIR", tmp_path)
    return tmp_path


def _targets():
    return {name: _build._target(name) for name in ("a", "b")}


def test_sources_are_the_cu_files_only(src_dir):
    assert _build.sources() == ["a", "b"]


def test_target_names_are_stable(src_dir):
    first = _targets()
    assert _targets() == first
    assert all(t.name.startswith(f"{n}-") and t.suffix == ".so"
               for n, t in first.items())


def test_a_header_edit_renames_every_target(src_dir):
    """A source may include any shared header, so an edit of one must
    never load a library built from the old header."""
    before = _targets()
    (src_dir / "shared.cuh").write_text("// version 2\n")
    after = _targets()
    assert all(before[n] != after[n] for n in before)


def test_a_new_header_renames_every_target(src_dir):
    before = _targets()
    (src_dir / "other.cuh").write_text("// new\n")
    after = _targets()
    assert all(before[n] != after[n] for n in before)


def test_a_source_edit_renames_only_its_target(src_dir):
    before = _targets()
    (src_dir / "b.cu").write_text("int b2;\n")
    after = _targets()
    assert after["a"] == before["a"] and after["b"] != before["b"]


def test_the_package_ships_its_sources_and_shared_header():
    assert _build.sources() == ["flash_attention", "fused_update",
                                "grouped_matmul", "ragged_paged_attention"]
    assert (_build._SRC_DIR / "hopper.cuh").is_file()


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mangled,instance", [
    ("_ZN51_GLOBAL__N__a0edee5c_18_flash_attention_cu_5326155221"
     "flash_dq_wgmma_kernelILi128EEEv14CUtensorMap_stS0_S0_S0_11FlashParams",
     "flash_dq_wgmma_kernelILi128E"),
    ("_ZN51_GLOBAL__N__a0edee5c_18_flash_attention_cu_5326155216"
     "flash_dkv_kernelIfLi64EEEv11FlashParams", "flash_dkv_kernelIfLi64E")])
def test_build_log_names_each_kernel_instance(mangled, instance):
    """``chip_smoke.py``'s phase 2 reads nvcc's ``-Xptxas -v`` output into
    registers and spills per kernel, and names each by its instance: the
    hd-64 and hd-128 kernels of one template must stay apart."""
    smoke = _chip_smoke()
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Function properties for {mangled}\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 217 registers, used 1 barriers\n")
    usage = smoke.ptxas_usage(log)
    assert list(usage) == [mangled]
    assert usage[mangled].startswith("217 registers; 0 bytes stack frame")
    assert smoke.kernel_instance(mangled) == instance
