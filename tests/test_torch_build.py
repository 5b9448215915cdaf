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
    assert _build.sources() == ["flash_attention", "grouped_matmul",
                                "ragged_paged_attention"]
    assert (_build._SRC_DIR / "hopper.cuh").is_file()
