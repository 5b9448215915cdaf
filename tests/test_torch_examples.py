"""The reference's example scripts run against the port with nothing
changed but the package name: each of ``examples/{train_llama,
generate_llama,train_packed,serve_llama,generate_compiled,
export_and_serve,static_regression}.py`` (with ``_common.py``) is
copied, the word ``paddle_tpu`` replaced by ``paddle_tpu_torch``, and run
in a fresh process after ``paddle_tpu_torch.set_device("cpu")`` —
the one line a CPU run adds, since the port runs on the card by
default. ``chip_smoke.py`` runs the same copies on the card.

``examples/int8_deploy.py`` runs the same way to its end: PTQ
calibration, ``convert``, ``convert_to_int8``, the int8 model's forward,
and its step 3, ``paddle.jit.save``/``load`` of the int8 model."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ["train_llama.py", "generate_llama.py", "train_packed.py",
            "serve_llama.py", "generate_compiled.py", "export_and_serve.py",
            "static_regression.py"]


def port_copy(dst: Path):
    """The examples and their helper, with the package renamed."""
    for name in ["_common.py"] + EXAMPLES:
        text = (REPO / "examples" / name).read_text()
        (dst / name).write_text(
            re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", text))


def _run(script, tmp_path):
    code = ("import runpy, sys\n"
            "import paddle_tpu_torch\n"
            "paddle_tpu_torch.set_device('cpu')\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            f"runpy.run_path({str(tmp_path / script)!r}, "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs_on_the_port(script, tmp_path):
    port_copy(tmp_path)
    r = _run(script, tmp_path)
    assert r.returncode == 0, f"{script}:\n{r.stdout}\n{r.stderr}"
    assert "jax" not in r.stderr.lower()
    if script == "train_llama.py":
        losses = [float(m) for m in re.findall(r"loss ([0-9.]+)", r.stdout)]
        assert losses[-1] < losses[0], r.stdout
    if script == "generate_llama.py":
        assert "generated:" in r.stdout
    if script == "generate_compiled.py":
        assert "token-for-token: True" in r.stdout, r.stdout
        assert "deterministic: True" in r.stdout, r.stdout
    if script == "serve_llama.py":
        assert r.stdout.count("tok | ttft") == 3, r.stdout
        # the port runs the unified step eagerly: it compiles no program
        # (the reference's count is 1; ROADMAP §3)
        assert "'step_compiles': 0" in r.stdout, r.stdout
    if script == "export_and_serve.py":
        assert "served logits: (2, 16, 256)" in r.stdout, r.stdout
    if script == "static_regression.py":
        losses = [float(m) for m in re.findall(r"loss ([0-9.]+)", r.stdout)]
        assert len(losses) == 5 and losses[-1] < losses[0] * 1e-3, r.stdout


def test_int8_deploy_runs_to_jit_save(tmp_path):
    """``examples/int8_deploy.py`` with only the package renamed: PTQ,
    ``convert`` and ``convert_to_int8`` run on the port and print the
    reference's lines (the int8 model equals its fake-quant simulation,
    its weights are int8), and step 3 exports the int8 model with
    ``paddle.jit.save`` and serves it through ``jit.load`` equal to the
    int8 model: the run reaches its end."""
    text = (REPO / "examples" / "int8_deploy.py").read_text()
    (tmp_path / "int8_deploy.py").write_text(
        re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", text))
    r = _run("int8_deploy.py", tmp_path)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    err = float(re.search(r"fp32 vs int8 mean \|err\|: ([0-9.e-]+)",
                          r.stdout).group(1))
    assert 0 < err < 0.1, r.stdout
    assert "simulation vs int8 match: True" in r.stdout, r.stdout
    assert "int8 weight dtype: torch.int8" in r.stdout, r.stdout
    assert "served == int8: True" in r.stdout, r.stdout
    assert "jax" not in r.stderr.lower()
