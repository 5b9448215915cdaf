"""The reference's example scripts run against the port with nothing
changed but the package name: each of ``examples/{train_llama,
generate_llama,train_packed,serve_llama,generate_compiled}.py`` (with
``_common.py``) is copied, the word ``paddle_tpu`` replaced by
``paddle_tpu_torch``, and run in a fresh process after
``paddle_tpu_torch.set_device("cpu")`` —
the one line a CPU run adds, since the port runs on the card by
default. ``chip_smoke.py`` runs the same copies on the card."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ["train_llama.py", "generate_llama.py", "train_packed.py",
            "serve_llama.py", "generate_compiled.py"]


def port_copy(dst: Path):
    """The examples and their helper, with the package renamed."""
    for name in ["_common.py"] + EXAMPLES:
        text = (REPO / "examples" / name).read_text()
        (dst / name).write_text(
            re.sub(r"\bpaddle_tpu\b", "paddle_tpu_torch", text))


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs_on_the_port(script, tmp_path):
    port_copy(tmp_path)
    code = ("import runpy, sys\n"
            "import paddle_tpu_torch\n"
            "paddle_tpu_torch.set_device('cpu')\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            f"runpy.run_path({str(tmp_path / script)!r}, "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
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
