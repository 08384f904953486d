"""The port stands alone: it imports torch and numpy, never jax and nothing
of the reference package, and chip_smoke.py refuses to run off the card."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)",
                       re.MULTILINE)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax_or_reference_module():
    code = (
        "import sys, json\n"
        "import repro_torch, repro_torch.core, repro_torch.snn, "
        "repro_torch.nocsim, repro_torch.interop\n"
        "import repro_torch.kernels.lif_step, repro_torch.kernels.gain_eval, "
        "repro_torch.kernels.swap_delta, repro_torch.kernels.link_load\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_port_sources_import_no_jax_or_reference_module():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): FORBIDDEN.findall(f.read_text())
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, env=_env(),
                          timeout=120)


def test_chip_smoke_fails_without_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
