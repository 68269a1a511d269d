"""The PyTorch port stands alone: no JAX and nothing of the JAX package in
``src/repro_torch`` or ``chip_smoke.py``, and its entry points refuse to
fall back to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_the_port():
    files = _port_sources()
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []


# the fault-model slice's copies and ports of pure-Python reference modules
SLICE2_MODULES = ["core/aging.py", "core/noise.py", "resident/__init__.py",
                  "resident/manager.py", "resident/mapping.py",
                  "resident/cosched.py", "obs/__init__.py", "obs/metrics.py",
                  "obs/meter.py", "serve/calibration.py", "drift_bench.py",
                  "kernels/blend.py"]


@pytest.mark.parametrize("module", SLICE2_MODULES)
def test_fault_model_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    # every import statement, function-level (lazy) ones included
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'repro')]\n"
              "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import api, bridge
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tfm
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=16,
                      num_heads=2, num_kv_heads=1, d_ff=32, vocab_size=64,
                      compute_dtype="float32")
    params = tfm.init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.Program.build(cfg, params, execution="photonic")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.params_from_flat({"a/b": [1.0]})
    prog = api.Program.build(cfg, params, execution="photonic", device="cpu")
    assert prog.device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    runs = [subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                           cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=120)]
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs.append(subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                               env=env, capture_output=True, text=True,
                               timeout=120))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
