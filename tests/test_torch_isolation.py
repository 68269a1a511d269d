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


# the MoE slice's new module and the modules it extended
SLICE3_MODULES = ["models/moe.py", "models/transformer.py",
                  "core/backend.py", "kernels/ops.py",
                  "kernels/photonic_mvm.py", "kernels/ref.py"]


@pytest.mark.parametrize("module", SLICE3_MODULES)
def test_moe_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []


# the SSM slice's new modules and the modules it extended
SLICE4_MODULES = ["models/ssm.py", "kernels/ssd.py", "kernels/ops.py",
                  "kernels/build.py", "kernels/ref.py",
                  "models/transformer.py", "core/sharing.py", "api.py",
                  "serve/slots.py", "serve/scheduler.py"]


@pytest.mark.parametrize("module", SLICE4_MODULES)
def test_ssm_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []


# the serving launcher and telemetry slice's new and extended modules
SLICE12_MODULES = ["launch/__init__.py", "launch/serve.py",
                   "obs/__init__.py", "obs/tracing.py", "obs/serving.py",
                   "obs/check_schema.py", "obs/stats.py", "api.py",
                   "serve/slots.py", "serve/scheduler.py", "serve/batcher.py",
                   "serve/engine.py", "models/attention.py",
                   "models/transformer.py", "core/sharing.py"]


@pytest.mark.parametrize("module", SLICE12_MODULES)
def test_launcher_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
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
    from repro_torch.launch import serve as launch
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "minitron-4b", "--smoke", "--requests", "1"])


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
