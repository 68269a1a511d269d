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


# the training slice's new and extended modules
SLICE13_MODULES = ["launch/train.py", "train/__init__.py",
                   "train/trainer.py", "train/checkpoint.py",
                   "optim/__init__.py", "optim/adamw.py",
                   "data/__init__.py", "data/pipeline.py", "api.py",
                   "core/sharing.py", "models/transformer.py"]


@pytest.mark.parametrize("module", SLICE13_MODULES)
def test_training_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax",
                                     "ml_dtypes")]
    assert bad == []


# the paper-models slice's new and extended modules
SLICE14_MODULES = ["models/paper_models.py", "quant/__init__.py",
                   "quant/w8a8.py", "vision_task.py", "paper_run.py",
                   "core/photonic.py", "core/obu.py", "core/sharing.py",
                   "bridge.py"]


@pytest.mark.parametrize("module", SLICE14_MODULES)
def test_paper_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax",
                                     "ml_dtypes", "benchmarks")]
    assert bad == []


def test_paper_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import bridge, paper_run, vision_task
    with pytest.raises(RuntimeError, match="CUDA"):
        vision_task.make_task()
    with pytest.raises(RuntimeError, match="CUDA"):
        vision_task.train_classifier(lambda p, x: x, {}, steps=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_run.build(paper_run.table4_variants()[0][2])
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_run.bench_table4(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_run.bench_table5(quick=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        paper_run.main(["--only", "table3"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.paper_params_from_flat({"convs/0": [1.0]})
    assert vision_task.make_task(device="cpu")(0, 2)[0].device.type == "cpu"


# the sharding slice's new modules and the modules it extended
SLICE15_MODULES = ["sharding/__init__.py", "sharding/partition.py",
                   "sharding/collectives.py", "launch/mesh.py",
                   "launch/shardcheck.py", "core/backend.py",
                   "core/prepared.py", "api.py", "graphs.py",
                   "serve/slots.py", "serve/scheduler.py", "serve/engine.py",
                   "launch/serve.py", "models/transformer.py"]


@pytest.mark.parametrize("module", SLICE15_MODULES)
def test_sharding_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []


# the training-on-a-mesh slice's extended modules
SLICE16_MODULES = ["sharding/collectives.py", "sharding/partition.py",
                   "core/backend.py", "core/prepared.py",
                   "models/transformer.py", "train/trainer.py",
                   "train/checkpoint.py", "optim/adamw.py",
                   "launch/train.py", "launch/shardcheck.py", "api.py"]


@pytest.mark.parametrize("module", SLICE16_MODULES)
def test_train_mesh_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax",
                                     "ml_dtypes")]
    assert bad == []


# the dry-run slice's new modules and the modules it extended
SLICE17_MODULES = ["launch/dryrun.py", "launch/analysis.py",
                   "kernels/planned.py", "configs/__init__.py",
                   "core/obu.py", "core/photonic.py", "core/noise.py",
                   "launch/mesh.py", "sharding/collectives.py",
                   "kernels/photonic_mvm.py", "kernels/flash_attention.py",
                   "kernels/blend.py", "kernels/ssd.py"]


@pytest.mark.parametrize("module", SLICE17_MODULES)
def test_dryrun_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []


# the tensor-parallel attention slice's new module and the modules it
# extended
SLICE18_MODULES = ["kernels/decode_attention.py", "kernels/build.py",
                   "kernels/counts.py", "kernels/planned.py",
                   "models/attention.py", "models/layers.py",
                   "models/transformer.py", "core/backend.py",
                   "sharding/partition.py", "api.py", "serve/slots.py",
                   "launch/dryrun.py", "launch/shardcheck.py"]


@pytest.mark.parametrize("module", SLICE18_MODULES)
def test_tp_attention_slice_modules_are_checked_and_standalone(module):
    path = PORT / module
    assert path in _port_sources()
    bad = [name for name in _imports(path)
           if name.split(".")[0] in ("jax", "jaxlib", "repro", "flax")]
    assert bad == []



def test_mesh_training_defaults_to_cuda_and_refuses_unbound_meshes():
    """``run(mesh=)`` on a rank takes the rank's device; without ranks a
    mesh of several positions is refused, and the train step refuses an
    ``act_pspec`` without a mesh."""
    from repro_torch.configs import smoke_variant
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch
    from repro_torch.train import trainer
    cfg = smoke_variant("minitron-4b")
    with pytest.raises(ValueError, match="init_ranks"):
        launch.run(cfg, TrainConfig(), batch=2, seq=4, steps=1,
                   mesh=mesh_lib.parse_mesh("2x1"), device="cpu")
    with pytest.raises(ValueError, match="init_ranks"):
        trainer.make_train_step(cfg, TrainConfig(),
                                mesh=mesh_lib.parse_mesh("2x2"))
    with pytest.raises(ValueError, match="act_pspec"):
        trainer.make_train_step(cfg, TrainConfig(),
                                act_pspec=("data", "model", None))


def test_sharded_entry_points_default_to_cuda_and_raise_without_it():
    """Spawning ranks defaults to the card and raises without one, as
    the launchers do (``device="cpu"`` runs the plain paths)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as launch
    from repro_torch.launch import shardcheck
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_lib.init_ranks(print, "1x2")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.main(["--arch", "minitron-4b", "--smoke", "--requests", "1",
                     "--mesh", "1x2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        shardcheck.main(["--mesh", "1x2"])


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
