"""The port stands alone: nothing under ``src/repro_torch/``, in
``chip_smoke.py`` or in the port's examples (``examples/*_torch.py``)
imports ``jax``, ``ml_dtypes`` or the JAX package ``repro``; the package
imports where there is no ``triton`` and no ``nvcc`` and builds nothing on
import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro", "flax", "optax")
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"] \
    + EXAMPLES
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PACKAGE.rglob("*.py"))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_sources_exist():
    assert len(SOURCES) > 20
    assert (PACKAGE / "kernels" / "tmfu" / "csrc" / "tmfu.cu").is_file()
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_nothing_of_the_reference(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _run(code: str, **env):
    full = {**os.environ, "PYTHONPATH": str(ROOT / "src"), **env}
    return subprocess.run([sys.executable, "-c", code], env=full,
                          capture_output=True, text=True, timeout=300)


def test_fresh_interpreter_keeps_the_reference_out():
    """Importing the serving entry point pulls in neither ``jax`` nor
    ``repro``, builds no kernel and needs neither ``triton`` nor ``nvcc``
    (an empty PATH hides any compiler)."""
    code = (
        "import sys, importlib\n"
        f"mods = {MODULES!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "import repro_torch.launch.serve\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} + ('triton',)]\n"
        "assert not bad, bad\n"
        "from repro_torch.kernels.tmfu import kernel\n"
        "assert kernel._lib is None\n"
        "print('ok', len(mods))\n")
    proc = _run(code, PATH="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_cpu_path_runs_without_a_compiler():
    """A CPU tensor takes the plain version: no nvcc is looked for."""
    code = (
        "import numpy as np, torch\n"
        "from repro_torch.core.overlay import Overlay, compile_program\n"
        "from repro_torch.core.paper_bench import benchmark\n"
        "from repro_torch.kernels.tmfu import kernel\n"
        "k = compile_program(benchmark('poly6'))\n"
        "ov = Overlay(device='cpu')\n"
        "ys = ov(ov.load(k), [np.ones(100, np.float32) for _ in k.dfg.inputs])\n"
        "assert ys[0].shape == (100,) and kernel._lib is None\n"
        "assert sum(kernel.launch_counts.values()) == 0\n"
        "print('ok')\n")
    proc = _run(code, PATH="")
    assert proc.returncode == 0, proc.stderr


def test_missing_compiler_is_an_error_not_a_fallback(tmp_path, monkeypatch):
    from repro_torch.kernels.tmfu import kernel
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.build_library()
    assert not list(tmp_path.glob("*.so"))


def test_chip_smoke_fails_without_a_gpu():
    """No CUDA device: non-zero exit and no verdict line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


#: the serving fleet and its network edge
FLEET_AND_EDGE = (
    "repro_torch.sched", "repro_torch.sched.preempt",
    "repro_torch.sched.routing", "repro_torch.sched.autoscale",
    "repro_torch.sched.pump", "repro_torch.launch.mesh",
    "repro_torch.launch.serve", "repro_torch.launch.transport",
    "repro_torch.launch.gateway", "repro_torch.launch.socket_gateway")


@pytest.mark.parametrize("module", FLEET_AND_EDGE)
def test_fleet_and_edge_modules_stand_alone(module):
    """Each module of the fleet and the edge is part of the port and
    imports nothing of the reference (checked on its source, above, and
    here by name so that none can go missing)."""
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_fleet_needs_a_card_in_a_fresh_interpreter():
    """The ten modules import with no GPU and no compiler, pull in
    neither ``jax`` nor ``repro``, and ``ShardedOverlayServer`` with
    ``devices=None`` raises where no CUDA device is visible."""
    code = (
        "import sys, importlib\n"
        f"for m in {FLEET_AND_EDGE!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "from repro_torch.launch.serve import ShardedOverlayServer\n"
        "try:\n"
        "    ShardedOverlayServer(n_replicas=2, devices=None)\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "    print('raised')\n")
    proc = _run(code, PATH="", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


#: the training path
TRAINING = (
    "repro_torch.runtime.optim", "repro_torch.runtime.compress",
    "repro_torch.runtime.steps", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.distributed",
    "repro_torch.distributed.checkpoint", "repro_torch.launch.train",
    "repro_torch.launch.trainer_tenant")


@pytest.mark.parametrize("module", TRAINING)
def test_training_modules_stand_alone(module):
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_training_needs_a_card_in_a_fresh_interpreter():
    """The training modules import with no GPU and no compiler, pull in
    neither ``jax`` nor ``repro``, and ``run_training`` with no device
    raises where no CUDA device is visible (nothing falls back to the
    CPU)."""
    code = (
        "import sys, importlib\n"
        f"for m in {TRAINING!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.data import DataConfig\n"
        "from repro_torch.launch.train import run_training\n"
        "from repro_torch.runtime.optim import OptConfig\n"
        "cfg = get_smoke_config('deepseek-7b')\n"
        "try:\n"
        "    next(run_training(cfg, OptConfig(), DataConfig(2, 8, 256),\n"
        "                      steps=1))\n"
        "except RuntimeError as e:\n"
        "    assert 'no CUDA device' in str(e), e\n"
        "    print('raised')\n")
    proc = _run(code, PATH="", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


#: the multi-device training path and the test helper
MULTI_DEVICE = (
    "repro_torch.runtime.sharding", "repro_torch.distributed.elastic",
    "repro_torch.launch.mesh", "repro_torch.testing",
    "repro_torch.models.layers", "repro_torch.distributed.checkpoint",
    "repro_torch.launch.train")


@pytest.mark.parametrize("module", MULTI_DEVICE)
def test_multi_device_modules_stand_alone(module):
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_examples_exist_beside_the_references():
    """The five examples ported, each beside its reference example."""
    names = [p.name for p in EXAMPLES]
    assert names == ["overlay_pipeline_torch.py", "pipeline_lm_torch.py",
                     "quickstart_torch.py", "serve_batch_torch.py",
                     "train_e2e_torch.py"]
    for p in EXAMPLES:
        assert (p.parent / p.name.replace("_torch", "")).is_file()


def test_multi_device_modules_import_without_a_process_group():
    """Importing them pulls in neither ``jax`` nor ``repro``, starts no
    process group, and the spec rules run on a ``(names, sizes)`` mesh."""
    code = (
        "import sys, importlib\n"
        f"for m in {MULTI_DEVICE!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.runtime import sharding as S\n"
        "spec = S.param_shardings(get_config('deepseek-7b'),\n"
        "                         (('data', 'model'), (16, 16)))\n"
        "print(spec['head'])\n")
    proc = _run(code, PATH="", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "Spec('data', 'model')"


#: the microbatch pipeline ring and the dry run
PIPELINE_AND_DRYRUN = ("repro_torch.runtime.pipeline",
                       "repro_torch.launch.dryrun")


@pytest.mark.parametrize("module", PIPELINE_AND_DRYRUN)
def test_pipeline_and_dryrun_modules_stand_alone(module):
    assert module in MODULES
    path = ROOT / "src" / Path(*module.split("."))
    assert not _imported_roots(path.with_suffix(".py")) & set(FORBIDDEN)


def test_pipeline_and_dryrun_import_without_a_process_group():
    """Importing them pulls in neither ``jax`` nor ``repro``, starts no
    process group and loads no fake process group (the dry run makes its
    fake world in ``fake_world``)."""
    code = (
        "import sys, importlib\n"
        f"for m in {PIPELINE_AND_DRYRUN!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} or m.endswith('fake_pg')]\n"
        "assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print('ok')\n")
    proc = _run(code, PATH="", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_every_reference_module_has_a_counterpart():
    """The port covers every module of the JAX package, path for path."""
    ref = {p.relative_to(ROOT / "src" / "repro")
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(PACKAGE) for p in PACKAGE.rglob("*.py")}
    assert ref <= port, sorted(map(str, ref - port))
