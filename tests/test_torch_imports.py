"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax``, ``ml_dtypes`` or the JAX package
``repro``; the package imports where there is no ``triton`` and no ``nvcc``
and builds nothing on import."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro", "flax", "optax")
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
