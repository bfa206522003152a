"""Building a kernel library: ``nvcc`` into a shared object with a plain C
interface, cached under a name that carries a hash of the source and the
flags, so that an edited source (or a changed flag) never loads a stale
build.  Nothing here runs when a kernel module is imported."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path


def build_dir(module_dir: Path) -> Path:
    """Where a library is built: ``$REPRO_TORCH_BUILD_DIR`` or a ``build/``
    directory beside the kernel's module (git-ignored)."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else module_dir / "build"


def find_nvcc(what: str) -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       f"in /usr/local/cuda): {what} cannot be built")


def build(source: Path, flags, stem: str, out_dir: Path, what: str,
          verbose: bool = False) -> Path:
    """``out_dir/lib<stem>_<hash>.so`` compiled from ``source`` with
    ``flags``, unless it exists already."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    lib_path = out_dir / f"lib{stem}_{tag}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".lib{stem}_{tag}.{os.getpid()}.so"
    cmd = [find_nvcc(what), *flags]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, lib_path)            # atomic: concurrent builds agree
    return lib_path
