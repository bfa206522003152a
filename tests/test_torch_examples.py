"""The port's four examples (``examples/*_torch.py``) on the CPU, each
beside its reference example: same command-line surface plus
``--device``, and the same non-timing numbers printed.

* quickstart: every line the reference prints (the DFG, the schedule,
  area, the context, Table I's cycles, the overlay-vs-oracle error).
* overlay_pipeline: per kernel ii, FUs, context bytes and the error.
* serve_batch: the LM path's lines with the timings taken out; the
  sampled ids are the port's own (its weights come from torch's
  generator, the reference's from ``jax.random``), so only their count
  and range are held.
* train_e2e (``--steps 30 --batch 4 --seq 64``): the parameter count and
  the logged steps; the losses are the port's own (weights and token
  stream differ by framework) and must fall.

Each port example ends with a JSON report line (kernel launches: none on
the CPU) that the reference does not print.  Each run has a timeout.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TIMED = re.compile(r"[\d,.]+ (ms|tok/s)|,[\d.]+,(?=[\d.e+-]+$)")


def _run(script, *args, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu", **env)
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *map(str, args)], env=full, capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.rstrip("\n").splitlines()


def _port(name, *args):
    lines = _run(f"{name}_torch.py", *args, "--device", "cpu")
    report = json.loads(lines[-1])
    assert report["example"] == name
    assert sum(report["launches"].values()) == 0      # the CPU: no kernel
    return lines[:-1], report


def test_quickstart():
    lines, report = _port("quickstart")
    assert lines == _run("quickstart.py")
    assert report["max_err"] == 0.0


def test_overlay_pipeline():
    lines, report = _port("overlay_pipeline", "--batch", 1024)
    want = _run("overlay_pipeline.py", "--batch", 1024)
    assert lines[0] == "device=cpu  batch=1024"
    assert want[0] == "backend=jnp  batch=1024"
    untimed = [TIMED.sub(",", line) for line in lines[1:]]
    assert untimed == [TIMED.sub(",", line) for line in want[1:]]
    assert len(untimed) == 9 and set(report["max_err"].values()) == {0.0}


def test_serve_batch():
    lines, report = _port("serve_batch")
    want = _run("serve_batch.py")

    def shape(out):
        ids = [ln for ln in out if ln.startswith("sample token ids")]
        return [TIMED.sub("T", ln) for ln in out
                if not ln.startswith("sample token ids")], ids

    (got, got_ids), (ref, ref_ids) = shape(lines), shape(want)
    assert got == ref
    ids = json.loads(got_ids[0].split(":", 1)[1])
    assert len(ids) == len(json.loads(ref_ids[0].split(":", 1)[1])) == 12
    assert all(0 <= i < 256 for i in ids)
    assert report["arch"] == "deepseek-7b"


def test_train_e2e(tmp_path):
    args = ("--steps", 30, "--batch", 4, "--seq", 64)
    lines, report = _port("train_e2e", *args, "--ckpt-dir", tmp_path / "p")
    want = _run("train_e2e.py", *args, "--ckpt-dir", tmp_path / "r")
    assert lines[0] == want[0] == "e2e-10m: ~8,128,768 params"

    def steps(out):
        return [int(ln.split()[1]) for ln in out if ln.startswith("step ")]

    assert steps(lines) == steps(want) == [0, 20, 29]
    assert lines[-1].startswith("loss ") and want[-1].startswith("loss ")
    assert report["loss_last10"] < report["loss_first10"]
    assert report["params"] == 8_128_768 and report["steps"] == 30
    assert report["max_memory_allocated_gb"] is None


@pytest.mark.parametrize("script", ["quickstart_torch.py",
                                    "overlay_pipeline_torch.py",
                                    "serve_batch_torch.py",
                                    "train_e2e_torch.py"])
def test_examples_need_a_card_unless_told_cpu(script):
    """Without ``--device`` an example runs on the CUDA device, and raises
    where there is none."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           "--steps", "1"] if "train" in script else
                          [sys.executable, str(ROOT / "examples" / script)],
                          env=full, capture_output=True, text=True,
                          timeout=120, cwd=str(ROOT))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
