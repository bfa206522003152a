"""The train CLI (``python -m repro_torch.launch.train``) on the CPU, the
reference's launcher tests on the port:

* the CLI's ``--trace-out`` trace == the importable ``run_training``
  loop's, exactly;
* ``--ckpt-dir ... --simulate-failure-at 6`` prints the failure line,
  restores the step-4 checkpoint and finishes (``done:``);
* ``--resume`` continues from the last checkpoint and gives the losses
  an uninterrupted run gives, exactly;
* without ``--device cpu`` it raises where there is no CUDA device.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.distributed import checkpoint as C
from repro_torch.launch.train import main, run_training
from repro_torch.runtime import optim as O

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _cli(*args, timeout=300, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "deepseek-7b", "--smoke", *map(str, args)],
        capture_output=True, text=True, timeout=timeout, env=full,
        cwd=str(ROOT))


def test_cli_and_library_traces_identical(tmp_path):
    steps, batch, seq, lr = 4, 2, 32, 1e-3
    trace_file = tmp_path / "trace.json"
    proc = _cli("--steps", steps, "--batch", batch, "--seq", seq, "--lr", lr,
                "--trace-out", trace_file, "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    got = json.loads(trace_file.read_text())

    cfg = get_smoke_config("deepseek-7b")
    oc = O.OptConfig(lr=lr, total_steps=max(steps, 10),
                     warmup_steps=max(2, steps // 20))
    dc = DataConfig(global_batch=batch, seq_len=seq, vocab=cfg.vocab)
    want = {"steps": [], "losses": []}
    for rec in run_training(cfg, oc, dc, steps=steps, device="cpu"):
        want["steps"].append(rec["step"])
        want["losses"].append(rec["loss"])
    assert got == want, "CLI and library step traces diverged"


def test_train_launcher_with_failure_recovery(tmp_path):
    ck = tmp_path / "ck"
    proc = _cli("--steps", 8, "--batch", 2, "--seq", 32, "--ckpt-dir", ck,
                "--ckpt-every", 4, "--simulate-failure-at", 6,
                "--trace-out", tmp_path / "t.json", "--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[elastic] simulating failure" in proc.stdout
    assert "done:" in proc.stdout
    # steps 4 and 5 ran twice: before the failure and after the restore
    trace = json.loads((tmp_path / "t.json").read_text())
    assert trace["steps"] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert trace["losses"][4:6] == trace["losses"][6:8]
    assert C.list_steps(str(ck)) == [4, 8]


def test_resume_continues_exactly(tmp_path, capsys):
    common = ["--arch", "mamba2-2.7b", "--smoke", "--batch", "2", "--seq",
              "16", "--device", "cpu", "--log-every", "100"]
    straight, first, second = (tmp_path / n for n in ("a.json", "b.json",
                                                      "c.json"))
    assert main(common + ["--steps", "6", "--trace-out", str(straight)]) == 0
    ck = str(tmp_path / "ck")
    assert main(common + ["--steps", "3", "--ckpt-dir", ck,
                          "--trace-out", str(first)]) == 0
    assert C.list_steps(ck) == [3]
    assert main(common + ["--steps", "6", "--ckpt-dir", ck, "--resume",
                          "--trace-out", str(second)]) == 0
    assert "resumed from step 3" in capsys.readouterr().out
    a, b, c = (json.loads(p.read_text()) for p in (straight, first, second))
    assert b["steps"] + c["steps"] == a["steps"] == list(range(6))
    assert b["losses"] + c["losses"] == a["losses"]


def test_cli_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli("--steps", 1, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "done" not in proc.stdout
