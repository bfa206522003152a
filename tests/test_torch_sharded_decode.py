"""Sharded serving held numerically: prefill and four greedy decode steps
on four ``gloo`` ranks (a (data 2, model 2) mesh,
``tests/torch_decode_worker.py`` under ``torchrun``) against the same
steps on plain tensors, float32, for the mamba2-2.7b, zamba2-7b and
qwen2-moe-a2.7b smoke configs.

On the mesh Mamba2's prefill runs its mixer by heads over the model axis
and its decode on the caches' own layouts (the SSM state split over
``d_state``, the conv state over its channels, ``y`` a pending sum
all-reduced once), the MoE routes each rank's rows through its block of
every expert, attention runs on each rank's kv heads, and a decode
step's products move its few activations instead of gathering weights.

Bounds, after prefill and after each step: the logits and every cache
leaf within 1e-5 of the plain leaf's largest magnitude, the greedy ids
equal, every cache leaf in ``cache_shardings``' placements.  1e-5:
float32 sums taken in another order (``y`` over ``d_state`` in halves,
products split over the model axis) differ by a few ulps.  The caches
are float32 here: in the default bf16, a one-ulp float32 difference at
a rounding boundary becomes a 2^-8 one.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("mamba2-2.7b", "zamba2-7b", "qwen2-moe-a2.7b")
REL = 1e-5


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("decode") / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4",
         str(ROOT / "tests" / "torch_decode_worker.py"), str(out), *ARCHS],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_ids_are_the_plain_steps(report, arch):
    rows = report[arch]
    assert len(rows) == 5            # prefill, then four steps
    for step, row in enumerate(rows):
        assert row["logits"] <= REL, (step, row["logits"])
        assert row["ids_equal"], step


@pytest.mark.parametrize("arch", ARCHS)
def test_caches_are_the_plain_steps_in_their_layout(report, arch):
    for step, row in enumerate(report[arch]):
        assert row["caches"], step
        for path, rel in row["caches"].items():
            assert rel <= REL, (step, path, rel)
        assert row["misplaced"] == [], (step, row["misplaced"])
