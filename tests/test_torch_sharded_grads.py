"""The sharded training step's loss and gradients on four ``gloo`` ranks
(a (data 2, model 2) mesh, ``tests/torch_grad_worker.py`` under
``torchrun``) against the same step on plain tensors, float32, with
weight gathering off and on, for every arch's smoke config; and on eight
(a (2, 4) mesh) for the configs whose kv heads do not split 4 ways and
for the Mamba2 and MoE configs, whose mixer heads and expert ``d_ff``
then split 4 ways.  Each arch runs a batch of 4 rows of 17 tokens and a
short one of 2 rows of 3, whose products move their few activations over
the data axis instead of gathering the weights.

On a mesh each rank runs its own block of every product (the explicit
tensor-parallel layouts of ``models/layers.py``), the residual stream is
re-laid out between blocks, the Mamba2 mixer runs on each rank's rows
and its share of the heads, the MoE routes each rank's rows through its
block of every expert, and the loss is a vocab-parallel cross entropy;
the pending sums of their gradients are stated by hand.  This
holds them to the plain step's values: the loss within 1e-5 relative and
every gradient leaf within 1e-4 of its largest magnitude (float32 sums
taken in another order).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS

ROOT = Path(__file__).resolve().parent.parent


#: smoke configs whose kv heads a 4-way model axis cannot split: their
#: projections are gathered before the heads split (``layers.heads``)
UNEVEN = ("phi3.5-moe-42b-a6.6b", "gemma3-4b", "minitron-8b",
          "internvl2-26b")
#: the configs of a heads-parallel Mamba2 mixer or tensor-parallel
#: experts, on a model axis wider than two
SPLIT_4 = ("mamba2-2.7b", "zamba2-7b", "qwen2-moe-a2.7b")


def _ranks(tmp_path_factory, nproc, archs):
    out = tmp_path_factory.mktemp("grads") / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc),
         str(ROOT / "tests" / "torch_grad_worker.py"), str(out), *archs],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """Four ranks, a (2, 2) mesh: every arch."""
    return _ranks(tmp_path_factory, 4, ARCHS)


@pytest.fixture(scope="module")
def report_2x4(tmp_path_factory):
    """Eight ranks, a (2, 4) mesh: the archs of uneven heads, and the
    Mamba2 and MoE archs."""
    return _ranks(tmp_path_factory, 8, UNEVEN + SPLIT_4)


def _check(row, gather):
    got = row[f"gather_{gather}"]
    assert got["loss"] == pytest.approx(row["loss"], rel=1e-5), row
    assert got["grad_rel"] <= 1e-4, row


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_are_the_plain_steps(report, arch, gather):
    _check(report[arch]["full"], gather)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("arch", UNEVEN)
def test_uneven_heads_on_a_2x4_mesh(report_2x4, arch, gather):
    _check(report_2x4[arch]["full"], gather)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("arch", SPLIT_4)
def test_mixer_heads_and_experts_split_4_ways(report_2x4, arch, gather):
    _check(report_2x4[arch]["full"], gather)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_a_short_batch_moves_its_activations(report, arch, gather):
    """The short batch: with weight gathering off its products move their
    activations over the data axis (weights stay split) and the gradients
    still are the plain step's; with it on, every weight is whole."""
    row = report[arch]["short"]
    _check(row, gather)
    assert (row[f"gather_{gather}"]["moved"] > 0) is not gather, row
