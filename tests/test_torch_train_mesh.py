"""The train CLI on a mesh: four ``gloo`` ranks on the CPU under
``torchrun``, the elastic re-mesh onto two, and the one-rank mesh.

* ``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train
  --arch deepseek-7b --smoke --steps 8 --device cpu --ckpt-dir ...
  --ckpt-every 4 --simulate-failure-at 6 --trace-out ...`` exits 0,
  re-meshes onto (data 2, model 1), restores step 4 and finishes; its
  loss trace is within ``REL`` of the same command in one process (a
  one-rank mesh).  bfloat16: the two meshes sum the data-parallel
  gradients in other orders, which moves the losses by up to 7e-5.
* The same run in float32 on the reference's seed-0 weights and batches
  (``tests/torch_train_mesh_rank.py``) against the reference CLI on
  four fake XLA devices, patched the same way: within ``REL``.
* One process (a one-rank mesh): the trace, failure and restore
  included, is the unsharded path's bit for bit (``run_training`` on
  plain tensors, steps 0-5 then 4-7).

``REL`` = 1e-4 relative, per step.  The largest differences seen are
written into ``PERF.md``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.train import main, run_training
from repro_torch.runtime import optim as O

ROOT = Path(__file__).resolve().parent.parent
REL = 1e-4
FAIL_ARGS = ["--arch", "deepseek-7b", "--smoke", "--steps", "8",
             "--ckpt-every", "4", "--simulate-failure-at", "6"]
STEPS_WITH_RESTORE = [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]

_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L, repro.models.model as M
from repro.configs import get_smoke_config
from repro.data.pipeline import DataConfig, SyntheticCorpus
from repro.distributed import checkpoint as C
from repro.launch.train import main

out, argv = sys.argv[1], sys.argv[2:]
L.COMPUTE_DTYPE = M.COMPUTE_DTYPE = jnp.float32
arg = lambda k: argv[argv.index(k) + 1]
cfg = get_smoke_config(arg("--arch"))
dc = DataConfig(global_batch=int(arg("--batch")), seq_len=int(arg("--seq")),
                vocab=cfg.vocab)
corpus = SyntheticCorpus(dc)
steps = range(int(arg("--steps")))
np.save(os.path.join(out, "tokens.npy"),
        np.stack([np.asarray(corpus.batch(s)["tokens"]) for s in steps]))
C.save(os.path.join(out, "init"), 0, M.init_params(cfg, jax.random.PRNGKey(0)))
sys.exit(main(argv))
"""


def _env(**env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **env)
    full.pop("XLA_FLAGS", None)
    return full


def _torchrun(*args):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "4", *map(str, args)]


def _finish(proc, timeout):
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"timed out after {timeout} s: {out[-2000:]}"
                    f"{err[-4000:]}")
    return proc.returncode, out, err


def _rel(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _one_process(tmp_path, name, *extra):
    trace = tmp_path / f"{name}.json"
    assert main(FAIL_ARGS + ["--device", "cpu", "--ckpt-dir",
                             str(tmp_path / f"ck_{name}"), "--trace-out",
                             str(trace), *extra]) == 0
    return json.loads(trace.read_text())


def test_four_ranks_remesh_and_match_one_process_and_the_reference(
        tmp_path, capsys):
    # the bf16 command and the reference's float32 run, side by side
    bf16 = subprocess.Popen(
        _torchrun("-m", "repro_torch.launch.train", *FAIL_ARGS, "--device",
                  "cpu", "--ckpt-dir", tmp_path / "ck4", "--trace-out",
                  tmp_path / "four.json"),
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    small = ["--batch", "4", "--seq", "64"]
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_SCRIPT, str(tmp_path), *FAIL_ARGS,
         *small, "--ckpt-dir", str(tmp_path / "ck_ref"), "--trace-out",
         str(tmp_path / "ref.json")],
        env=_env(JAX_PLATFORMS="cpu"), cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rc, out, err = _finish(bf16, 240)
    assert rc == 0, out[-3000:] + err[-6000:]
    assert "[elastic] simulating failure at step 6" in out
    assert "[elastic] re-meshed onto {'data': 2, 'model': 1}, restored " \
           "step 4" in out
    assert out.rstrip().splitlines()[-1].startswith("done:")
    assert out.count("done:") == 1          # rank 0 alone prints
    four = json.loads((tmp_path / "four.json").read_text())
    assert four["steps"] == STEPS_WITH_RESTORE
    one = _one_process(tmp_path, "one")
    assert "re-meshed onto {'data': 1, 'model': 1}" in capsys.readouterr().out
    assert one["steps"] == STEPS_WITH_RESTORE
    rel_bf16 = _rel(four["losses"], one["losses"])
    assert rel_bf16 <= REL, (four["losses"], one["losses"])

    rc, out, err = _finish(ref, 240)
    assert rc == 0, out[-3000:] + err[-6000:]
    port = subprocess.run(
        _torchrun(ROOT / "tests" / "torch_train_mesh_rank.py", tmp_path,
                  *FAIL_ARGS, *small, "--device", "cpu", "--ckpt-dir",
                  tmp_path / "ck_f32", "--trace-out", tmp_path / "f32.json"),
        env=_env(), cwd=str(ROOT), capture_output=True, text=True,
        timeout=240)
    assert port.returncode == 0, port.stdout[-3000:] + port.stderr[-6000:]
    assert "re-meshed onto {'data': 2, 'model': 1}" in port.stdout
    got = json.loads((tmp_path / "f32.json").read_text())
    want = json.loads((tmp_path / "ref.json").read_text())
    assert got["steps"] == want["steps"] == STEPS_WITH_RESTORE
    rel_f32 = _rel(got["losses"], want["losses"])
    assert rel_f32 <= REL, (got["losses"], want["losses"])
    print(f"largest relative loss difference: 4 ranks vs 1, bf16 "
          f"{rel_bf16:.3e}; port vs reference, 4 ranks, float32 "
          f"{rel_f32:.3e}")


def test_one_rank_mesh_is_the_unsharded_path_bit_for_bit(tmp_path):
    """The CLI on a one-rank mesh — DTensors, checkpoint, failure,
    restore — against ``run_training`` on plain tensors."""
    got = _one_process(tmp_path, "mesh1", "--batch", "4", "--seq", "32")
    cfg = get_smoke_config("deepseek-7b")
    oc = O.OptConfig(lr=3e-4, total_steps=10, warmup_steps=2)
    dc = DataConfig(global_batch=4, seq_len=32, vocab=cfg.vocab)
    plain = [rec["loss"] for rec in run_training(cfg, oc, dc, steps=8,
                                                 donate=True, device="cpu")]
    assert got["steps"] == STEPS_WITH_RESTORE
    assert got["losses"] == plain[:6] + plain[4:8]
    assert np.all(np.isfinite(plain))
