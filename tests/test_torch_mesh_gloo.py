"""The port's multi-device layer on four ``gloo`` ranks on the CPU, held
against the reference on four fake XLA devices.

The reference runs in a subprocess with
``--xla_force_host_platform_device_count=4`` (as
``tests/test_runtime_distributed.py`` runs its pipeline): for every smoke
config it draws its own seed-0 weights, places them on a (data 2, model
2) mesh (``make_mesh_from_devices`` + ``reshard_tree`` with the sanitized
``param_shardings``), writes them with its ``checkpoint.save`` and dumps
what each device holds (``addressable_shards``: the device's mesh
coordinate and its data).  For three configs it also writes the float32
logits of its forward.

Then ``torchrun --standalone`` starts four ranks of
``tests/torch_mesh_worker.py``, which on the port's (data 2, model 2)
``DeviceMesh`` holds every leaf's local shard — after ``reshard_tree``
and after ``restore(shardings=)`` of the reference's checkpoint — to the
reference device's shard at the same coordinate, bit for bit, and the
float32 forward with ``set_weight_gather`` off and on to the reference's
logits within 1e-5 (``rtol = atol``, as ``tests/test_torch_lm_layers.py``
holds float32).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import ARCHS

ROOT = Path(__file__).resolve().parent.parent
FORWARD_ARCHS = ("deepseek-7b", "qwen2-moe-a2.7b", "mamba2-2.7b")

_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
import repro.models.layers as L, repro.models.model as M
from repro.configs import ARCHS, get_smoke_config
from repro.distributed import checkpoint as C
from repro.distributed.elastic import remesh, reshard_tree
from repro.runtime import sharding as S

out, fwd_archs = sys.argv[1], sys.argv[2].split(",")
L.COMPUTE_DTYPE = M.COMPUTE_DTYPE = jnp.float32
mesh = remesh(jax.devices(), model_parallel=2)
coord = {d.id: (int(i), int(j)) for (i, j), d in np.ndenumerate(mesh.devices)}
tokens = np.load(os.path.join(out, "tokens.npy"))
for arch in ARCHS:
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, jax.random.PRNGKey(0))
    spec = S.sanitize(S.param_shardings(cfg, mesh),
                      jax.eval_shape(lambda: params), mesh)
    params = reshard_tree(params, spec, mesh)
    d = os.path.join(out, arch)
    C.save(os.path.join(d, "ckpt"), 0, params)
    names, leaves = C._flatten(params)
    shards = {}
    for name, leaf in zip(names, leaves):
        for sh in leaf.addressable_shards:
            i, j = coord[sh.device.id]
            shards[f"{name}@{i},{j}"] = np.asarray(sh.data)
    np.savez(os.path.join(d, "shards.npz"), **shards)
    if arch in fwd_archs:
        logits, _, _ = jax.jit(lambda p, t: M.forward(cfg, p, t))(
            params, jnp.asarray(tokens))
        np.save(os.path.join(d, "logits.npy"), np.asarray(logits))
print("REF_OK")
"""


def _run(cmd, timeout, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **env)
    full.pop("XLA_FLAGS", None)
    return subprocess.run(cmd, env=full, capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT))


@pytest.fixture(scope="module")
def mesh_report(tmp_path_factory):
    """Run the reference's dump, then the four ranks; the ranks' report."""
    tmp = tmp_path_factory.mktemp("mesh")
    tokens = np.random.RandomState(3).randint(0, 256, (4, 16)) \
        .astype(np.int32)
    np.save(tmp / "tokens.npy", tokens)
    ref = _run([sys.executable, "-c", _REF_SCRIPT, str(tmp),
                ",".join(FORWARD_ARCHS)], timeout=300, JAX_PLATFORMS="cpu")
    assert "REF_OK" in ref.stdout, ref.stdout + ref.stderr
    out = tmp / "report.json"
    proc = _run([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", "4",
                 str(ROOT / "tests" / "torch_mesh_worker.py"), str(tmp),
                 str(out), *ARCHS], timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_the_reference_devices_shard(mesh_report, arch):
    """After ``reshard_tree`` and after ``restore(shardings=)`` of the
    reference's checkpoint: every leaf, every rank, bit for bit."""
    row = mesh_report[arch]
    assert row["leaves"] > 0
    assert not row["misses"], row["misses"]


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_with_and_without_weight_gather_is_the_references(
        mesh_report, arch):
    row = mesh_report[arch]
    assert max(row["off_vs_ref"], row["on_vs_ref"], row["on_vs_off"]) \
        <= 1e-5, row
