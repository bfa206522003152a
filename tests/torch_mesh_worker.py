"""One rank of ``tests/test_torch_mesh_gloo.py``: run under ``torchrun
--standalone --nproc-per-node 4`` (gloo, the CPU).  Imports torch and the
port only.

  torch_mesh_worker.py <ref dir> <out json> <arch> [<arch> ...]

For each arch, on a (data 2, model 2) ``DeviceMesh`` over the four ranks:

* the reference's checkpoint (``<ref dir>/<arch>/ckpt``), restored whole
  and placed by ``reshard_tree`` with the port's sanitized
  ``param_shardings``: every leaf's local shard must equal the shard the
  reference's device at this rank's mesh coordinate holds
  (``<ref dir>/<arch>/shards.npz``), bit for bit;
* the same checkpoint through ``restore(shardings=)``: the same shards;
* where ``<ref dir>/<arch>/logits.npy`` exists, the float32 forward over
  ``<ref dir>/tokens.npy`` on those DTensors, with ``set_weight_gather``
  off and on: each within 1e-5 of the reference's logits and of each
  other.

Rank 0 writes, per arch, the largest differences and every rank's
misses to ``<out json>``; the test reads it.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro_torch.configs import get_smoke_config
from repro_torch.distributed import checkpoint as C
from repro_torch.distributed.elastic import remesh, reshard_tree
from repro_torch.models.blocks import tree_leaves_with_path
from repro_torch.models.layers import full_value
from repro_torch.runtime import sharding as S

F32 = dict(rtol=1e-5, atol=1e-5)


def check_shards(tree, shards, coord, what):
    for path, x in tree_leaves_with_path(tree):
        name = C._leaf_name(path)
        want = shards[f"{name}@{coord[0]},{coord[1]}"]
        got = x.to_local().numpy()
        assert got.shape == want.shape, (what, name, got.shape, want.shape)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), \
            (what, name)


def forward(cfg, params, tokens, gather):
    from torch.distributed.tensor.experimental import implicit_replication
    TL.set_weight_gather(gather)
    try:
        with implicit_replication(), torch.no_grad():
            logits, _, _ = TM.forward(cfg, params, tokens)
    finally:
        TL.set_weight_gather(False)
    return full_value(logits).numpy()


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def main(ref, out, archs):
    dist.init_process_group("gloo")
    TL.COMPUTE_DTYPE = TM.COMPUTE_DTYPE = torch.float32
    mesh = remesh(range(4), model_parallel=2, device_type="cpu")
    coord = mesh.get_coordinate()
    tokens = torch.from_numpy(np.load(os.path.join(ref, "tokens.npy")))
    report = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        ck = os.path.join(ref, arch, "ckpt")
        shards = np.load(os.path.join(ref, arch, "shards.npz"))
        like = TM.init_params(cfg, device="meta")
        pspec = S.sanitize(S.param_shardings(cfg, mesh), like, mesh)
        whole = C.restore(ck, like, device="cpu")[0]
        placed = reshard_tree(whole, pspec, mesh)
        restored = C.restore(ck, like, shardings=pspec, mesh=mesh)[0]
        row, misses = {"leaves": len(tree_leaves_with_path(placed))}, []
        for tree, what in ((placed, "reshard_tree"),
                           (restored, "restore(shardings=)")):
            try:
                check_shards(tree, shards, coord, what)
            except AssertionError as e:
                misses.append(f"rank {dist.get_rank()}: {e}")
        fwd = os.path.join(ref, arch, "logits.npy")
        if os.path.exists(fwd):
            want = np.load(fwd)
            bspec = S.batch_shardings(cfg, mesh, tokens.shape[0], "train")
            toks = reshard_tree({"tokens": tokens},
                                {"tokens": bspec["tokens"]}, mesh)["tokens"]
            off = forward(cfg, placed, toks, gather=False)
            on = forward(cfg, placed, toks, gather=True)
            for a, b, what in ((off, want, "off vs ref"),
                               (on, want, "on vs ref"),
                               (on, off, "on vs off")):
                try:
                    np.testing.assert_allclose(a, b, **F32)
                except AssertionError as e:
                    misses.append(f"rank {dist.get_rank()} {what}: {e}")
            row.update(off_vs_ref=rel(off, want), on_vs_ref=rel(on, want),
                       on_vs_off=rel(on, off))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, misses)
        row["misses"] = [m for ms in every for m in ms]
        report[arch] = row
    dist.barrier()
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
