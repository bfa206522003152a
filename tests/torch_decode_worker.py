"""One rank of ``tests/test_torch_sharded_decode.py``: run under
``torchrun --standalone --nproc-per-node 4`` (gloo, the CPU).  Imports
torch and the port only.

  torch_decode_worker.py <out json> <arch> [<arch> ...]

For each arch's smoke config in float32 (the caches too), on a (data 2,
model 2) ``DeviceMesh`` over the ranks: the params placed by the
sanitized ``param_shardings``, a seeded prompt of 4 rows x 12 tokens
placed by ``batch_shardings``, ``make_prefill_step`` (the caches made on
the mesh by ``cache_shardings``) and then ``make_decode_step`` four
times, each step fed the greedy ids of the one before, under
``implicit_replication`` (as the dry run traces them); against the same
steps on the same values as plain tensors in this process.  Rank 0
writes, per arch and step, the largest difference of the logits and of
each cache leaf (relative to the plain leaf's largest magnitude),
whether the ids agree, and the cache leaves whose placements are not
``cache_shardings``'.
"""

import functools
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.elastic import remesh, reshard_tree
from repro_torch.models.blocks import tree_leaves_with_path
from repro_torch.models.layers import full_value
from repro_torch.runtime import sharding as S
from repro_torch.runtime.steps import make_decode_step, make_prefill_step

B, PROMPT, STEPS = 4, 12, 4


def rel(got, want) -> float:
    den = float(want.abs().max()) or 1.0
    return float((full_value(got) - want).abs().max()) / den


def main(out, archs):
    dist.init_process_group("gloo")
    TL.COMPUTE_DTYPE = TM.COMPUTE_DTYPE = torch.float32
    TM.init_caches = functools.partial(TM.init_caches, dtype=torch.float32)
    mesh = remesh(range(dist.get_world_size()), model_parallel=2,
                  device_type="cpu")
    report = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        params = TM.params_from_numpy(cfg, TM.numpy_params(cfg, 0),
                                      device="cpu")
        placed = reshard_tree(params, S.sanitize(
            S.param_shardings(cfg, mesh), params, mesh), mesh)
        tspec = S.batch_shardings(cfg, mesh, B, "decode")["tokens"]
        cache_specs = S.sanitize(
            S.cache_shardings(cfg, mesh, B),
            TM.init_caches(cfg, B, PROMPT + STEPS, device="meta"), mesh)
        want_pl = [S.to_placements(s, mesh)
                   for _, s in tree_leaves_with_path(cache_specs)]
        prompt = torch.from_numpy(np.random.RandomState(7).randint(
            0, cfg.vocab, (B, PROMPT)).astype(np.int32))
        prefill = make_prefill_step(cfg, cache_len=PROMPT + STEPS)
        decode = make_decode_step(cfg)
        rows = []
        with torch.no_grad(), implicit_replication():
            logits, caches = prefill(params, {"tokens": prompt})
            mlogits, mcaches = prefill(placed, reshard_tree(
                {"tokens": prompt}, {"tokens": tspec}, mesh))
            ids = mids = torch.argmax(logits, -1).to(torch.int32)
            for step in range(STEPS + 1):
                leaves = tree_leaves_with_path(caches)
                mleaves = tree_leaves_with_path(mcaches)
                rows.append({
                    "logits": rel(mlogits, logits),
                    "ids_equal": bool(torch.equal(full_value(mids), ids)),
                    "caches": {path: rel(m, w) for (path, w), (_, m)
                               in zip(leaves, mleaves)},
                    "misplaced": [path for (path, m), pl
                                  in zip(mleaves, want_pl)
                                  if list(m.placements) != pl]})
                if step == STEPS:
                    break
                tok = ids[:, None]
                logits, ids, caches = decode(params, caches, tok,
                                             PROMPT + step)
                mlogits, mids, mcaches = decode(
                    placed, mcaches,
                    reshard_tree({"tokens": tok}, {"tokens": tspec},
                                 mesh)["tokens"], PROMPT + step)
        report[arch] = rows
    dist.barrier()
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
