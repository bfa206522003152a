"""One rank of ``tests/test_torch_sharded_grads.py``: run under
``torchrun --standalone --nproc-per-node 4`` (or 8; gloo, the CPU).
Imports torch and the port only.

  torch_grad_worker.py <out json> <arch> [<arch> ...]

For each arch's smoke config in float32 (a seeded batch of 4 rows, with
the vision or audio embeddings the arch takes), on a (data 2, model
world / 2) ``DeviceMesh`` over the ranks: ``loss_and_grads`` on the
params and batch placed by the sanitized ``param_shardings`` /
``batch_shardings``
(the explicit tensor-parallel products, the rows layout between blocks,
the vocab-parallel loss), with ``set_weight_gather`` off and on, against
``loss_and_grads`` on the same values as plain tensors in this process;
then the same on a short batch (2 rows of 3 tokens), whose products move
their few activations rather than gather a weight over the data axis
(``layers._moves_less``).  Rank 0 writes, per arch and batch, the loss,
the largest gradient difference (relative to the leaf's largest
magnitude) of each run and how many products moved their activations.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.elastic import remesh, reshard_tree
from repro_torch.models.blocks import tree_leaves_with_path
from repro_torch.models.layers import full_value
from repro_torch.runtime import sharding as S
from repro_torch.runtime.steps import loss_and_grads


def main(out, archs):
    dist.init_process_group("gloo")
    TL.COMPUTE_DTYPE = TM.COMPUTE_DTYPE = torch.float32
    world = dist.get_world_size()
    mesh = remesh(range(world), model_parallel=world // 2, device_type="cpu")
    moved = [0]
    moves_less = TL._moves_less

    def counted(*sizes):
        out = moves_less(*sizes)
        moved[0] += out
        return out

    TL._moves_less = counted
    report = {}
    for arch in archs:
        cfg = get_smoke_config(arch)
        params = TM.params_from_numpy(cfg, TM.numpy_params(cfg, 0),
                                      device="cpu")
        pspec = S.sanitize(S.param_shardings(cfg, mesh), params, mesh)
        placed = reshard_tree(params, pspec, mesh)
        report[arch] = {}
        for name, rows, seq in (("full", 4, 17), ("short", 2, 3)):
            rs = np.random.RandomState(5)
            text = seq - cfg.vision_tokens if seq > cfg.vision_tokens else 2
            whole = {"tokens": torch.from_numpy(rs.randint(
                0, cfg.vocab, (rows, text)).astype(np.int32))}
            if cfg.vision_tokens:
                whole["vision_embeds"] = torch.from_numpy(
                    rs.standard_normal((rows, cfg.vision_tokens,
                                        cfg.d_model)).astype(np.float32))
            if cfg.encoder is not None:
                whole["frame_embeds"] = torch.from_numpy(rs.standard_normal(
                    (rows, 16, cfg.d_model)).astype(np.float32))
            loss, grads = loss_and_grads(cfg, params, whole)
            bspec = S.batch_shardings(cfg, mesh, rows, "train")
            batch = reshard_tree(whole, {k: bspec[k] for k in whole}, mesh)
            row = {"loss": float(loss)}
            for gather in (False, True):
                TL.set_weight_gather(gather)
                moved[0] = 0
                try:
                    got, ggrads = loss_and_grads(cfg, placed, batch)
                finally:
                    TL.set_weight_gather(False)
                worst = 0.0
                for (path, g), (_, want) in zip(
                        tree_leaves_with_path(ggrads),
                        tree_leaves_with_path(grads)):
                    g = full_value(g)
                    assert g.shape == want.shape, (path, g.shape,
                                                   want.shape)
                    den = float(want.abs().max()) or 1.0
                    worst = max(worst, float((g - want).abs().max()) / den)
                row[f"gather_{gather}"] = {"loss": float(got),
                                           "grad_rel": worst,
                                           "moved": moved[0]}
            report[arch][name] = row
    dist.barrier()
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump(report, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
