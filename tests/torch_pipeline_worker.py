"""One rank of ``tests/test_torch_pipeline.py``: run under ``torchrun
--standalone --nproc-per-node 4`` (gloo, the CPU).  Imports torch, numpy
and the port only.

  torch_pipeline_worker.py <dir>

Reads ``<dir>/inputs.npz`` (the tanh stage's params ``w`` [4, d, d] and
``b`` [4, d], microbatches ``x`` [8, mb, d]) and runs the port's
``pipeline_apply`` on these cases:

* ``base``    a (stage 4) mesh, M 8, plain stage params;
* ``dtensor`` the same with the params a ``Shard(0)`` DTensor;
* ``m_lt_s``  M 2 < S 4;
* ``collect`` x in bfloat16, ``collect_dtype`` float32;
* ``s1``      a (data 4, stage 1) mesh: every rank a one-stage ring of
              its own, stage params row ``rank``.

Every rank writes what it returned, and the port's ``pipeline_reference``
of each case, to ``<dir>/rank<r>.npz``, and its link counts a case to
``<dir>/rank<r>.json``.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.runtime import pipeline as P


def stage_fn(p, h):
    return torch.tanh(h.float() @ p["w"] + p["b"])


def run(name, mesh, params, x, out, counts, **kw):
    P.reset_link_counts()
    out[name] = P.pipeline_apply(mesh, stage_fn, params, x, **kw)
    counts[name] = dict(P.link_counts)


def main(d):
    dist.init_process_group("gloo")
    rank = dist.get_rank()
    inp = np.load(os.path.join(d, "inputs.npz"))
    params = {"w": torch.from_numpy(inp["w"]), "b": torch.from_numpy(inp["b"])}
    x = torch.from_numpy(inp["x"])
    ring = DeviceMesh("cpu", [0, 1, 2, 3], mesh_dim_names=("stage",))
    alone = DeviceMesh("cpu", [[0], [1], [2], [3]],
                       mesh_dim_names=("data", "stage"))
    out, refs, counts = {}, {}, {}
    run("base", ring, params, x, out, counts)
    refs["base"] = P.pipeline_reference(stage_fn, params, x)
    sharded = {k: DTensor.from_local(v[rank][None], ring, [Shard(0)],
                                     run_check=False)
               for k, v in params.items()}
    run("dtensor", ring, sharded, x, out, counts)
    run("m_lt_s", ring, params, x[:2], out, counts)
    refs["m_lt_s"] = P.pipeline_reference(stage_fn, params, x[:2])
    xb = x.to(torch.bfloat16)
    run("collect", ring, params, xb, out, counts,
        collect_dtype=torch.float32)
    refs["collect"] = P.pipeline_reference(stage_fn, params,
                                           xb.float()).to(torch.bfloat16)
    own = {k: v[rank:rank + 1] for k, v in params.items()}
    run("s1", alone, own, x, out, counts)
    refs["s1"] = P.pipeline_reference(stage_fn, own, x)

    def arr(t):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    np.savez(os.path.join(d, f"rank{rank}.npz"),
             **{f"y_{k}": arr(v) for k, v in out.items()},
             **{f"ref_{k}": arr(v) for k, v in refs.items()})
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(counts, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
