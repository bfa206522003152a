"""Elastic scaling + straggler mitigation (the reference's
``distributed/elastic.py``).

Node-failure recovery path:
  1. the rank set shrinks (simulated by dropping ranks from the list),
  2. ``remesh`` builds the largest consistent (data, model) mesh from the
     survivors (keeping the model axis intact when possible),
  3. ``reshard_tree`` places the last checkpoint onto the new mesh as
     DTensors with freshly derived placements,
  4. training resumes; the data pipeline cursor comes from the checkpoint.

Straggler mitigation: at scale the slowest data-parallel worker sets the
step time.  ``straggler_scale`` implements deadline-skip with gradient
rescaling — microbatches that miss the deadline are dropped and the
summed gradient is rescaled by kept/total so the estimator stays unbiased
(bounded staleness).  The deadline signal is an input (in a deployment it
comes from host-side timers), which keeps the functions pure.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import make_mesh_from_devices
from repro_torch.models.blocks import tree_map
from repro_torch.runtime.sharding import to_placements


def remesh(ranks, model_parallel: int = 16, device_type: str = "cuda"):
    """Largest consistent mesh from the surviving rank list."""
    return make_mesh_from_devices(ranks, model_parallel, device_type)


def _mesh_device(mesh) -> torch.device:
    """The device a rank of ``mesh`` keeps its shards on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(x: torch.Tensor, spec, mesh):
    """``x`` as a DTensor on ``mesh`` with ``spec``'s placements.  A plain
    tensor is this rank's full copy: the rank keeps its block of it, moved
    to the mesh's device — a view where the block is the whole tensor on
    that device already (no second copy of a 52 GB state), else a copy of
    the block alone, so the full tensor can be freed.  A DTensor is
    redistributed (gathered first if it lives on another mesh)."""
    from torch.distributed.tensor import DTensor, Shard

    placements = to_placements(spec, mesh)
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements)
        x = x.full_tensor()
    coord = mesh.get_coordinate()
    local = x
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            local = torch.chunk(local, mesh.size(i), dim=pl.dim)[coord[i]]
    dev = _mesh_device(mesh)
    local = local.to(dev) if local is x or local.device != dev \
        else local.clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def reshard_tree(tree, spec_tree, mesh):
    """``place`` every leaf of ``tree`` onto ``mesh`` with its spec."""
    return tree_map(lambda x, spec: place(x, spec, mesh), tree, spec_tree)


def straggler_scale(grads_sum, kept: torch.Tensor, total: int):
    """Rescale a sum-of-microbatch gradient after deadline skips.

    grads_sum = sum over kept microbatches; kept = how many arrived.
    Returns the unbiased mean-equivalent gradient."""
    kept = torch.as_tensor(kept)
    scale = torch.where(kept > 0, 1.0 / torch.clamp(kept, min=1), 0.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads_sum)


def accumulate_with_deadline(grad_fn, params, microbatches, arrived_mask):
    """Gradient accumulation that skips 'late' microbatches.

    arrived_mask [M] bool — which microbatches met the deadline (in a real
    deployment this comes from per-worker heartbeats; tests drive it).
    The reference's ``lax.scan`` as a loop: every microbatch's gradient is
    taken, and a late one adds zeros.
    """
    M = arrived_mask.shape[0]
    acc = tree_map(torch.zeros_like, params)
    kept = torch.zeros((), dtype=torch.int32)
    for mb, ok in zip(microbatches, arrived_mask):
        g = grad_fn(params, mb)
        acc = tree_map(lambda a, gi: a + torch.where(ok, gi,
                                                     torch.zeros_like(gi)),
                       acc, g)
        kept = kept + ok.to(torch.int32)
    return straggler_scale(acc, kept, M), kept
