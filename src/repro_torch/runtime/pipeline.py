"""Linear time-multiplexed stage pipeline over ranks (paper Fig. 2 at
cluster scale; the reference's ``runtime/pipeline.py``).

The overlay's architecture maps 1:1 onto pipeline parallelism:

  FPGA overlay                      this runtime
  ------------------------------    ----------------------------------------
  linear array of S TM-FUs          S pipeline stages on a 1-D mesh axis
  FU executes its stage's ops       stage executes its slice of layers
  direct FU->FU link (no routing)   send to the next neighbour only
  data packets streaming in         M microbatches streaming in
  II = bottleneck-stage cycles      II = M + S - 1 slots for M outputs
  pipeline replication (Fig. 4)     data-parallel axis around the pipeline

``pipeline_apply`` runs on every rank of the ``stage`` axis of a
``DeviceMesh``: each rank holds ONE stage's parameters (the FU's
instruction memory analogue) and the schedule is the paper's Table I
generalized: slot t runs microbatch t - stage on stage ``stage``.  The
reference's ``ppermute`` around the ring becomes one ``isend`` to the next
rank and one ``irecv`` from the previous, posted together
(``batch_isend_irecv``), so no ordering of blocking calls can deadlock.

The link.  An NCCL group carries device tensors as they are.  A gloo
group takes host tensors only, so on a gloo group a CUDA state is staged
through host memory at every hop (device -> host, send / receive, host ->
device), and so is the final all-reduce.  The staging is chosen by the
group's backend (``dist.get_backend``) before anything is sent, never by
catching a failure, and every hop is counted in ``link_counts``: hops,
bytes, the hops and bytes staged through the host.
"""

from __future__ import annotations

import torch

from repro_torch.models.blocks import tree_leaves, tree_map
from repro_torch.models.layers import is_dtensor

#: what the ring has moved since ``reset_link_counts``: ``hops`` (one
#: slot's state sent to the next stage), ``bytes`` sent, the hops and
#: bytes of them ``staged`` through host memory (a gloo group carrying
#: CUDA tensors), and the final all-reduces (``reduces``,
#: ``reduce_bytes``, ``staged_reduces``)
link_counts: dict[str, int] = {}


def reset_link_counts() -> None:
    link_counts.update(hops=0, bytes=0, staged_hops=0, staged_bytes=0,
                       reduces=0, reduce_bytes=0, staged_reduces=0)


reset_link_counts()


def pipeline_ii(n_microbatches: int, n_stages: int) -> dict:
    """The paper's II model generalized to the device pipeline."""
    slots = n_microbatches + n_stages - 1
    return {
        "slots": slots,
        "bubble_fraction": (n_stages - 1) / slots,
        "ii_per_output": slots / n_microbatches,
    }


def _stage_slice(tree, idx):
    return tree_map(lambda x: x[idx], tree)


def _own_row(x, stage: int):
    """This rank's stage of a leaf with leading dim S: the local shard of
    a ``Shard(0)`` DTensor (one row), or row ``stage`` of a plain tensor."""
    if is_dtensor(x):
        local = x.to_local()
        if local.shape[0] != 1:
            raise ValueError(
                f"a DTensor stage leaf must hold one stage a rank (Shard(0) "
                f"on the stage axis); this rank holds {local.shape[0]}")
        return local[0]
    return x[stage]


def _ring(group, stage: int, S: int):
    """Global ranks of the next and the previous stage."""
    import torch.distributed as dist
    return (dist.get_global_rank(group, (stage + 1) % S),
            dist.get_global_rank(group, (stage - 1) % S))


def _shift(h: torch.Tensor, group, peers, staged: bool) -> torch.Tensor:
    """Send ``h`` to the next stage and return the previous stage's."""
    import torch.distributed as dist
    nxt, prv = peers
    send = h.contiguous()
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, nxt, group),
            dist.P2POp(dist.irecv, recv, prv, group)]):
        w.wait()
    nbytes = send.numel() * send.element_size()
    link_counts["hops"] += 1
    link_counts["bytes"] += nbytes
    if staged:
        link_counts["staged_hops"] += 1
        link_counts["staged_bytes"] += nbytes
        recv = recv.to(h.device)
    return recv


def _psum(y: torch.Tensor, group, staged: bool) -> torch.Tensor:
    import torch.distributed as dist
    buf = y.cpu() if staged else y
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    link_counts["reduces"] += 1
    link_counts["reduce_bytes"] += buf.numel() * buf.element_size()
    if staged:
        link_counts["staged_reduces"] += 1
        buf = buf.to(y.device)
    return buf


def pipeline_apply(mesh, stage_fn, stage_params, x, *, axis: str = "stage",
                   collect_dtype=None):
    """Run x through S chained stages with microbatch streaming.

    stage_fn(params_i, h) -> h  (one stage's compute, e.g. its layer slice)
    stage_params: tree with leading dim S: per leaf a DTensor sharded
      ``Shard(0)`` over ``axis`` (a rank holds its row) or a plain tensor
      (a rank reads row ``stage``)
    x: [M, mb, ...] microbatches, the same on every rank
    mesh: a ``DeviceMesh``; ``axis`` names its stage dimension (one rank
      a stage)

    Returns y [M, mb, ...] — outputs of the final stage, microbatch order,
    the same on every rank.
    """
    import torch.distributed as dist
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    M = x.shape[0]
    params_i = tree_map(lambda p: _own_row(p, stage), stage_params)
    # a gloo group carries host tensors only
    staged = dist.get_backend(group) == "gloo" and x.device.type != "cpu"
    peers = _ring(group, stage, S) if S > 1 else None
    state_dtype = x.dtype if collect_dtype is None else collect_dtype
    state = torch.zeros(x.shape[1:], dtype=state_dtype, device=x.device)
    outputs = torch.zeros_like(x)
    in_dtype = torch.promote_types(x.dtype, state_dtype)
    for t in range(M + S - 1):
        # stage 0 injects microbatch t; others consume neighbour data
        h_in = (x[min(max(t, 0), M - 1)] if stage == 0 else state) \
            .to(in_dtype)
        h_out = stage_fn(params_i, h_in)
        # the last stage records output for microbatch t-(S-1)
        if stage == S - 1 and t >= S - 1:
            outputs[min(max(t - (S - 1), 0), M - 1)] = \
                h_out.to(outputs.dtype)
        # direct neighbour link (the non-programmable interconnect); one
        # stage is its own neighbour
        state = _shift(h_out, group, peers, staged) if S > 1 else h_out
    # only the last stage holds real outputs; broadcast them
    if stage != S - 1:
        outputs.zero_()
    return _psum(outputs, group, staged)


def pipeline_reference(stage_fn, stage_params, x):
    """Sequential oracle: all stages applied in order to each microbatch."""
    S = tree_leaves(stage_params)[0].shape[0]
    outs = []
    for mb in x:
        h = mb
        for i in range(S):
            h = stage_fn(_stage_slice(stage_params, i), h)
        outs.append(h)
    return torch.stack(outs)
