"""The paper's linear TM-FU pipeline carrying real transformer stages, on
the PyTorch port (``examples/pipeline_lm.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/pipeline_lm_torch.py               # GPU
    PYTHONPATH=src python examples/pipeline_lm_torch.py --device cpu

Maps a 4-stage decoder onto a 4-rank ring: the script starts its own four
ranks (``torch.multiprocessing``, a ``gloo`` group on localhost), as the
reference forces four host devices.  Stage s = FU s, time-multiplexed over
its layer slice; each rank draws its own stage's weights from a seeded
``torch.Generator``; microbatches stream through neighbour sends; the
output is checked against sequential execution; the paper's II model is
printed for the chosen (M, S).  On the GPU the four ranks share the card
and the gloo link stages every hop through host memory (counted in the
report).  The last line is a JSON report: the error, the II model, the
device, the link's counts and the TMFU kernel launches (none).
"""

import argparse
import json
import os
import socket

S_STAGES, M, MB, SEQ, D = 4, 8, 2, 32, 64
SEED = 0


def make_stage(s, device):
    """Stage ``s``'s params: pre-norm attention + MLP, drawn on ``device``
    from generator seed ``SEED + s``."""
    import torch
    from repro_torch.models.layers import (AttnDims, Init, init_attention,
                                           init_mlp, init_norm)
    init = Init.torch(torch.Generator(device).manual_seed(SEED + s), device)
    return {"ln1": init_norm(init, (), D),
            "attn": init_attention(init, (), D, AttnDims(4, 2, 16)),
            "ln2": init_norm(init, (), D), "mlp": init_mlp(init, (), D, 4 * D)}


def stage_fn(p, h):
    import torch
    from repro_torch.models.layers import (AttnDims, attention_apply,
                                           mlp_apply, rms_norm)
    pos = torch.arange(SEQ, device=h.device)[None].expand(h.shape[:2])
    h = h + attention_apply(p["attn"], rms_norm(p["ln1"], h),
                            dims=AttnDims(4, 2, 16), positions=pos,
                            causal=True)
    return h + mlp_apply(p["mlp"], rms_norm(p["ln2"], h))


def microbatches(device):
    import torch
    g = torch.Generator(device).manual_seed(SEED + 1000)
    return torch.randn((M, MB, SEQ, D), generator=g, device=device) * 0.1


def rank_main(rank, port, device_name):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.models.blocks import tree_map, tree_stack
    from repro_torch.runtime.pipeline import (link_counts, pipeline_apply,
                                              pipeline_ii,
                                              pipeline_reference)
    device = torch.device(device_name)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=S_STAGES)
    try:
        # the mesh's device type is the device's: a DTensor's shard lives
        # there (the group stays gloo, so the link is host-staged on a GPU)
        mesh = DeviceMesh(device.type, list(range(S_STAGES)),
                          mesh_dim_names=("stage",))
        tk.reset_launch_counts()
        own = make_stage(rank, device)
        params = tree_map(lambda x: DTensor.from_local(
            x[None], mesh, [Shard(0)], run_check=False), own)
        x = microbatches(device)
        y = pipeline_apply(mesh, stage_fn, params, x)
        every = [None] * S_STAGES
        dist.all_gather_object(every, y.cpu())
        same = all(torch.equal(e, every[0]) for e in every)
        if rank == 0:
            whole = tree_stack([make_stage(s, device)
                                for s in range(S_STAGES)])
            ref = pipeline_reference(stage_fn, whole, x)
            err = float((y - ref).abs().max())
            ii = pipeline_ii(M, S_STAGES)
            print(f"{S_STAGES}-stage transformer pipeline on a device ring: "
                  f"max|err| vs sequential = {err:.2e}")
            print(f"II model: {ii['slots']} slots for {M} microbatches, "
                  f"bubble {ii['bubble_fraction']:.1%}, "
                  f"II/output {ii['ii_per_output']:.3f} "
                  f"(paper: replication drives II -> 1)")
            print(json.dumps({"example": "pipeline_lm", "device": str(device),
                              "max_err": err, "every_rank_same_y": same,
                              "ii": ii, "link": dict(link_counts),
                              "launches": dict(tk.launch_counts)}),
                  flush=True)
            assert same, "the ranks returned different outputs"
            assert err < 5e-4
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                         "where there is none)")
    args = ap.parse_args(argv)
    import torch.multiprocessing as mp
    from repro_torch.core.vm import resolve_device
    device = resolve_device(args.device)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(rank_main, args=(free_port(), str(device)), nprocs=S_STAGES,
             join=True)


if __name__ == "__main__":
    main()
