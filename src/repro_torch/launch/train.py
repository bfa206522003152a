"""Training launcher (the reference's ``launch/train.py``).

  python -m repro_torch.launch.train --arch deepseek-7b --smoke --steps 20
  python -m repro_torch.launch.train --arch mamba2-2.7b --smoke --steps 50 \
      --ckpt-dir /tmp/ck --ckpt-every 10 --simulate-failure-at 30

  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
      --arch deepseek-7b --smoke --steps 8 --device cpu \
      --ckpt-dir /tmp/ck --ckpt-every 4 --simulate-failure-at 6

Runs on the CUDA device unless ``--device cpu`` is given (it raises where
there is none), one rank per GPU.  The process group comes from
torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) where
it is set, else it is a one-rank group; NCCL on CUDA, gloo on the CPU.
Features exercised: params and optimizer state as DTensors on a (data,
model) mesh, remat'd stacks, AdamW updated in place, async checkpointing,
deterministic resumable data, simulated-failure restart (elastic re-mesh
onto the surviving half of the ranks, restore with the new placements),
optional int8 gradient compression.

The step loop itself lives in :func:`run_training` — an importable
generator shared by this CLI and the co-scheduled training tenant
(``launch.trainer_tenant.TrainingTenant``), so "training as a tenant"
runs the EXACT same per-step math as the standalone launcher.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.vm import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.distributed import checkpoint as C
from repro_torch.distributed.elastic import remesh, reshard_tree
from repro_torch.models import init_params
from repro_torch.models.blocks import tree_leaves, tree_map
from repro_torch.runtime import optim as O
from repro_torch.runtime import sharding as S
from repro_torch.runtime.steps import decorate_batch, make_train_step

__all__ = ["main", "run_training"]


def _device_of(params, device):
    """The run's device: the params' where they are given (``device``
    must then agree), else ``device`` (None: the CUDA device)."""
    if params is None:
        return resolve_device(device)
    have = tree_leaves(params)[0].device
    if device is not None and resolve_device(device) != have:
        raise ValueError(f"params are on {have}, device={device!r}")
    return have


def run_training(cfg, oc, dc, *, steps: int, yield_every: int = 1,
                 corpus=None, params=None, opt_state=None,
                 start_step: int = 0, compress_grads: bool = False,
                 mixed: bool = False, donate: bool = False, step_fn=None,
                 device=None):
    """Generator over training steps: the importable step-slicing loop.

    Runs ``make_train_step(cfg, oc, ...)`` from ``start_step`` to
    ``steps``, yielding a RECORD at every yield point — after every
    step by default, after every ``yield_every``-th step otherwise.
    Each record carries::

        {"step", "loss", "grad_norm", "lr", "wall_s",   # floats
         "window",              # [(step, loss, grad_norm, lr), ...]
                                # per-step floats since the last yield
         "params", "opt_state", # the post-step state (live refs)
         "cursor"}              # corpus cursor for step+1 (resume token)

    The yield points ARE the preempt/resume contract: a consumer that
    stops iterating between records (the training tenant preempting for
    latency traffic) holds a complete, consistent checkpoint — params,
    optimizer moments, error-feedback ``ef`` (inside ``opt_state`` when
    ``compress_grads``), and the data-pipeline cursor all advance
    atomically per step, never mid-step.  Resuming is re-entering
    ``run_training`` with the yielded ``params``/``opt_state`` and
    ``start_step = record["step"] + 1`` on the same ``dc`` seed — or
    simply continuing to iterate the SAME generator (what the tenant
    does), which is exactly-once by construction.

    ``params``/``opt_state`` default to the standard seed-0 init on
    ``device`` (None: the CUDA device; given params fix the device);
    ``step_fn`` defaults to a fresh ``make_train_step``.  The corpus's
    host batches are moved to the device.  ``donate=True`` updates
    params/opt state in place for the CLI's memory profile — then only
    the LATEST record's state refs are valid (they are the same objects
    at every record).
    """
    if steps <= start_step:
        return
    if yield_every < 1:
        raise ValueError(f"yield_every must be >= 1, got {yield_every}")
    device = _device_of(params, device)
    corpus = corpus if corpus is not None else SyntheticCorpus(dc)
    if params is None:
        params = init_params(cfg, torch.Generator(device).manual_seed(0),
                             device=device)
    if opt_state is None:
        opt_state = (O.init_opt_mixed(params) if mixed
                     else O.init_opt(params))
    if step_fn is None:
        step_fn = make_train_step(cfg, oc, compress_grads=compress_grads,
                                  mixed=mixed, donate=donate)
    window: list[tuple] = []
    for step in range(start_step, steps):
        batch = corpus.batch(step)
        batch["tokens"] = batch["tokens"].to(device)
        batch = decorate_batch(cfg, dc, batch)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])     # blocks: the step is DONE here
        wall = time.perf_counter() - t0
        window.append((step, loss, float(metrics["grad_norm"]),
                       float(metrics["lr"])))
        if (step + 1 - start_step) % yield_every == 0 or step + 1 == steps:
            yield {"step": step, "loss": loss,
                   "grad_norm": window[-1][2], "lr": window[-1][3],
                   "wall_s": wall, "window": window,
                   "params": params, "opt_state": opt_state,
                   "cursor": corpus.cursor(step + 1)}
            window = []


def _shapes(tree):
    """The tree's shapes and dtypes as meta tensors (a DTensor's global
    shape)."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), tree)


def _process_group(device: torch.device):
    """Join torchrun's process group (its environment names the world),
    or make a one-rank group: NCCL on CUDA, gloo on the CPU.  Under
    torchrun a rank takes the GPU of its ``LOCAL_RANK``; a one-rank group
    keeps ``device``.  Returns (rank, world, device)."""
    import torch.distributed as dist

    backend = "nccl" if device.type == "cuda" else "gloo"
    torchrun = "WORLD_SIZE" in os.environ
    if device.type == "cuda":
        if torchrun:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if torchrun:
        dist.init_process_group(backend, init_method="env://",
                                device_id=device if backend == "nccl"
                                else None)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_rank(), dist.get_world_size(), device


def main(argv=None):
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--simulate-failure-at", type=int, default=None,
                    help="drop ranks + re-mesh + restore at this step")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--trace-out", default=None,
                    help="write the exact {steps, losses} trace as JSON "
                         "(the CLI-vs-library differential test reads it)")
    ap.add_argument("--device", default=None,
                    help="torch device type (default: CUDA, one GPU a "
                         "rank; raises where there is none)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    rank, world, device = _process_group(resolve_device(args.device))
    try:
        return _train(args, cfg, rank, world, device)
    finally:
        dist.destroy_process_group()


def _train(args, cfg, rank, world, device):
    import torch.distributed as dist

    say = print if rank == 0 else (lambda *a, **k: None)
    ranks = list(range(world))
    mesh = remesh(ranks, model_parallel=min(
        world, 16 if not args.smoke else 1), device_type=device.type)
    ax = S.for_mesh(mesh)
    say(f"mesh: {S.mesh_axes(mesh)} device: {device} arch: {cfg.name} "
        f"params~{cfg.param_count():,}")

    oc = O.OptConfig(lr=args.lr, total_steps=max(args.steps, 10),
                     warmup_steps=max(2, args.steps // 20))
    dc = DataConfig(global_batch=args.batch, seq_len=args.seq,
                    vocab=cfg.vocab)
    corpus = SyntheticCorpus(dc)

    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         device=device)
    opt_state = O.init_opt(params)
    start_step = 0
    ckpt = C.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if args.resume and args.ckpt_dir and C.list_steps(args.ckpt_dir):
        like = _shapes((params, opt_state))
        params = opt_state = None
        (params, opt_state), start_step, extra = C.restore(
            args.ckpt_dir, like, device=device)
        say(f"resumed from step {start_step}")

    like_params = _shapes(params)

    def _pspec(mesh, ax):
        return S.sanitize(S.param_shardings(cfg, mesh, ax), like_params,
                          mesh)

    def _reshard(params, opt_state, mesh, ax):
        # what the reference's re-shard keeps of the optimizer state
        pspec = _pspec(mesh, ax)
        params = reshard_tree(params, pspec, mesh)
        opt_state = {"m": reshard_tree(opt_state["m"], pspec, mesh),
                     "v": reshard_tree(opt_state["v"], pspec, mesh),
                     "count": opt_state["count"]}
        return params, opt_state

    def _step_fn(mesh, ax):
        step = make_train_step(cfg, oc, compress_grads=args.compress_grads,
                               donate=True)
        bspec = S.batch_shardings(cfg, mesh, args.batch, "train", ax)

        def placed(params, opt_state, batch):
            return step(params, opt_state, reshard_tree(
                batch, {k: bspec[k] for k in batch}, mesh))

        return placed

    params, opt_state = _reshard(params, opt_state, mesh, ax)
    step_fn = _step_fn(mesh, ax)

    tokens_per_step = args.batch * args.seq
    t_hist = []
    trace = {"steps": [], "losses": []}
    fail_at = args.simulate_failure_at
    while mesh is not None and start_step < args.steps:
        last_step = None
        for rec in run_training(cfg, oc, dc, steps=args.steps,
                                corpus=corpus, params=params,
                                opt_state=opt_state,
                                start_step=start_step, step_fn=step_fn):
            step, loss = rec["step"], rec["loss"]
            params, opt_state = rec["params"], rec["opt_state"]
            last_step = step
            t_hist.append(rec["wall_s"])
            trace["steps"].append(step)
            trace["losses"].append(loss)
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:8.4f} "
                    f"gnorm {rec['grad_norm']:8.3f} "
                    f"lr {rec['lr']:.2e} "
                    f"{tokens_per_step / rec['wall_s']:,.0f} tok/s")
            if not np.isfinite(loss):
                say("NaN/inf loss — aborting")
                return 1
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, (params, opt_state),
                                extra=rec["cursor"])
            if fail_at is not None and step + 1 == fail_at:
                break           # "device loss" before step fail_at runs
        if last_step is None or last_step + 1 >= args.steps:
            break
        if fail_at is not None and last_step + 1 == fail_at:
            say(f"[elastic] simulating failure at step {fail_at}: "
                f"dropping half the ranks + restoring checkpoint")
            if ckpt is None:
                raise ValueError("--simulate-failure-at needs --ckpt-dir")
            ckpt.wait()
            dist.barrier()      # rank 0's write is on disk for every rank
            # every rank joins the new mesh's groups; the dropped ranks
            # get None and leave the loop
            mesh = remesh(ranks[: max(1, world // 2)], model_parallel=1,
                          device_type=device.type)
            like = _shapes((params, opt_state))
            params = opt_state = rec = None     # the lost state, freed
            if mesh is None:
                break
            ax = S.for_mesh(mesh)
            pspec = _pspec(mesh, ax)
            (params, opt_state), rstep, extra = C.restore(
                args.ckpt_dir, like,
                shardings=(pspec, {"m": pspec, "v": pspec, "count": None}),
                mesh=mesh, device=device)
            say(f"[elastic] re-meshed onto {S.mesh_axes(mesh)}, restored "
                f"step {rstep}")
            step_fn = _step_fn(mesh, ax)
            start_step = rstep
            fail_at = None
        else:
            start_step = last_step + 1
    if ckpt and mesh is not None:
        ckpt.save_async(args.steps, (params, opt_state),
                        extra=corpus.cursor(args.steps))
        ckpt.wait()
    if args.trace_out and rank == 0:
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
    dist.barrier()              # the dropped ranks meet the survivors
    med = float(np.median(t_hist)) if t_hist else 0.0
    say(f"done: median step {med * 1e3:.1f} ms, "
        f"{tokens_per_step / med:,.0f} tok/s" if med else "done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
