"""End-to-end training run on the PyTorch port
(``examples/train_e2e.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/train_e2e_torch.py        # ~10M, 200 steps
    PYTHONPATH=src python examples/train_e2e_torch.py --preset 100m --steps 300
    PYTHONPATH=src python examples/train_e2e_torch.py --device cpu --steps 40

Drives the launcher's pieces (``repro_torch.launch.train.run_training``):
remat'd stacks, AdamW+cosine updated in place, async checkpoints,
deterministic resumable data.  The 100m preset is the "~100M model for a
few hundred steps"; the default preset keeps CPU wall-time sane and
exercises the identical code path.  The last line is a JSON report: ms a
step, tokens/s, peak device memory (CUDA only) and the kernel launches.
"""

import argparse
import json
import os
import statistics
import tempfile
import time


def build_preset(name: str):
    from repro_torch.models import ModelConfig, dense_stacks

    if name == "10m":
        return ModelConfig(
            name="e2e-10m", d_model=256, n_heads=8, n_kv_heads=4,
            d_ff=1024, vocab=8192, head_dim=32,
            stacks=dense_stacks(4), full_attention=True)
    if name == "100m":
        return ModelConfig(
            name="e2e-100m", d_model=768, n_heads=12, n_kv_heads=12,
            d_ff=3072, vocab=32768, head_dim=64,
            stacks=dense_stacks(12), full_attention=True)
    raise SystemExit(f"unknown preset {name}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=["10m", "100m"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                         "where there is none)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core.vm import resolve_device
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.distributed import checkpoint as C
    from repro_torch.kernels.tmfu import kernel as tk
    from repro_torch.launch.train import run_training
    from repro_torch.runtime import optim as O

    device = resolve_device(args.device)
    cfg = build_preset(args.preset)
    print(f"{cfg.name}: ~{cfg.param_count():,} params")
    oc = O.OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    dc = DataConfig(global_batch=args.batch, seq_len=args.seq,
                    vocab=cfg.vocab)
    corpus = SyntheticCorpus(dc)
    ckpt = C.AsyncCheckpointer(args.ckpt_dir)
    tk.reset_launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses, walls = [], []
    t0 = time.perf_counter()
    for rec in run_training(cfg, oc, dc, steps=args.steps, corpus=corpus,
                            donate=True, device=device):
        step = rec["step"]
        losses.append(rec["loss"])
        walls.append(rec["wall_s"])
        if step % 20 == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            tps = (step + 1) * args.batch * args.seq / dt
            print(f"step {step:4d} loss {losses[-1]:7.4f} "
                  f"({tps:,.0f} tok/s)")
        if (step + 1) % 100 == 0:
            ckpt.save_async(step + 1, (rec["params"], rec["opt_state"]),
                            extra=rec["cursor"])
    ckpt.wait()
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.2 else 'check hyperparams'})")
    assert last < first, "training diverged"
    ms = statistics.median(walls[1:] or walls) * 1e3
    print(json.dumps({
        "example": "train_e2e", "preset": args.preset, "device": str(device),
        "params": cfg.param_count(), "steps": args.steps,
        "batch": args.batch, "seq": args.seq,
        "loss_first10": float(first), "loss_last10": float(last),
        "ms_per_step": ms, "tokens_per_s": args.batch * args.seq / ms * 1e3,
        "max_memory_allocated_gb": (
            torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None),
        "launches": dict(tk.launch_counts)}))


if __name__ == "__main__":
    main()
