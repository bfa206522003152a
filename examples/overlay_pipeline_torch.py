"""Context-switching the whole benchmark suite on ONE overlay executor,
on the PyTorch port (``examples/overlay_pipeline.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/overlay_pipeline_torch.py          # GPU
    PYTHONPATH=src python examples/overlay_pipeline_torch.py --device cpu

Compiles the overlay once, then streams all 8 paper kernels through it
back-to-back — each kernel change is a pure data swap (the paper's 0.27us
daisy-chain analogue).  There is one executor: the hand-written CUDA TMFU
kernel on the GPU, the plain executor on the CPU (the reference's
``--pallas`` switch has no counterpart).  The last line is a JSON report:
each kernel's error against the DFG oracle and the kernel launches.
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import Overlay, compile_program, dfg_eval
from repro_torch.core.paper_bench import BENCH_NAMES, benchmark
from repro_torch.kernels.tmfu import kernel as tk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                         "where there is none)")
    args = ap.parse_args(argv)
    ov = Overlay(device=args.device)
    rng = np.random.RandomState(0)
    kernels = {n: compile_program(benchmark(n)) for n in BENCH_NAMES}
    print(f"device={ov.device}  batch={args.batch}")
    print("kernel,ii,fus,ctx_bytes,swap+run_ms,max_err")
    tk.reset_launch_counts()
    errs = {}
    for name, k in kernels.items():
        xs = [rng.uniform(-1, 1, args.batch).astype(np.float32)
              for _ in k.dfg.inputs]
        t0 = time.perf_counter()
        ctx = ov.load(k)               # context switch
        ys = ov(ctx, xs)               # stream the batch through
        ys[0].cpu()
        dt = (time.perf_counter() - t0) * 1e3
        ref = dfg_eval(k.dfg, {n: torch.from_numpy(v).to(ov.device)
                               for n, v in zip(k.dfg.inputs, xs)})
        err = max(float((y - ref[o]).abs().max())
                  for y, o in zip(ys, k.dfg.outputs))
        errs[name] = err
        print(f"{name},{k.sched.ii},{k.sched.n_fus},"
              f"{k.program.context_bytes},{dt:.1f},{err:.2e}")
        assert err < 1e-4
    print(json.dumps({"example": "overlay_pipeline", "device": str(ov.device),
                      "max_err": errs, "launches": dict(tk.launch_counts)}))


if __name__ == "__main__":
    main()
