"""Quickstart on the PyTorch port: map a compute kernel onto the TM-FU
overlay and run it (``examples/quickstart.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/quickstart_torch.py                # GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Walks the paper's full flow on the 'gradient' kernel (Fig. 1 / Table I):
C-like source -> DFG -> ASAP schedule (+ bypass insertion) -> 32-bit
instruction encoding -> execution on the compile-once overlay executor
(the hand-written CUDA kernel on the GPU, the plain executor on the CPU),
plus the analytical area/II/context models.  The last line is a JSON
report: the error and the kernel launches.
"""

import argparse
import json

import numpy as np
import torch

from repro_torch.core import Overlay, build_dfg, compile_program, dfg_eval
from repro_torch.core.area import area_eslices, throughput_gops
from repro_torch.core.schedule import schedule
from repro_torch.kernels.tmfu import kernel as tk

SRC = """
d1 = m1 - m3
d2 = m2 - m3
d3 = m3 - m4
d4 = m3 - m5
s1 = d1 * d1
s2 = d2 * d2
s3 = d3 * d3
s4 = d4 * d4
a1 = s1 + s2
a2 = s3 + s4
out = a1 + a2
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                         "where there is none)")
    args = ap.parse_args(argv)
    dfg = build_dfg("gradient", ["m1", "m2", "m3", "m4", "m5"], SRC, ["out"])
    sch = schedule(dfg)
    print(f"DFG: {dfg.stats()}")
    print(f"schedule: {sch.n_fus} FUs, II={sch.ii} "
          f"(single-FU II={sch.single_fu_ii}, spatial FUs={sch.spatial_fus})")
    print(f"area: {area_eslices(sch.n_fus)} e-Slices "
          f"(spatial would need {area_eslices(sch.spatial_fus)})")
    print(f"throughput: {throughput_gops(dfg.n_ops, sch.ii):.2f} GOPS "
          f"@300MHz")
    kernel = compile_program(dfg)
    print(f"context: {kernel.program.context_bytes} B, "
          f"switch {kernel.program.context_switch_us():.3f} us @300MHz")
    print("\nfirst cycles of the pipeline schedule (Table I):")
    for cyc, acts in sch.cycle_trace(n_iters=1)[:12]:
        print(f"  cycle {cyc:3d}: "
              + "  ".join(f"FU{k}:{v}" for k, v in sorted(acts.items())))

    tk.reset_launch_counts()
    ov = Overlay(device=args.device)   # 'configure the FPGA' once
    ctx = ov.load(kernel)              # context switch: ~bytes, no compile
    rng = np.random.RandomState(0)
    xs = [rng.randn(1024).astype(np.float32) for _ in range(5)]
    (y,) = ov(ctx, xs)
    launches = dict(tk.launch_counts)
    ref = dfg_eval(dfg, {n: torch.from_numpy(v).to(ov.device)
                         for n, v in zip(dfg.inputs, xs)})["out"]
    err = float((y - ref).abs().max())
    print(f"\noverlay vs oracle max|err| = {err:.2e} over 1024 iterations")
    assert err < 1e-5
    print(json.dumps({"example": "quickstart", "device": str(ov.device),
                      "max_err": err, "launches": launches}))


if __name__ == "__main__":
    main()
