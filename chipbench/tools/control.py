#!/usr/bin/env python3
"""Read, on one GPU and at a cell's own size, the numbers its limits are
set from: for each seed, what the program gives against the reference
(the lower reading), what the control gives (the reference in the
precision below the configuration's, put in the program's place: the
upper reading), and what each fault the cell can have gives.  One JSON
line a seed.

    python3 chipbench/tools/control.py --workload deepseek-7b.train \\
        --seeds 1,2,3

The control and the faults, by the cell's driver:

* ``lm_train``: control, the reference with its products in float8
  e4m3; fault ``half_batch``, the program fed half of each batch (its
  loss the mean over the rest); a step that returns its state unchanged
  reads 1 on ``change_norm_gap`` by that number's definition.
* ``lm_decode``: control, the token the float8 reference puts first at
  each served position; fault ``token_altered``, one served token of a
  checked row replaced by the next id.
* ``overlay_*``: control, the reference evaluated in bfloat16; faults
  ``answer_altered`` (one lane one ulp off) and ``half_lanes`` (the
  second half of a request's lanes never written: zeros).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def lm_train(cell, seed, dev) -> dict:
    from chipbench.drivers import lm_train as D
    prog = D.Program(cell, seed, dev)
    got, tokens = prog.readings, prog.followed_tokens(
        cell.traffic["reference_steps"])
    prog.free()
    del prog
    half = D.Program(cell, seed, dev, feed=lambda b: {
        "tokens": b["tokens"][:b["tokens"].shape[0] // 2]})
    half_got = half.readings
    half.free()
    del half
    want = D.reference(cell, seed, tokens, dev)
    ctl = D.reference(cell, seed, tokens, dev, mm="fp8")
    return {"program": D.readings(got, want),
            "control": D.readings(ctl, want),
            "half_batch": D.readings(half_got, want),
            "loss": {"program": got["loss"], "reference": want["loss"],
                     "control": ctl["loss"]}}


def lm_decode(cell, seed, dev) -> dict:
    from chipbench.drivers import lm_decode as D
    prog = D.Program(cell, seed, dev)
    served = prog.generate(prog.G)
    prompts = prog.prompts
    prog.free()
    del prog
    altered = served.clone()
    row, pos = D.check_rows(cell, seed)[0], served.shape[1] // 2
    altered[row, pos] = (altered[row, pos] + 1) % cell.config["vocab_size"]
    return {"program": D.reference_gap(cell, seed, prompts, served, dev),
            "control": D.reference_gap(cell, seed, prompts, served, dev,
                                       by="fp8"),
            "token_altered": D.reference_gap(cell, seed, prompts, altered,
                                             dev)}


def overlay(cell, seed, dev) -> dict:
    import numpy as np
    from chipbench.drivers import overlay_common as C
    from chipbench.lib.spec import load_module
    ref = load_module(cell.reference_path)
    cfg, tr = cell.config, cell.traffic
    lanes = tr.get("lanes", tr.get("lanes_max"))
    pools = C.input_pools(cfg, seed, tr["input_sets_per_kernel"], lanes)
    out = {"control": 0, "answer_altered": 0, "half_lanes": 0}
    for k, name in enumerate(cfg["kernel_order"]):
        for xs in pools[k]:
            want = ref.evaluate(cfg["kernels"][name], xs)
            ctl = ref.evaluate(cfg["kernels"][name], xs, ref.to_bfloat16)
            alt = [w.copy() for w in want]
            alt[0][lanes // 3] = np.nextafter(alt[0][lanes // 3], np.inf)
            half = [w.copy() for w in want]
            half[0][lanes // 2:] = 0
            for key, got in (("control", ctl), ("answer_altered", alt),
                             ("half_lanes", half)):
                out[key] = max(out[key], max(
                    ref.ulp_distance(g, w) for g, w in zip(got, want)))
    return out


def main() -> int:
    import torch
    from chipbench.lib.spec import load_benchmark, resolve
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    cell = resolve(load_benchmark(ROOT), a.workload, ROOT)
    kind = cell.traffic["driver"]
    read = {"lm_train": lm_train, "lm_decode": lm_decode}.get(kind, overlay)
    for seed in [int(s) for s in a.seeds.split(",")]:
        print(json.dumps({"workload": a.workload, "seed": seed,
                          **read(cell, seed, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
