#!/usr/bin/env python3
"""Read, on one GPU at the Zamba2 cell's own size, the numbers its limit
is set from, and time its hd-224 decode-attention variant.  One JSON line
a seed, or one for the kernel.

    python3 chipbench/tools/zamba2_control.py --seeds 1,2,3 [--faults]
    python3 chipbench/tools/zamba2_control.py --kernel

For each seed: ``program``, the served logit gap of the port's 256 served
tokens against the reference (the lower reading).  With ``--faults``,
the upper readings: ``control``, the token the float8 (e4m3 products)
reference puts first at each served position; and three faults planted
in the program, each read as the program is: ``adapter_dropped`` (site
1's adapter zeroed), ``norm_whole_row`` (the gated norm over all of
d_inner, not per group) and ``scale_hd`` (the logits scaled by hd^-0.5,
not (hd / 2)^-0.5).

``--kernel``: the variant's cold build, then at B 16, S 1280, KH 32, G 1,
hd 224 and positions 1024 and 1279 its error against the plain version
beside ``kernel.tolerance``, its median time over 30 launches warm and
cold (four copies of the caches in turn), the plain version's, and the
bound: the visible K and V rows, q and the output once at 3.35 TB/s.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CELL = "zamba2-7b-instruct.decode"
#: the cell's attention shape: B, S, KH, G, hd, and its positions
SHAPE, POSITIONS = (16, 1280, 32, 1, 224), (1024, 1279)


def _served(cell, seed, dev, cfg=None, edit=None):
    """The prompts and the tokens the program serves in one generation."""
    from chipbench.drivers import zamba2_decode as D
    t0 = time.perf_counter()
    prog = D.Program(cell, seed, dev, cfg=cfg, edit=edit)
    served = prog.generate(prog.G)
    prompts = prog.prompts
    prog.free()
    print(f"zamba2_control: seed {seed}: program "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return prompts, served


def readings(cell, seed, dev, faults: bool) -> dict:
    from chipbench.drivers import lm_decode as LD
    from chipbench.drivers import zamba2_decode as D

    def gap(prompts, served, by=None):
        t0 = time.perf_counter()
        g = LD.reference_gap(cell, seed, prompts, served, dev, by=by)
        print(f"zamba2_control: seed {seed}: reference "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        return g

    prompts, served = _served(cell, seed, dev)
    out = {"program": gap(prompts, served)}
    if not faults:
        return out
    out["control"] = gap(prompts, served, by="fp8")
    cfg = D.model_config(cell.config)
    planted = {
        "adapter_dropped": {"edit": lambda p: p["shared"]["sites"]
                            ["adapter"]["w"][1].zero_()},
        "norm_whole_row": {"cfg": dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, group_norm=False))},
        "scale_hd": {"cfg": dataclasses.replace(
            cfg, shared=dataclasses.replace(cfg.shared, attn_scale=None))}}
    for name, kw in planted.items():
        out[name] = gap(*_served(cell, seed, dev, **kw))
    return out


def _median_ms(fn, n: int, warmup: int = 3) -> float:
    import statistics
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    times = []
    for i in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel(dev) -> dict:
    import torch
    from chipbench.metrics import _arith
    from repro_torch.kernels.attn_decode import kernel as adk
    B, S, KH, G, hd = SHAPE
    scale = (hd / 2) ** -0.5
    t0 = time.perf_counter()
    adk.build_library(hd, torch.bfloat16, 1, verbose=True)
    out = {"shape": dict(zip("B S KH G hd".split(), SHAPE)),
           "build_s": time.perf_counter() - t0, "positions": []}
    gen = torch.Generator(dev).manual_seed(26)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)
    q = randn(B, 1, KH, G, hd)
    copies = [(randn(B, S, KH, hd), randn(B, S, KH, hd)) for _ in range(4)]
    ck, cv = copies[0]
    for pos in POSITIONS:
        adk.reset_launch_counts()
        got = adk.attn_decode(q, ck, cv, pos, None, scale)
        torch.cuda.synchronize()
        want = adk.attn_decode_plain(q, ck, cv, pos, None, scale)
        tol = adk.tolerance(want)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        _, n = adk.visible(S, pos, None)
        n_bytes = 2 * B * n * KH * hd * 2 + 2 * q.numel() * 2
        cold = _median_ms(lambda i: adk.attn_decode(
            q, *copies[i % len(copies)], pos, None, scale), 30)
        warm = _median_ms(lambda i: adk.attn_decode(q, ck, cv, pos, None,
                                                    scale), 30)
        plain = _median_ms(lambda i: adk.attn_decode_plain(
            q, ck, cv, pos, None, scale), 10, warmup=1)
        bound = 1e3 * n_bytes / _arith.PEAK_HBM_BYTES
        out["positions"].append({
            "pos": pos, "launches": dict(adk.launch_counts),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "atol": tol["atol"], "ms": cold, "warm_ms": warm,
            "bound_ms": bound, "share_of_bound": bound / cold,
            "bytes": n_bytes, "plain_ms": plain})
    return out


def main() -> int:
    import torch
    from chipbench.lib.spec import load_benchmark, resolve
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", default="")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--kernel", action="store_true")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("zamba2_control: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    if a.kernel:
        print(json.dumps({"kernel": kernel(dev),
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)
    cell = resolve(load_benchmark(ROOT), CELL, ROOT)
    for seed in [int(s) for s in a.seeds.split(",") if s]:
        print(json.dumps({"workload": CELL, "seed": seed,
                          **readings(cell, seed, dev, a.faults)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
