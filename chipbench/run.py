#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the GPU it is started on.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (weights and inputs made from ``--seed``, every shape the cell
uses warmed up) is timed from process start; then the window runs for
``--seconds``; then what the window produced is compared with the plain
reference.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` (with ``cpu_core``, the core the run
kept to), with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number beside its limit, also printed as the
last lines of standard error.

Exits non-zero and prints no result where there is no CUDA device (or
fewer than the cell asks for), where a file the cell needs is missing,
and where JAX or the JAX package was loaded into this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: modules that must not be in this process once the window has closed,
#: compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: which of the cores the process may use it keeps to (see ``pin_cpu``)
CORE_INDEX = 2
#: build and kernel caches, at fixed paths inside the checkout, so that
#: only a cell's first run in a checkout builds anything
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".chipbench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".chipbench_cache/triton"}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell, args, device):
    """Set-up, window and comparison of one cell on ``device``: the
    driver that the cell's traffic names fills the record."""
    from chipbench.lib.record import Record
    from chipbench.lib.spec import load_module
    rec = Record(seed=args.seed, seconds=args.seconds,
                 traced=bool(args.trace), t_start=T_START, device=device)
    load_module(cell.driver_path).run(cell, rec)
    return rec


def pin_cpu():
    """Keep the process on one core, the third of those it may use (core 2
    where it may use all): the overlay cell is bound by the host, and on
    four cores its runs spread by 19 % (interquartile over the median),
    on one by 6 %.  Returns the core, or None where the system cannot
    pin a process."""
    if not hasattr(os, "sched_setaffinity"):
        return None
    cores = sorted(os.sched_getaffinity(0))
    core = cores[min(CORE_INDEX, len(cores) - 1)]
    os.sched_setaffinity(0, {core})
    return core


def finish(cell, rec, cpu_core) -> int:
    """Read every metric, then look for JAX in the process, then print the
    result: a reader loaded for the result line is looked at too."""
    from chipbench.lib.record import emit, result
    res = result(cell, rec, cpu_core)
    found = forbidden_modules()
    if found:
        print(f"chipbench: the run loaded {found}; the port must run "
              "without JAX", file=sys.stderr)
        return 4
    emit(res)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    cpu_core = pin_cpu()
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from chipbench.lib.spec import SpecError, load_benchmark, resolve
    try:
        cell = resolve(load_benchmark(ROOT), args.workload, ROOT)
    except SpecError as e:
        print(f"chipbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chipbench: no CUDA device; the benchmark runs on the GPU "
              "only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"chipbench: {cell.name} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = run_cell(cell, args, device)
    return finish(cell, rec, cpu_core)


if __name__ == "__main__":
    sys.exit(main())
