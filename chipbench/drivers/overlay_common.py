"""What an overlay driver takes from its configuration: the kernels built
from the node lists, the engine, the input pools drawn from the seed, the
window's counters, and the comparison of every delivered output with the
plain reference."""

from __future__ import annotations

import time

import numpy as np

from chipbench.lib.record import seed_int
from chipbench.metrics import _arith

#: how long after the window a request may still be delivered
LATE_S = 60.0
#: the inputs' range, as ``chip_smoke.py`` draws them: every kernel's
#: outputs stay finite
INPUT_RANGE = (-2.0, 2.0)


def build_kernels(config: dict) -> list:
    """The configuration's kernels, in ``kernel_order``, compiled by the
    port (DFG -> schedule -> context image)."""
    from repro_torch.core.dfg import DFG, Node, Op
    from repro_torch.core.overlay import compile_program
    out = []
    for name in config["kernel_order"]:
        k = config["kernels"][name]
        nodes = [Node(n, Op[op], tuple(args), imm)
                 for n, op, args, imm in k["nodes"]]
        out.append(compile_program(DFG.build(name, k["inputs"], nodes,
                                             k["outputs"])))
    return out


def make_server(config: dict, device):
    """The configuration's ``OverlayServer``."""
    import torch
    from repro_torch.launch.serve import OverlayServer
    e = config["engine"]
    return OverlayServer(bank_capacity=e["bank_capacity"], tile=e["tile"],
                         round_kernels=e["round_kernels"],
                         quantum_tiles=e["quantum_tiles"],
                         max_inflight=e["max_inflight"],
                         dtype=getattr(torch, e["dtype"]), device=device)


def input_pools(config: dict, seed: int, sets: int, lanes: int) -> list:
    """``pools[k][s]``: input set ``s`` of kernel ``k``, one float32 array
    of ``lanes`` per primary input."""
    rng = np.random.default_rng(seed_int(seed, 1))
    lo, hi = INPUT_RANGE
    return [[[rng.uniform(lo, hi, lanes).astype(np.float32)
              for _ in config["kernels"][name]["inputs"]]
             for _ in range(sets)]
            for name in config["kernel_order"]]


def engine_counters(stats: dict) -> dict:
    walls = stats["stage_walls"]
    return {"rounds": stats["rounds"], "requests": stats["requests"],
            "arena_allocations": stats["arena"]["allocations"],
            "hits": stats["hits"], "loads": stats["loads"],
            "evictions": stats["evictions"],
            "host_s": walls["plan_s"] + walls["assemble_s"]
            + walls["collect_s"]}


def window_counters(before: dict, after: dict) -> dict:
    a, b = engine_counters(before), engine_counters(after)
    return {k: b[k] - a[k] for k in a}


def compare(ref_mod, config: dict, pools: list, delivered: list,
            rounding=None) -> int:
    """The largest ulp distance between each delivered output and the
    reference's output for the same inputs; ``delivered`` holds
    ``(kernel, set, lanes, outputs)``.  Each (kernel, set) is evaluated
    once, over the pool's full lanes; a request's lanes are a prefix.
    ``ref_mod`` is the configuration's reference module."""
    want: dict = {}
    worst = 0
    for k, s, lanes, outs in delivered:
        if (k, s) not in want:
            name = config["kernel_order"][k]
            want[k, s] = ref_mod.evaluate(config["kernels"][name],
                                          pools[k][s], rounding)
        ref = want[k, s]
        if len(outs) != len(ref):
            return 1 << 32
        for got, w in zip(outs, ref):
            w = w[:lanes]
            g = np.asarray(got)
            if g.shape == w.shape and g.tobytes() == w.tobytes():
                continue
            worst = max(worst, ref_mod.ulp_distance(g, w))
    return worst


def request_bytes(config: dict, k: int, lanes: int) -> float:
    name = config["kernel_order"][k]
    kern = config["kernels"][name]
    return _arith.dfg_request_bytes(len(kern["inputs"]),
                                    len(kern["outputs"]), lanes,
                                    config["engine"]["tile"])


def context_bytes(config: dict, kernels_used) -> float:
    return sum(_arith.dfg_context_bytes(
        len(config["kernels"][config["kernel_order"][k]]["nodes"]))
        for k in set(kernels_used))


def now() -> float:
    return time.perf_counter()
