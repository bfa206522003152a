"""The paper's benchmark set (Table II) + the 'gradient' worked example.

``chebyshev`` and ``gradient`` are written out as kernel source (frontend
path); the other seven come from frozen DFGs reconstructed to match every
published Table II characteristic under the paper's scheduling model (the
paper cites the suites [4],[13] but does not print the kernels —
dev/search_benches.py documents the reconstruction).
"""

from __future__ import annotations

from repro_torch.core.bench_data import BENCH_NODES
from repro_torch.core.dfg import DFG, Node, Op
from repro_torch.core.frontend import build_dfg

GRADIENT_SRC = """
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

CHEBYSHEV_SRC = """
t1 = x * x
t2 = 16 * t1
t3 = t2 - 20
t4 = t1 * t3
t5 = t4 + 5
t6 = t1 * t5
y = t6 * t6
"""


def gradient() -> DFG:
    """Fig. 1 medical-imaging 'gradient' kernel (5 in, 11 ops, depth 4)."""
    return build_dfg("gradient", ["m1", "m2", "m3", "m4", "m5"],
                     GRADIENT_SRC, ["out"])


def chebyshev() -> DFG:
    return build_dfg("chebyshev", ["x"], CHEBYSHEV_SRC, ["y"])


def _from_frozen(name: str) -> DFG:
    spec = BENCH_NODES[name]
    nodes = [Node(n, Op(op), tuple(args), imm)
             for (n, op, args, imm) in spec["nodes"]]
    return DFG.build(name, spec["inputs"], nodes, spec["outputs"])


#: Table II benchmark order
BENCH_NAMES = ("chebyshev", "sgfilter", "mibench", "qspline",
               "poly5", "poly6", "poly7", "poly8")


def benchmark(name: str) -> DFG:
    if name == "chebyshev":
        return chebyshev()
    if name == "gradient":
        return gradient()
    return _from_frozen(name)


def all_benchmarks() -> dict[str, DFG]:
    return {n: benchmark(n) for n in BENCH_NAMES}
