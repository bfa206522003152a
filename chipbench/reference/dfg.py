"""Plain NumPy evaluation of a feed-forward DFG node list.

A kernel is ``{"inputs": [...], "nodes": [[name, op, args, imm], ...],
"outputs": [...]}`` with the nodes in an order where every argument is
defined first.  Each node applies one operation of the overlay's
DSP-expressible set to whole lanes, rounded to the element type after
every operation, as the paper's 32-bit datapath does.  Nothing here
comes from the program under test.
"""

from __future__ import annotations

import numpy as np

OPS = {
    "BYP": lambda a, b, k: a,
    "ADD": lambda a, b, k: a + b,
    "SUB": lambda a, b, k: a - b,
    "MUL": lambda a, b, k: a * b,
    "ADDC": lambda a, b, k: a + k,
    "SUBC": lambda a, b, k: a - k,
    "RSUBC": lambda a, b, k: k - a,
    "MULC": lambda a, b, k: a * k,
    "SQR": lambda a, b, k: a * a,
    "MAX": lambda a, b, k: np.maximum(a, b),
    "MIN": lambda a, b, k: np.minimum(a, b),
    "ABS": lambda a, b, k: np.abs(a),
    "NEG": lambda a, b, k: -a,
}


def to_bfloat16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    kept in float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = bits.astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    out = (rounded & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x), x, out)


def evaluate(kernel: dict, inputs, rounding=None) -> list:
    """The kernel's outputs for ``inputs`` (one float32 array of lanes per
    primary input).  ``rounding`` is applied to the inputs and to every
    node's result (``to_bfloat16`` for the control); None keeps float32."""
    rnd = rounding or (lambda v: v)
    vals = {n: rnd(np.asarray(x, dtype=np.float32))
            for n, x in zip(kernel["inputs"], inputs)}
    for name, op, args, imm in kernel["nodes"]:
        a = vals[args[0]]
        b = vals[args[1]] if len(args) > 1 else a
        k = np.float32(0 if imm is None else imm)
        vals[name] = rnd(OPS[op](a, b, k).astype(np.float32))
    return [vals[o] for o in kernel["outputs"]]


def ulp_distance(got, want) -> int:
    """The largest distance in float32 units of the last place between
    two arrays of equal shape (``0 == -0``; NaN against a number, or a
    length that differs, counts as the widest distance)."""
    g = np.ascontiguousarray(got, dtype=np.float32)
    w = np.ascontiguousarray(want, dtype=np.float32)
    if g.shape != w.shape:
        return 1 << 32
    gi = g.view(np.int32).astype(np.int64)
    wi = w.view(np.int32).astype(np.int64)
    # float order as integers: negatives mirrored below zero, -0 -> 0
    gi = np.where(gi < 0, -(gi & 0x7FFFFFFF), gi)
    wi = np.where(wi < 0, -(wi & 0x7FFFFFFF), wi)
    d = np.abs(gi - wi)
    nan = np.isnan(g) != np.isnan(w)
    if nan.any():
        return 1 << 32
    both_nan = np.isnan(g) & np.isnan(w)
    return int(np.where(both_nan, 0, d).max(initial=0))
