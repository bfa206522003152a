"""Frozen arithmetic of the per-layer metrics: the chip's peaks and the
operations and bytes a piece of work needs, computed from its shapes.

Nothing here reads the program, so a later change to the port cannot
move a bound.  The dense-block FLOPs are a copy of the closed form of the
JAX package's ``benchmarks/analytic.py`` (``_per_block_flops``, the
attention-and-gated-MLP branch) as ``chip_smoke.py::block_flops`` copied
it: per query token, the q/k/v/o projections, ``4 H hd ctx`` for scores
and AV over ``ctx`` keys, and ``6 D d_ff`` for the gated MLP.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, data sheet, dense: bf16 tensor-core FLOP/s
PEAK_BF16_FLOPS = 989e12
#: NVIDIA H100 SXM, data sheet: HBM3 bytes/s
PEAK_HBM_BYTES = 3.35e12
#: bytes of one overlay datum (the float32 datapath) and of a context id
WORD = 4
#: bytes of a bf16 element
BF16 = 2


# ------------------------------------------------------------------ overlay
def dfg_request_bytes(n_inputs: int, n_outputs: int, lanes: int,
                      tile: int) -> float:
    """Bytes one request needs moved: every input lane read once, every
    output lane written once, and one context id a tile of lanes."""
    return WORD * (n_inputs + n_outputs) * lanes + WORD * lanes / tile


def dfg_context_bytes(n_nodes: int) -> int:
    """Bytes of one context: a 32-bit instruction word a DFG node."""
    return WORD * n_nodes


# ---------------------------------------------------------------- dense LM
def dense_block_flops(d_model: int, n_heads: int, n_kv_heads: int,
                      head_dim: int, d_ff: int, ctx: float) -> float:
    """Forward FLOPs of one query token through one attention + gated-MLP
    block over ``ctx`` keys."""
    D, H, KH, hd = d_model, n_heads, n_kv_heads, head_dim
    f = 2 * D * (H + 2 * KH) * hd + 2 * H * hd * D
    f += 4 * H * hd * ctx
    f += 6 * D * d_ff
    return f


def _block(dims: dict, ctx: float) -> float:
    return dense_block_flops(dims["d_model"], dims["n_heads"],
                             dims["n_kv_heads"], dims["head_dim"],
                             dims["d_ff"], ctx)


def train_step_flops(dims: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` rows of ``seq``
    tokens: the forward over ``seq - 1`` positions (the last token is
    only a target), attention over the causal average of ``seq / 2``
    keys, and the head, times 3 (forward, and backward twice).  The
    recompute of rematerialisation is not counted: it is not the
    model's work."""
    fwd = dims["n_layers"] * _block(dims, seq / 2) \
        + 2 * dims["d_model"] * dims["vocab"]
    return 3 * fwd * batch * (seq - 1)


def decode_step_flops(dims: dict, batch: int, pos: int) -> float:
    """FLOPs of one decode step writing position ``pos``: every sequence's
    new token through every block over ``pos + 1`` keys, and the head."""
    per_token = dims["n_layers"] * _block(dims, pos + 1) \
        + 2 * dims["d_model"] * dims["vocab"]
    return batch * per_token


def dense_weight_elements(dims: dict) -> int:
    """Elements of the weights a decode step reads whole: every block's
    projections, MLP and two norms, the final norm and the head."""
    D, H, KH, hd, F = (dims["d_model"], dims["n_heads"], dims["n_kv_heads"],
                       dims["head_dim"], dims["d_ff"])
    per_layer = D * (H + 2 * KH) * hd + H * hd * D + 3 * D * F + 2 * D
    return dims["n_layers"] * per_layer + D + D * dims["vocab"]


def decode_step_bytes(dims: dict, batch: int, pos: int) -> float:
    """Bytes one decode step writing position ``pos`` needs moved: the
    weights in bf16 read once, each sequence's embedding row, the bf16
    cache of positions ``0..pos-1`` read once and the new K and V
    written once."""
    L, KH, hd, D = (dims["n_layers"], dims["n_kv_heads"], dims["head_dim"],
                    dims["d_model"])
    weights = BF16 * (dense_weight_elements(dims) + batch * D)
    cache_read = BF16 * 2 * L * batch * pos * KH * hd
    cache_write = BF16 * 2 * L * batch * KH * hd
    return weights + cache_read + cache_write
