"""Frozen arithmetic of the Zamba2 cell's per-layer metrics: the
operations and bytes a decode step needs, from the sizes of
``reference/zamba2.dims``.  Nothing here reads the program.

FLOPs are the model's (two a multiply-add): each Mamba layer's in- and
out-projections, its depthwise convolution, and its SSM step (``5 H P N``:
the state's decay and input products and their sum, then ``C . h``); each
site's shared block counted at that site (q, k, v from ``2 D``, o,
scores and AV over ``ctx`` keys, the gated MLP, the adapter and the
site's ``linear``); the tied head.  Norms, gates and activations are not
counted.

Bytes count what a step must move at the least: every weight in bf16
once (each shared block once, however many sites use it), each
sequence's embedding row, the sites' bf16 K/V of positions ``0..pos-1``
read and the new K/V written, and the float32 SSM state and bf16 conv
state of every layer read and written once.
"""

from __future__ import annotations

from chipbench.metrics._arith import BF16

#: bytes of a float32 element (the SSM state)
F32 = 4


def mamba_weight_elements(d: dict) -> int:
    """Elements of one Mamba layer's weights: its norm, in-projection,
    convolution (weights and bias), A_log, dt_bias, D, gated-norm gains
    and out-projection."""
    D, din, N, G, H, K = (d["d_model"], d["d_inner"], d["d_state"],
                          d["n_groups"], d["ssm_heads"], d["d_conv"])
    C = din + 2 * G * N
    return D + D * (2 * din + 2 * G * N + H) + K * C + C + 3 * H + din \
        + din * D


def block_weight_elements(d: dict) -> int:
    """Elements of one shared block: two norms, q, k, v from 2 D, o, and
    the gated MLP."""
    D, H, KH, hd, F = (d["d_model"], d["n_heads"], d["n_kv_heads"],
                       d["head_dim"], d["d_ff"])
    return 2 * D + 2 * D * (H + 2 * KH) * hd + H * hd * D + D + 3 * D * F


def site_weight_elements(d: dict) -> int:
    """Elements of one site's own weights: the adapter and ``linear``."""
    D, F, r = d["d_model"], d["d_ff"], d["adapter_rank"]
    return D * r + 2 * r * F + D * D


def weight_elements(d: dict) -> int:
    """Every weight once: the layers, the blocks, the sites, the final
    norm and the tied embedding."""
    return d["n_layers"] * mamba_weight_elements(d) \
        + d["n_blocks"] * block_weight_elements(d) \
        + len(d["sites"]) * site_weight_elements(d) \
        + d["d_model"] + d["vocab"] * d["d_model"]


def mamba_token_flops(d: dict) -> float:
    D, din, N, G, H, P, K = (d["d_model"], d["d_inner"], d["d_state"],
                             d["n_groups"], d["ssm_heads"],
                             d["ssm_head_dim"], d["d_conv"])
    proj = 2 * D * (2 * din + 2 * G * N + H) + 2 * din * D
    return proj + 2 * K * (din + 2 * G * N) + 5 * H * P * N


def site_token_flops(d: dict, ctx: float) -> float:
    D, H, KH, hd, F, r = (d["d_model"], d["n_heads"], d["n_kv_heads"],
                          d["head_dim"], d["d_ff"], d["adapter_rank"])
    attn = 2 * 2 * D * (H + 2 * KH) * hd + 2 * H * hd * D \
        + 4 * H * hd * ctx
    return attn + 6 * D * F + 2 * D * r + 2 * r * 2 * F + 2 * D * D


def decode_step_flops(d: dict, batch: int, pos: int) -> float:
    """FLOPs of one decode step writing position ``pos``: every
    sequence's token through every layer, every site over ``pos + 1``
    keys, and the head."""
    per_token = d["n_layers"] * mamba_token_flops(d) \
        + len(d["sites"]) * site_token_flops(d, pos + 1) \
        + 2 * d["d_model"] * d["vocab"]
    return batch * per_token


def state_bytes(d: dict, batch: int) -> int:
    """One step's SSM state (float32) and conv state (bf16), every layer,
    read once and written once."""
    din, N, G, H, P, K = (d["d_inner"], d["d_state"], d["n_groups"],
                          d["ssm_heads"], d["ssm_head_dim"], d["d_conv"])
    per_layer = F32 * H * N * P + BF16 * (K - 1) * (din + 2 * G * N)
    return 2 * d["n_layers"] * batch * per_layer


def kv_row_bytes(d: dict) -> int:
    """Bytes of one position's K and V at one site, bf16."""
    return BF16 * 2 * d["n_kv_heads"] * d["head_dim"]


def decode_step_bytes(d: dict, batch: int, pos: int) -> float:
    """Bytes one decode step writing position ``pos`` needs moved (see
    the module's docstring)."""
    weights = BF16 * (weight_elements(d) + batch * d["d_model"])
    n = len(d["sites"]) * batch * kv_row_bytes(d)
    return weights + n * pos + n + state_bytes(d, batch)


def ssm_step_bytes(d: dict, batch: int) -> float:
    """Bytes the step's Mamba mixers need moved: their bf16 weights once
    and the states read and written once."""
    return BF16 * d["n_layers"] * mamba_weight_elements(d) \
        + state_bytes(d, batch)


def attn_core_bytes(d: dict, batch: int, pos: int) -> float:
    """Bytes the attention cores of one decode step writing ``pos`` read:
    every site's visible K and V rows, positions ``0..pos``."""
    return len(d["sites"]) * batch * (pos + 1) * kv_row_bytes(d)
