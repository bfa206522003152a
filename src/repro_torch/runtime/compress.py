"""Gradient compression (int8 + error feedback), the reference's
``runtime/compress.py``.

Each gradient leaf is quantised to int8 with one scale a tensor and
dequantised again; the residual is carried to the next step in ``ef``
(a tree like the grads, float32).  On one device there is no all-reduce
to shrink, so this is the arithmetic of the hook alone.  Every operation
is correctly rounded and ``torch.round`` rounds half to even as
``jnp.round`` does, so on the CPU it agrees with the reference bit for
bit.
"""

from __future__ import annotations

import torch

from repro_torch.models.blocks import tree_map


def _quantize(g: torch.Tensor):
    amax = torch.clamp_min(torch.max(torch.abs(g)), 1e-12)
    # a 0-d tensor, not a Python number: CUDA divides by a host scalar as
    # a product with its reciprocal
    scale = amax / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads, ef=None):
    """Quantize grads to int8 (+error feedback).  Returns (grads', ef')."""
    if ef is None:
        ef = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                      grads)

    def one(g, e):
        gf = g.to(torch.float32) + e
        q, scale = _quantize(gf)
        deq = q.to(torch.float32) * scale
        return deq.to(g.dtype), gf - deq

    out = tree_map(one, grads, ef)       # a (grad, ef) pair at every leaf
    return (tree_map(lambda _, o: o[0], grads, out),
            tree_map(lambda _, o: o[1], grads, out))
