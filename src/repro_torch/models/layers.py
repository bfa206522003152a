"""Model substrate layers: norms, RoPE, GQA attention, MLP, MoE.

Functional style over plain tensors: ``init_*`` returns a param tree (nested
dicts of tensors with the reference's keys); ``*_apply`` consumes it.
Compute dtype is bf16 (params stored f32, cast at use); softmax and
reductions run in f32.  Attention uses an online-softmax (flash-style)
chunked path for long sequences so activation memory stays bounded, with a
window-limited variant that only visits the kv chunks a sliding-window
layer can actually see.

Attention is einsum + softmax, as in the reference; the logits are taken
in f32 from upcast q and k (the reference's ``preferred_element_type``).
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16

#: the value a masked logit takes before the softmax
NEG_INF = -1e30
#: position given to padded kv slots (never visible to a real query)
PAD_POS = 2 ** 30


#: when True, a DTensor weight is all-gathered (replicated on every mesh
#: dim) AFTER the bf16 cast and before use — FSDP-style weight gathering
#: (bf16 on the wire) instead of activation partial sums
_WEIGHT_GATHER = False


def set_weight_gather(on: bool) -> None:
    """Turn ``maybe_gather``'s weight gathering on or off (the
    reference's switch of the same name)."""
    global _WEIGHT_GATHER
    _WEIGHT_GATHER = bool(on)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a leaf placed on a mesh).  No DTensor
    exists before ``torch.distributed.tensor`` is imported, so a process
    that never places a tensor on a mesh does not pay for the import
    (about a second)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def full_value(x):
    """A DTensor's whole value as a plain tensor on every rank; a plain
    tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def maybe_gather(w):
    """``w`` replicated on every mesh dim when weight gathering is on and
    ``w`` is a DTensor; otherwise ``w`` itself."""
    if _WEIGHT_GATHER and is_dtensor(w):
        from torch.distributed.tensor import Replicate
        return w.redistribute(w.device_mesh,
                              [Replicate()] * w.device_mesh.ndim)
    return w


def whole_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` whole on every rank: a DTensor's
    ``Shard(dim)`` placements become ``Replicate()`` (the others stay);
    a plain tensor is returned as it is.  For the ops DTensor cannot run
    on a sharded dim (a gather along it)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.ndim
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl) if pl != list(x.placements) \
        else x


# ------------------------------------------------------------------- init
class Init:
    """Where ``init_*`` draw their weights: standard normals in float32 from
    ``normal(shape)``, constants made on ``device``.  ``lead`` is the shape
    of the leading axes a stacked leaf carries (``(count,)`` for the layers
    of a stack, ``()`` for a leaf of its own)."""

    def __init__(self, normal, device):
        self._normal = normal
        self.device = device

    @classmethod
    def torch(cls, generator, device) -> "Init":
        device = torch.device(device)

        def normal(shape):
            return torch.randn(shape, generator=generator, device=device,
                               dtype=torch.float32)

        return cls(normal, device)

    @classmethod
    def numpy(cls, seed: int) -> "Init":
        rng = np.random.RandomState(seed)

        def normal(shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))

        return cls(normal, torch.device("cpu"))

    def normal(self, shape, scale: float) -> torch.Tensor:
        # scaled in place: a stacked leaf (5.4 GB for deepseek-7b's MLP)
        # is not held twice
        return self._normal(tuple(shape)).mul_(scale)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(tuple(shape), value, dtype=torch.float32,
                          device=self.device)


# ------------------------------------------------------------------- basics
def init_linear(init: Init, lead, d_in, d_out, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": init.normal(lead + (d_in, d_out), scale)}


def linear(p, x):
    return x @ maybe_gather(p["w"].to(x.dtype))


def init_norm(init: Init, lead, d):
    return {"g": init.full(lead + (d,), 1.0)}


def rms_norm(p, x, eps=1e-6):
    xf = x.float()
    nrm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (nrm * p["g"]).to(x.dtype)


def silu(x):
    """``jax.nn.silu``'s arithmetic: ``x * (1 / (1 + exp(-x)))``, each step
    rounded to x's dtype.  In bfloat16 this rounds as the reference does,
    bit for bit on the CPU; ``F.silu`` rounds once, from float32, and
    differs from it in a third of bfloat16 values."""
    return x * (1 / (1 + torch.exp(-x)))


# --------------------------------------------------------------------- RoPE
def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    """``rope_frequencies`` (float64) rounded to float32 and placed on
    ``device`` once: a copy from the host waits for the device, so it is
    not made again at every layer."""
    return torch.from_numpy(rope_frequencies(head_dim, theta)).to(
        device=device, dtype=torch.float32)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, H, hd]; positions [..., S] (broadcastable)."""
    hd = x.shape[-1]
    freqs = _rope_freqs(hd, float(theta), x.device)
    ang = positions[..., :, None].float()[..., None, :] \
        * freqs  # [..., S, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_heads: int
    n_kv_heads: int
    head_dim: int


def init_attention(init: Init, lead, d_model, dims: AttnDims):
    h, kh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    return {
        "wq": init_linear(init, lead, d_model, h * hd),
        "wk": init_linear(init, lead, d_model, kh * hd),
        "wv": init_linear(init, lead, d_model, kh * hd),
        "wo": init_linear(init, lead, h * hd, d_model,
                          scale=(h * hd) ** -0.5),
    }


def _mask(q_pos, k_pos, causal, window):
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window is not None:
        m &= kp > qp - window
    return m


def _logits(q, k, scale):
    """[B,KH,G,Sq,Sk] float32 logits of bf16 (or f32) q and k: the inputs
    are upcast first, so the products and their sum are f32, as the
    reference's ``preferred_element_type=float32`` makes them."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale


def _sdpa(q, k, v, q_pos, k_pos, causal, window):
    """Direct attention on small blocks. q [B,Sq,KH,G,hd], k/v [B,Sk,KH,hd]."""
    scale = q.shape[-1] ** -0.5
    logits = _logits(q, k, scale)
    mask = _mask(q_pos, k_pos, causal, window)  # [B?,Sq,Sk] broadcast
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _flash(q, k, v, q_pos, k_pos, causal, window, kv_chunk=1024):
    """Online-softmax over kv chunks. Shapes as _sdpa; returns [B,Sq,KH,G,hd]."""
    B, Sq, KH, G, hd = q.shape
    Sk = k.shape[1]
    nkc = -(-Sk // kv_chunk)
    pad = nkc * kv_chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=PAD_POS)
    scale = hd ** -0.5
    m = torch.full((B, KH, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KH, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KH, G, Sq, hd), dtype=v.dtype, device=q.device)
    for c in range(nkc):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kb, vb, pb = k[:, sl], v[:, sl], k_pos[:, sl]
        logits = _logits(q, kb, scale)
        msk = _mask(q_pos, pb, causal, window)
        logits = torch.where(msk[:, None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb)
        acc = acc * alpha[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
    return out.permute(0, 3, 1, 2, 4)  # [B,Sq,KH,G,hd]


def _flash_windowed(q, k, v, q_pos, k_pos, causal, window, q_chunk=512):
    """Sliding-window attention visiting only reachable kv (causal).

    Loops over q chunks; for each, slices the kv span [start, start+span)
    where span = window + q_chunk.  Keeps FLOPs ~O(S*window) instead of
    O(S^2).
    """
    B, Sq, KH, G, hd = q.shape
    span = window + q_chunk
    nqc = -(-Sq // q_chunk)
    padq = nqc * q_chunk - Sq
    if padq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, padq))
        q_pos = F.pad(q_pos, (0, padq), value=PAD_POS)
    kpad = F.pad(k, (0, 0, 0, 0, 0, span))
    vpad = F.pad(v, (0, 0, 0, 0, 0, span))
    kp_pad = F.pad(k_pos, (0, span), value=PAD_POS)
    outs = []
    for c in range(nqc):
        qs = slice(c * q_chunk, (c + 1) * q_chunk)
        start = max(c * q_chunk - window, 0)
        ks = slice(start, start + span)
        outs.append(_sdpa(q[:, qs], kpad[:, ks], vpad[:, ks], q_pos[:, qs],
                          kp_pad[:, ks], causal, window))
    return torch.cat(outs, 1)[:, :Sq]


def attention_apply(p, x, *, dims: AttnDims, positions, causal=True,
                    window=None, rope_theta=10000.0, kv=None, kv_positions=None,
                    use_rope=True, flash_threshold=2048):
    """Self- or cross-attention.  x [B,S,D]; kv (xk_src) for cross-attn."""
    B, S, _ = x.shape
    h, kh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // kh
    q = linear(p["wq"], x).reshape(B, S, kh, g, hd)
    src = x if kv is None else kv
    Sk = src.shape[1]
    k = linear(p["wk"], src).reshape(B, Sk, kh, hd)
    v = linear(p["wv"], src).reshape(B, Sk, kh, hd)
    kpos = positions if kv is None else kv_positions
    if use_rope:
        q = apply_rope(q.reshape(B, S, kh * g, hd), positions,
                       rope_theta).reshape(B, S, kh, g, hd)
        k = apply_rope(k, kpos, rope_theta)
    if window is not None and causal and Sk > flash_threshold:
        out = _flash_windowed(q, k, v, positions, kpos, causal, window)
    elif Sk > flash_threshold:
        out = _flash(q, k, v, positions, kpos, causal, window)
    else:
        out = _sdpa(q, k, v, positions, kpos, causal, window)
    out = out.reshape(B, S, h * hd)
    return linear(p["wo"], out)


def slot_positions(S: int, pos: int, device) -> torch.Tensor:
    """Absolute position held by each slot of a ring cache of ``S`` slots
    once position ``pos`` has been written at slot ``pos % S`` (slots not
    written yet come out negative)."""
    write_at, wraps = pos % S, pos // S
    slot = torch.arange(S, device=device)
    return torch.where(slot <= write_at, wraps * S + slot,
                       (wraps - 1) * S + slot)


def attention_decode(p, x, cache_k, cache_v, pos, *, dims: AttnDims,
                     window=None, rope_theta=10000.0, use_rope=True):
    """Single-token decode with a cache append.

    x [B,1,D]; cache_k/v [B,S,KH,hd]; pos int write position.
    Returns (out [B,1,D], cache_k, cache_v): new caches; the caller's are
    left as they were.
    """
    B, _, _ = x.shape
    h, kh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // kh
    S = cache_k.shape[1]
    pos = int(pos)
    q = linear(p["wq"], x).reshape(B, 1, kh, g, hd)
    k_new = linear(p["wk"], x).reshape(B, 1, kh, hd)
    v_new = linear(p["wv"], x).reshape(B, 1, kh, hd)
    posv = torch.full((B, 1), pos, device=x.device)
    if use_rope:
        q = apply_rope(q.reshape(B, 1, h, hd), posv,
                       rope_theta).reshape(B, 1, kh, g, hd)
        k_new = apply_rope(k_new, posv, rope_theta)
    write_at = pos % S  # ring buffer (sliding-window caches wrap)
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[:, write_at] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, write_at] = v_new[:, 0].to(cache_v.dtype)
    k_pos = slot_positions(S, pos, x.device)[None].expand(B, S)
    scale = hd ** -0.5
    logits = _logits(q, cache_k.to(q.dtype), scale)
    valid = (k_pos <= pos) & (k_pos >= 0)
    if window is not None:
        valid &= k_pos > pos - window
    logits = torch.where(valid[:, None, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, cache_v.to(x.dtype))
    out = out.reshape(B, 1, h * hd)
    return linear(p["wo"], out), cache_k, cache_v


# ----------------------------------------------------------------------- MLP
def init_mlp(init: Init, lead, d_model, d_ff, gated=True):
    p = {"up": init_linear(init, lead, d_model, d_ff),
         "down": init_linear(init, lead, d_ff, d_model, scale=d_ff ** -0.5)}
    if gated:
        p["gate"] = init_linear(init, lead, d_model, d_ff)
    return p


def mlp_apply(p, x, act=silu):
    up = linear(p["up"], x)
    if "gate" in p:
        up = up * act(linear(p["gate"], x))
    else:
        up = act(up)
    return linear(p["down"], up)


# ----------------------------------------------------------------------- MoE
def init_moe(init: Init, lead, d_model, expert_d_ff, n_experts, n_shared=0,
             shared_d_ff=None):
    scale = d_model ** -0.5
    p = {
        "router": init_linear(init, lead, d_model, n_experts),
        "w_up": init.normal(lead + (n_experts, d_model, expert_d_ff), scale),
        "w_gate": init.normal(lead + (n_experts, d_model, expert_d_ff),
                              scale),
        "w_down": init.normal(lead + (n_experts, expert_d_ff, d_model),
                              expert_d_ff ** -0.5),
    }
    if n_shared:
        p["shared"] = init_mlp(init, lead, d_model,
                               shared_d_ff or n_shared * expert_d_ff)
    return p


def lax_top_k(x, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest values in
    descending order, equal values lower index first (``lax.top_k``'s
    rule; ``torch.topk`` leaves the order of ties unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def grouped_matmul(xs, w, group_sizes: list[int]):
    """``lax.ragged_dot``: rows of ``xs`` in contiguous groups, group ``e``
    times ``w[e]``.  One matmul per non-empty group, the products joined
    in group order."""
    parts, off = [], 0
    for e, n in enumerate(group_sizes):
        if n:
            parts.append(xs[off:off + n] @ w[e])
        off += n
    return torch.cat(parts)


def moe_apply(p, x, *, top_k: int):
    """Sorted-dispatch MoE (MegaBlocks-style), one matmul per expert over its
    contiguous slice of the sorted tokens.  Returns (out, aux_loss).

    The group sizes are read on the host (one device sync per call).  The
    combine unsorts to [T, k, D] and adds each token's k weighted outputs
    in ascending expert id — the order in which the reference's scatter-add
    over the expert-sorted rows meets them — starting from zeros, with no
    float atomics: the same bits as the reference, run after run.

    On DTensors the tokens are gathered whole on every rank first, and the
    routing's index arithmetic runs on plain tensors."""
    B, S, D = x.shape
    E = p["w_up"].shape[0]
    T = B * S
    xt = whole_dim(x.reshape(T, D), 0)
    logits = linear(p["router"], xt).float()                    # [T,E]
    probs = torch.softmax(logits, -1)
    gates, eid = lax_top_k(probs, top_k)                        # [T,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    eid = full_value(eid)
    # load-balance aux loss (Switch-style)
    density = F.one_hot(eid[:, 0], E).float().mean(0)
    router_prob = probs.mean(0)
    aux = E * (density * router_prob).sum()

    flat_e = eid.reshape(-1)                                    # [T*k]
    order = torch.argsort(flat_e, stable=True)
    token_of = order // top_k
    xs = xt[token_of]                                           # [T*k, D]
    group_sizes = torch.bincount(flat_e, minlength=E).tolist()
    up = grouped_matmul(xs, maybe_gather(p["w_up"].to(xs.dtype)),
                        group_sizes)
    gate = grouped_matmul(xs, maybe_gather(p["w_gate"].to(xs.dtype)),
                          group_sizes)
    hidden = up * silu(gate)
    out_s = grouped_matmul(hidden, maybe_gather(p["w_down"].to(xs.dtype)),
                           group_sizes)                         # [T*k, D]
    # unsort to [T, k, D], each token's k slots by ascending expert id (a
    # token's experts are distinct), and combine with the gate weights
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(order.numel(), device=order.device)
    by_e = eid.argsort(-1)
    out_tk = out_s[unsort.reshape(T, top_k).gather(1, by_e)]    # [T,k,D]
    w = gates.gather(1, by_e).to(out_s.dtype)
    combined = torch.zeros((T, D), dtype=out_s.dtype, device=x.device)
    for j in range(top_k):
        combined = combined + out_tk[:, j] * w[:, j, None]
    if "shared" in p:
        combined = combined + mlp_apply(p["shared"], xt)
    return combined.reshape(B, S, D), aux
