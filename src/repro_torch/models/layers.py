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
A decode step's attention over its cache is ``kernels.attn_decode``: the
same arithmetic on the CPU, a hand-written kernel on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.attn_decode import attn_decode
from repro_torch.telemetry import span

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
    return project(x, p["w"])


def project(x, w):
    """``x @ w`` for x [..., K] and a weight w [K, N] cast to x's dtype.
    Where both are DTensors, ``_sharded_matmul``: the weight gathered in
    its stored dtype and cast on each rank (the reference's 2-D layout
    does the same), or, with weight gathering on, cast first and gathered
    whole (``maybe_gather``: bf16 on the wire).  A cast runs inside the
    profiler range ``weights.cast``."""
    if is_dtensor(x) and is_dtensor(w) and not _WEIGHT_GATHER:
        return _sharded_matmul(x, w)
    if w.dtype != x.dtype:
        with span("weights.cast"):
            w = w.to(x.dtype)
    w = maybe_gather(w)
    if is_dtensor(x) and is_dtensor(w):
        return _sharded_matmul(x, w)
    return x @ w


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (made by no
    allocation: the dry run would count one)."""
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= max(n, 1)
    return tuple(reversed(out))


def _sharded_matmul(x, w):
    """``x @ w`` as one local product a rank, the layouts fixed per mesh
    dim as tensor-parallel layers fix them: where x's rows are split
    (data parallel) w is gathered whole and the product's rows stay split;
    where w's K is split (row-parallel) x's K is split alike and the
    product is a pending sum (``Partial``); where w's N is split
    (column-parallel) x is whole and the product's N is split; else both
    are whole.  Where x's rows and w are both split over a dim and the
    step's activations (x and the product) are fewer elements than w
    (``_moves_less``: a decode step's few tokens), the activations move
    instead: the dim takes the row- or column-parallel layout and the
    product's rows are split over it again after.  The weight's block is
    cast to x's dtype after the gather.  The gradients' placements are
    stated the same way: a gathered weight's and a column-parallel
    input's are pending sums (a weight's reduced in its stored dtype).
    DTensor's own choice for ``aten.mm`` varies by release (torch 2.11
    computes whole products on every rank of the model axis when an input
    is a pending sum)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, last = x.device_mesh, x.ndim - 1
    xp, wp, outp, gx, gw, post = [], [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        split = isinstance(px, Shard) and px.dim != last
        if split and not (isinstance(pw, Shard) and _moves_less(
                x.numel() // x.shape[-1], *w.shape)):
            lay = (px, Replicate(), px, px, Partial())     # rows split
        elif isinstance(pw, Shard) and pw.dim == 0:        # row-parallel
            lay = (Shard(last), pw, Partial(), Shard(last), pw)
        elif isinstance(pw, Shard):                        # column-parallel
            lay = (Replicate(), pw, Shard(last), Partial(), pw)
        else:
            lay = (Replicate(),) * 5
        for acc, pl in zip((xp, wp, outp, gx, gw), lay):
            acc.append(pl)
        post.append(px if split else lay[2])
    # a tensor laid out already is not redistributed: the pending sums of
    # x's gradient from several products (q, k, v; up, gate) then add up
    # before one reduction
    if list(x.placements) != xp:
        x = x.redistribute(mesh, xp)
    if list(w.placements) != wp:
        w = w.redistribute(mesh, wp)
    xl = x.to_local(grad_placements=gx)
    wl = w.to_local(grad_placements=gw).to(x.dtype)
    shape = torch.Size((*x.shape[:-1], w.shape[1]))
    out = DTensor.from_local(xl @ wl, mesh, outp, run_check=False,
                             shape=shape, stride=contiguous_stride(shape))
    return out.redistribute(mesh, post) if post != outp else out


def _moves_less(rows: int, k: int, n: int) -> bool:
    """Whether ``rows`` activations of ``k`` elements in and ``n`` out are
    fewer elements than a [k, n] weight: then moving them over a mesh
    dim costs less than gathering the weight over it."""
    return rows * (k + n) < k * n


def _all_reduce(t, group):
    """``t`` summed over ``group`` (a functional all-reduce, waited)."""
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_reduce(t.contiguous(), "sum", group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.group = (mesh, dim)
        return _all_reduce(t, ctx.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None, None


def sum_over(t, mesh, dim: int):
    """The plain tensor ``t`` summed over mesh dim ``dim`` of ``mesh`` (an
    all-reduce), for a sum of pieces whose consumers differ from rank to
    rank: its gradient is all-reduced too.  (A pending-sum DTensor made
    whole would hand each rank its own piece of the gradient back.)"""
    return _SumOver.apply(t, mesh, dim)


def chunk_spans(width: int, n: int) -> list:
    """The ``(lo, hi)`` spans of a dim of ``width`` split over ``n`` ranks
    as DTensor's ``Shard`` splits it (``torch.chunk``: chunks of
    ``ceil(width / n)``, the last ones shorter or empty)."""
    c = -(-width // n)
    return [(min(r * c, width), min((r + 1) * c, width)) for r in range(n)]


def column_plan(needs, width: int, shared: tuple):
    """The all-to-all of ``exchange_columns`` over ``len(needs)`` ranks of
    a dim of ``width`` split as ``chunk_spans`` splits it, ``needs[d]``
    the ascending columns rank d needs.  The columns of the ``shared``
    span ``(a, b)`` are not sent to every rank that needs them: rank d
    gets its ``chunk_spans(b - a, n)`` piece of the span, which an
    all-gather then makes whole on every rank.  Returns ``(wants,
    splits, picks)``: ``wants[d]`` the ascending columns the all-to-all
    hands rank d (its needs outside the span and its piece),
    ``splits[s, d]`` how many of them lie in rank s's block (``s == d``:
    kept), and ``picks[d]`` where ``needs[d]`` lie in ``wants[d]``
    followed by the whole span."""
    n, (a, b) = len(needs), shared
    pieces = chunk_spans(b - a, n)
    wants = [np.union1d(need[(need < a) | (need >= b)],
                        np.arange(a + lo, a + hi))
             for need, (lo, hi) in zip(needs, pieces)]
    splits = np.array([[int(((w >= lo) & (w < hi)).sum()) for w in wants]
                       for lo, hi in chunk_spans(width, n)])
    picks = [np.where((need >= a) & (need < b), len(want) + need - a,
                      np.searchsorted(want, need))
             for need, want in zip(needs, wants)]
    return wants, splits, picks


def _waited(t):
    from torch.distributed import _functional_collectives as funcol
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _all_to_all(t, splits, r: int, group):
    """The rows of ``t`` exchanged over ``group``, rank ``r`` sending
    ``splits[r, d]`` rows to rank d and receiving ``splits[s, r]`` from
    rank s, in rank order (a functional all-to-all, waited)."""
    from torch.distributed import _functional_collectives as funcol
    return _waited(funcol.all_to_all_single(
        t.contiguous(), splits[:, r].tolist(), splits[r].tolist(), group))


class _ExchangeColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, send, splits, r, group):
        ctx.plan = (send, splits, r, group, t.shape)
        flat = t.reshape(-1, t.shape[-1]).t()              # [cols, tokens]
        got = _all_to_all(flat.index_select(0, torch.cat(send)), splits, r,
                          group)
        return got.t().reshape(*t.shape[:-1], got.shape[0])

    @staticmethod
    def backward(ctx, g):
        send, splits, r, group, shape = ctx.plan
        back = _all_to_all(g.reshape(-1, g.shape[-1]).t(), splits.T, r,
                           group)
        grad = back.new_zeros(shape[-1], back.shape[1])
        for idx, part in zip(send, back.split(splits[r].tolist())):
            grad.index_add_(0, idx, part)
        return grad.t().reshape(shape), None, None, None, None


class _GatherRows(torch.autograd.Function):
    """An all-gather of equal row blocks over ``group``; the gradient is
    reduce-scattered back."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        return _waited(funcol.all_gather_tensor(t.contiguous(), 0, group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return _waited(funcol.reduce_scatter_tensor(
            g.contiguous(), "sum", 0, ctx.group)), None


def exchange_columns(t, needs, width: int, shared: tuple, mesh, dim: int):
    """This rank's columns ``needs[r]`` of a tensor whose last dim, of
    ``width``, is split over mesh dim ``dim`` (``chunk_spans``), ``t`` the
    rank's block as a plain tensor and ``needs[d]`` the ascending columns
    (a numpy array) rank d needs.  One all-to-all over the dim sends each
    rank the columns of the others' blocks that it needs outside the
    ``shared`` span ``(a, b)``, and its even piece of that span; one
    all-gather of the pieces then makes the span whole on every rank
    (``column_plan``).  Columns needed by several ranks thus leave their
    block once, and no rank sends much more than its block: the
    all-to-all ends with its busiest rank.  The gradient goes back by a
    reduce-scatter of the span and the reverse all-to-all, and is the
    block's own."""
    n, r = mesh.size(dim), mesh.get_local_rank(dim)
    lo, hi = chunk_spans(width, n)[r]
    assert t.shape[-1] == hi - lo, (t.shape, lo, hi)
    wants, splits, picks = column_plan(needs, width, shared)
    send = [torch.as_tensor(w[(w >= lo) & (w < hi)] - lo, dtype=torch.long,
                            device=t.device) for w in wants]
    got = _ExchangeColumns.apply(t, send, splits, r, (mesh, dim))
    a, b = shared
    p0, (plo, phi) = int(np.searchsorted(wants[r], a)), \
        chunk_spans(b - a, n)[r]
    piece = F.pad(got[..., p0:p0 + phi - plo],
                  (0, -(-(b - a) // n) - (phi - plo)))
    span = _GatherRows.apply(piece.movedim(-1, 0), (mesh, dim)).movedim(
        0, -1)[..., :b - a]
    return torch.cat([got, span], -1).index_select(
        -1, torch.as_tensor(picks[r], dtype=torch.long, device=t.device))


def heads(t, *shape):
    """``t.reshape(*shape)``: a projection's last dim [..., n] split into
    heads [..., kh, (g,) hd].  On a DTensor whose last dim is split over
    mesh dims that the head count ``kh`` cannot be split over alike, that
    dim is gathered first (DTensor refuses to split a sharded dim
    unevenly)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Shard
        last = t.ndim - 1
        n = 1
        for i, p in enumerate(t.placements):
            if isinstance(p, Shard) and p.dim == last:
                n *= t.device_mesh.size(i)
        if shape[last] % n:
            t = whole_dim(t, -1)
    return t.reshape(*shape)


def rows(x):
    """``x`` laid out as the batch is, the residual stream's layout
    between blocks: on each mesh dim its rows (dim 0) split where they are
    split already, else whole — pending sums reduced, other splits
    gathered.  A plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    return x.redistribute(x.device_mesh, pl) \
        if pl != list(x.placements) else x


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


def init_attention(init: Init, lead, d_model, dims: AttnDims, d_in=None):
    """q, k, v from ``d_in`` (default ``d_model``) wide inputs, o back to
    ``d_model``."""
    h, kh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    d_in = d_in or d_model
    return {
        "wq": init_linear(init, lead, d_in, h * hd),
        "wk": init_linear(init, lead, d_in, kh * hd),
        "wv": init_linear(init, lead, d_in, kh * hd),
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


def _sdpa(q, k, v, q_pos, k_pos, causal, window, scale=None):
    """Direct attention on small blocks. q [B,Sq,KH,G,hd], k/v [B,Sk,KH,hd];
    ``scale`` of the logits, default hd^-0.5."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = _logits(q, k, scale)
    mask = _mask(q_pos, k_pos, causal, window)  # [B?,Sq,Sk] broadcast
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v)


def _flash(q, k, v, q_pos, k_pos, causal, window, scale=None,
           kv_chunk=1024):
    """Online-softmax over kv chunks. Shapes and scale as _sdpa; returns
    [B,Sq,KH,G,hd]."""
    B, Sq, KH, G, hd = q.shape
    Sk = k.shape[1]
    nkc = -(-Sk // kv_chunk)
    pad = nkc * kv_chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=PAD_POS)
    scale = hd ** -0.5 if scale is None else scale
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


def _flash_windowed(q, k, v, q_pos, k_pos, causal, window, scale=None,
                    q_chunk=512):
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
                          kp_pad[:, ks], causal, window, scale))
    return torch.cat(outs, 1)[:, :Sq]


def attention_apply(p, x, *, dims: AttnDims, positions, causal=True,
                    window=None, rope_theta=10000.0, kv=None, kv_positions=None,
                    use_rope=True, flash_threshold=2048, scale=None):
    """Self- or cross-attention.  x [B,S,D]; kv (xk_src) for cross-attn;
    ``scale`` of the logits, default hd^-0.5."""
    B, S, _ = x.shape
    h, kh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // kh
    q = heads(linear(p["wq"], x), B, S, kh, g, hd)
    src = x if kv is None else kv
    Sk = src.shape[1]
    k = heads(linear(p["wk"], src), B, Sk, kh, hd)
    v = heads(linear(p["wv"], src), B, Sk, kh, hd)
    kpos = positions if kv is None else kv_positions
    if use_rope:
        q = apply_rope(q.reshape(B, S, kh * g, hd), positions,
                       rope_theta).reshape(B, S, kh, g, hd)
        k = apply_rope(k, kpos, rope_theta)
    if window is not None and causal and Sk > flash_threshold:
        core = _flash_windowed
    elif Sk > flash_threshold:
        core = _flash
    else:
        core = _sdpa
    out = on_local_heads(lambda q, k, v, qp, kp: core(q, k, v, qp, kp,
                                                      causal, window, scale),
                         q, k, v, positions, kpos)
    out = out.reshape(B, S, h * hd)
    return linear(p["wo"], out)


def on_local_rows(fn, tensors, params):
    """``fn(*tensors, params)`` where every batch row (dim 0 of each
    tensor) is independent of the others.  On plain tensors, the call
    itself.  On DTensors each rank runs ``fn`` on its own rows — the
    tensors laid out as ``rows`` lays out the first — with the params
    whole, all as plain tensors; each output comes back as a DTensor of
    that layout.  A param's gradient is a pending sum over the mesh dims
    that split the rows.  For the code DTensor cannot shard through (the
    Mamba2 mixer's splits, pads and scans: torch 2.11 fails on them).
    Mamba2 (``models/ssm.py``) takes it where its heads cannot split over
    the ``model`` axis — the axis of size one, rows split over it, or a
    head or group count it does not divide — and its decode where the
    caches' layout splits no state over that axis."""
    if not is_dtensor(tensors[0]):
        return fn(*tensors, params)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.utils._pytree import tree_map
    lead = rows(tensors[0])
    mesh, pl = lead.device_mesh, list(lead.placements)
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if p.is_shard() else Replicate() for p in pl]
    local = [lead.to_local()] + [t.redistribute(mesh, pl).to_local()
                                 for t in tensors[1:]]
    out = fn(*local, tree_map(
        lambda w: w.redistribute(mesh, whole).to_local(grad_placements=grad)
        if is_dtensor(w) else w, params))

    def wrap(o):
        shape = torch.Size((lead.shape[0], *o.shape[1:]))
        return DTensor.from_local(o, mesh, pl, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def like(x, ref):
    """``x`` laid out as the DTensor ``ref`` is; a plain tensor as it
    is."""
    if is_dtensor(x) and is_dtensor(ref) and x.placements != ref.placements:
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def on_local_heads(core, q, k, v, q_pos, k_pos):
    """``core(q, k, v, q_pos, k_pos)``: attention over q [B,Sq,KH,G,hd]
    and k, v [B,Sk,KH,hd], independent per (batch row, kv head).  On plain
    tensors, the call itself.  On DTensors, each rank runs ``core`` on its
    own block of rows and kv heads, as tensor-parallel attention does: q,
    k and v are laid out alike (``_local_layout``), their local blocks and
    the matching rows of the positions go through ``core`` as plain
    tensors, and the result comes back as a DTensor of that layout.
    DTensor never sees the core's reshapes, pads and masks (torch 2.11
    cannot propagate a sharding through some of them), and the core's
    buffers hold a rank's block, not the global batch."""
    if not is_dtensor(q):
        return core(q, k, v, q_pos, k_pos)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, shape = q.device_mesh, q.shape
    pl = _local_layout(q)
    (rows, *_), (off, *_) = compute_local_shape_and_global_offset(
        shape, mesh, pl)

    def mine(pos):
        if pos is None:
            return None
        pos = full_value(pos)
        return pos[off:off + rows] if pos.shape[0] > 1 else pos

    out = core(*(x.redistribute(mesh, pl).to_local() for x in (q, k, v)),
               mine(q_pos), mine(k_pos)).contiguous()
    return DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _local_layout(q) -> list:
    """Placements for q, k and v under which attention is local to a
    rank: on each mesh dim of size > 1 the batch rows (dim 0) or the kv
    heads (dim 2) split — the one q is split on already, else the heads on
    the ``model`` axis and the rows on the others — where it divides,
    else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    left = {0: q.shape[0], 2: q.shape[2]}
    out = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, q.placements)):
        n = mesh.size(i)
        order = (2, 0) if name == "model" else (0, 2)
        if isinstance(p, Shard) and p.dim in left:
            order = (p.dim,) + order
        d = next((d for d in order if n > 1 and left[d] % n == 0), None)
        if d is None:
            out.append(Replicate())
        else:
            left[d] //= n
            out.append(Shard(d))
    return out


def attention_decode(p, x, cache_k, cache_v, pos, *, dims: AttnDims,
                     window=None, rope_theta=10000.0, use_rope=True,
                     scale=None):
    """Single-token decode with a cache append.

    x [B,1,D]; cache_k/v [B,S,KH,hd]; pos int write position; ``scale``
    of the logits, default hd^-0.5.
    Returns (out [B,1,D], cache_k, cache_v).  The new token's K and V go
    into slot ``pos`` of the caches given, in place, and those same
    tensors come back (profiler range ``decode.cache_write``): the step
    reads only slots of positions up to ``pos``, so every slot a later
    step can read from the caches given stays as it was.  Where the ring
    has wrapped (``pos >= S``: slot ``pos % S`` holds a position a caller
    may still read), the caches are copied first (range
    ``decode.cache_clone``) and the caller's are left whole.  A
    caller that runs two steps from one cache at once clones it itself.
    The attention over the cache is
    ``kernels.attn_decode`` (range ``decode.attn_core``): on a CUDA
    tensor a kernel that reads the cache once, in its stored type.
    """
    B, _, _ = x.shape
    h, kh, hd = dims.n_heads, dims.n_kv_heads, dims.head_dim
    g = h // kh
    S = cache_k.shape[1]
    pos = int(pos)
    q = heads(linear(p["wq"], x), B, 1, kh, g, hd)
    k_new = heads(linear(p["wk"], x), B, 1, kh, hd)
    v_new = heads(linear(p["wv"], x), B, 1, kh, hd)
    posv = torch.full((B, 1), pos, device=x.device)
    if use_rope:
        q = apply_rope(q.reshape(B, 1, h, hd), posv,
                       rope_theta).reshape(B, 1, kh, g, hd)
        k_new = apply_rope(k_new, posv, rope_theta)
    write_at = pos % S  # ring buffer (sliding-window caches wrap)
    if pos >= S:
        with span("decode.cache_clone"):
            cache_k = cache_k.clone()
            cache_v = cache_v.clone()
    with span("decode.cache_write"):
        cache_k[:, write_at] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, write_at] = v_new[:, 0].to(cache_v.dtype)

    def core(q, ck, cv, _, __):
        return attn_decode(q, ck, cv, pos, window, scale)

    with span("decode.attn_core"):
        out = on_local_heads(core, q, cache_k, cache_v, None, None)
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


def _group_sizes(flat_e, E: int) -> list[int]:
    """Rows routed to each expert, read on the host.  A meta or fake
    tensor has no values (the dry run traces on them): its rows are split
    evenly over the experts — the dispatch's work is the same T·k rows
    whatever the split."""
    fake = sys.modules.get("torch._subclasses.fake_tensor")
    if flat_e.is_meta or (fake is not None
                          and isinstance(flat_e, fake.FakeTensor)):
        n = flat_e.numel()
        return [n // E + (e < n % E) for e in range(E)]
    return torch.bincount(flat_e, minlength=E).tolist()


def moe_apply(p, x, *, top_k: int):
    """Sorted-dispatch MoE (MegaBlocks-style), one matmul per expert over its
    contiguous slice of the sorted tokens.  Returns (out, aux_loss).

    The group sizes are read on the host (one device sync per call;
    ``_group_sizes`` splits the rows evenly where there are no values).  The
    combine unsorts to [T, k, D] and adds each token's k weighted outputs
    in ascending expert id — the order in which the reference's scatter-add
    over the expert-sorted rows meets them — starting from zeros, with no
    float atomics: the same bits as the reference, run after run.

    On DTensors each rank routes its own rows (``_moe_on_rows``)."""
    if is_dtensor(x):
        return _moe_on_rows(p, x, top_k)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    out, aux = _route(xt, p["router"]["w"], p["w_up"], p["w_gate"],
                      p["w_down"], top_k)
    if "shared" in p:
        out = out + mlp_apply(p["shared"], xt)
    return out.reshape(B, S, D), aux


def _route(xt, router, w_up, w_gate, w_down, top_k: int, mean=None,
           total=None):
    """The routed experts over the tokens ``xt`` [T, D], plain tensors:
    (combined [T, D], aux).  ``mean`` (default: none) takes the two [E]
    means of the aux loss over these tokens to their means over all the
    step's tokens; ``total`` (default: none) completes the products over
    ``D`` — the router's logits, ``up`` and ``gate`` — where ``xt`` holds
    a block of its columns and the weights the matching rows."""
    T, D = xt.shape
    E = w_up.shape[0]
    total = total or (lambda t: t)
    logits = total(project(xt, router)).float()                 # [T,E]
    probs = torch.softmax(logits, -1)
    gates, eid = lax_top_k(probs, top_k)                        # [T,k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch-style)
    density = F.one_hot(eid[:, 0], E).float().mean(0)
    router_prob = probs.mean(0)
    if mean is not None:
        density, router_prob = mean(density), mean(router_prob)
    aux = E * (density * router_prob).sum()

    flat_e = eid.reshape(-1)                                    # [T*k]
    order = torch.argsort(flat_e, stable=True)
    token_of = order // top_k
    xs = xt[token_of]                                           # [T*k, D]
    group_sizes = _group_sizes(flat_e, E)
    up = total(grouped_matmul(xs, w_up.to(xs.dtype), group_sizes))
    gate = total(grouped_matmul(xs, w_gate.to(xs.dtype), group_sizes))
    hidden = up * silu(gate)
    out_s = grouped_matmul(hidden, w_down.to(xs.dtype),
                           group_sizes)                         # [T*k, D]
    # unsort to [T, k, D], each token's k slots by ascending expert id (a
    # token's experts are distinct), and combine with the gate weights
    unsort = torch.empty_like(order)
    unsort[order] = torch.arange(order.numel(), device=order.device)
    by_e = eid.argsort(-1)
    out_tk = out_s[unsort.reshape(T, top_k).gather(1, by_e)]    # [T,k,D]
    w = gates.gather(1, by_e).to(out_s.dtype)
    combined = torch.zeros((T, D), dtype=out_s.dtype, device=xt.device)
    for j in range(top_k):
        combined = combined + out_tk[:, j] * w[:, j, None]
    return combined, aux


def _moe_on_rows(p, x, top_k: int):
    """``moe_apply`` on DTensors, on the reference's layout
    (``router P(f, None)``, ``w_up/w_gate P(None, f, t)``, ``w_down
    P(None, t, f)``: tensor-parallel experts over data-parallel tokens).
    ``x`` is laid out as ``rows`` lays it out, and each rank routes its
    own rows as plain tensors (``_route``): router, top-k, sort, the
    [T_loc·k, D] gather, the products and the combine.  Per mesh dim:

    * the rows split: the weights gathered whole, their gradients pending
      sums — unless the step's tokens are fewer elements than the
      experts' weights (``_moves_less``: a decode step) and the experts'
      ``D`` is split over the dim: then the tokens are gathered over it
      instead and each rank keeps its block of ``D`` — the router's
      logits and ``up`` and ``gate`` are pending sums, completed before
      the softmax and the activation (``sum_over``), ``down`` is N-split,
      and the output's rows are split again after;
    * else the experts' ``d_ff`` split (weight gathering off): each rank
      keeps its block, as ``_sharded_matmul`` keeps a column-parallel
      weight — ``up`` and ``gate`` are N-split products, ``down`` a
      K-split one, and the combined output is a pending sum, reduced
      where the dense MLP's is (``rows`` after the block);
    * else (a ``d_ff`` the dim does not divide: the rule leaves it whole;
      or weight gathering on) the experts run whole on every rank of it.

    The router runs on every rank of a dim that splits ``d_ff`` or
    ``D``, as the reference's replicated router does; its gradient
    (through the gates, which weight pending sums) is then a pending sum
    over the dim, and the aux loss is stated as one, ``1 / size`` of it a
    rank.  The aux loss is the global one: its two [E] means are averaged
    over the dims that split the rows before their product (two
    all-reduces of E values).  The shared experts go through
    ``mlp_apply`` on the same rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    B, S, D = x.shape
    x = rows(x)
    mesh, xpl = x.device_mesh, list(x.placements)
    E, ff = p["w_up"].shape[0], p["w_up"].ndim - 1
    few = not _WEIGHT_GATHER and _moves_less(B * S, D,
                                             E * p["w_up"].shape[ff])
    split = [q.is_shard() for q in xpl]
    wpl = p["w_up"].placements
    moved = [s and few and q == Shard(ff - 1) for s, q in zip(split, wpl)]
    split = [s and not m for s, m in zip(split, moved)]
    tp = [not s and not m and not _WEIGHT_GATHER and q == Shard(ff)
          for s, m, q in zip(split, moved, wpl)]
    part = [m or t for m, t in zip(moved, tp)]
    n_rows = n_part = 1
    for i in range(mesh.ndim):
        n_rows *= mesh.size(i) if split[i] else 1
        n_part *= mesh.size(i) if part[i] else 1

    def block(w, dims):
        """w's local block: ``dims`` (d_model, d_ff) split where the
        tokens moved and where the experts' d_ff is split."""
        if _WEIGHT_GATHER:
            w = maybe_gather(w.to(x.dtype))
        want = [Shard(dims[0]) if m else Shard(dims[1]) if t else Replicate()
                for m, t in zip(moved, tp)]
        grad = [Partial() if s else q for s, q in zip(split, want)]
        return w.redistribute(mesh, want).to_local(grad_placements=grad)

    router = p["router"]["w"]
    if _WEIGHT_GATHER:
        router = maybe_gather(router.to(x.dtype))
    want = [Shard(0) if m else Replicate() for m in moved]
    router = router.redistribute(mesh, want).to_local(grad_placements=[
        Partial() if s or t else q for s, t, q in zip(split, tp, want)])
    # x is redistributed only where the tokens move: a redistribution,
    # even to the same layout, would reduce x's pending gradient here
    # rather than with the block's other pending sums
    xm = x.redistribute(mesh, [Replicate() if m else q for m, q in
                               zip(moved, xpl)]) if any(moved) else x
    xl = xm.to_local(grad_placements=[
        Partial() if pt else q if s else Replicate()
        for s, pt, q in zip(split, part, xpl)])
    (dl,), (d0,) = compute_local_shape_and_global_offset(
        torch.Size((D,)), mesh, [Shard(0) if m else Replicate()
                                 for m in moved])

    def mean(v):
        """The mean over all rows of ``v``, a mean over this rank's."""
        d = DTensor.from_local(v / n_rows, mesh, [
            Partial() if s else Replicate() for s in split],
            run_check=False, shape=v.shape, stride=v.stride())
        return d.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()

    def total(t):
        """A product over this rank's block of D, summed over the dims
        the tokens moved over."""
        for i, m in enumerate(moved):
            if m:
                t = sum_over(t, mesh, i)
        return t

    out, aux = _route(xl.reshape(-1, D)[:, d0:d0 + dl], router,
                      block(p["w_up"], (ff - 1, ff)),
                      block(p["w_gate"], (ff - 1, ff)),
                      block(p["w_down"], (ff, ff - 1)), top_k,
                      mean if n_rows > 1 else None,
                      total if any(moved) else None)
    out_pl = [Shard(2) if m else Partial() if t else q if s else Replicate()
              for s, m, t, q in zip(split, moved, tp, xpl)]
    out = DTensor.from_local(out.reshape(-1, S, dl), mesh, out_pl,
                             run_check=False, shape=x.shape,
                             stride=contiguous_stride(x.shape))
    if any(moved):
        out = out.redistribute(mesh, [q if m else o for m, o, q
                                      in zip(moved, out_pl, xpl)])
    aux = DTensor.from_local(aux / n_part if n_part > 1 else aux, mesh,
                             [Partial() if q else Replicate() for q in part],
                             run_check=False, shape=aux.shape, stride=())
    if "shared" in p:
        out = out + mlp_apply(p["shared"], x)
    return out, aux
