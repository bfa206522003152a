"""Mamba2 (SSD — state-space duality) blocks, chunked-parallel + decode.

Implements the SSD algorithm of arXiv:2405.21060: the sequence is split
into chunks; within a chunk the dual quadratic (attention-like) form runs
as matmuls; across chunks a small recurrent state [H, N, P] is carried
from one chunk to the next (a Python loop over chunks).  Decode is the
O(1) recurrent step: on the card, between its two projections, the
kernels of ``kernels.ssm_decode``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssm_decode import ssm_step
from repro_torch.models.layers import (Init, contiguous_stride,
                                       exchange_columns, init_linear,
                                       is_dtensor, like, linear,
                                       on_local_rows, rows, silu,
                                       sum_over)


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int          # N
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64    # P
    n_groups: int = 1
    # Zamba2's (out of the repr, which the registry's configs share with
    # the reference's): the gated norm taken over each group's d_inner /
    # n_groups columns (``Zamba2RMSNormGated``), not over the whole row;
    # ``(time_step_min, time_step_max, time_step_floor)``:
    # dt floored at time_step_min, and ``init_mamba2`` drawing the
    # published init (A_log = log(1..H); dt_bias the inverse softplus of
    # a log-uniform dt in [min, max] floored at floor); None: no floor
    # and the port's init
    group_norm: bool = dataclasses.field(default=False, repr=False)
    dt_limits: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        assert self.d_inner % self.head_dim == 0
        return self.d_inner // self.head_dim


def init_mamba2(init: Init, lead, dims: SSMDims):
    din, N, H, G = dims.d_inner, dims.d_state, dims.n_heads, dims.n_groups
    d_in_proj = 2 * din + 2 * G * N + H   # z, x, B, C, dt
    conv_ch = din + 2 * G * N             # conv over x, B, C
    p = {
        "in_proj": init_linear(init, lead, dims.d_model, d_in_proj),
        "conv_w": init.normal(lead + (dims.d_conv, conv_ch), 0.2),
        "conv_b": init.full(lead + (conv_ch,), 0.0),
    }
    if dims.dt_limits is None:
        a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                         device=init.device))
        # inverse-softplus of dt_init=0.01 so softplus(dt_bias) ~ 0.01
        dt_bias = init.full(lead + (H,), math.log(math.expm1(0.01)))
    else:
        a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                       device=init.device))
        lo, hi, floor = dims.dt_limits
        # a uniform draw from standard normals (their CDF)
        u = 0.5 * (1 + torch.erf(init.normal(lead + (H,), 2 ** -0.5)))
        dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo)) \
            .clamp(min=floor)
        dt_bias = dt + torch.log(-torch.expm1(-dt))
    return p | {
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": init.full(lead + (H,), 1.0),
        "dt_bias": dt_bias,
        "norm": {"g": init.full(lead + (din,), 1.0)},
        "out_proj": init_linear(init, lead, din, dims.d_model,
                                scale=din ** -0.5),
    }


def _split_proj(proj, dims: SSMDims):
    din, N, G = dims.d_inner, dims.d_state, dims.n_groups
    z = proj[..., :din]
    xBC = proj[..., din:2 * din + 2 * G * N]
    dt = proj[..., 2 * din + 2 * G * N:]
    return z, xBC, dt


def _split_xbc(xBC, dims: SSMDims):
    din, N, G = dims.d_inner, dims.d_state, dims.n_groups
    return (xBC[..., :din], xBC[..., din:din + G * N],
            xBC[..., din + G * N:])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv via K shifted adds (K is tiny)."""
    K = w.shape[0]
    out = xBC * w[K - 1].to(xBC.dtype)
    for k in range(1, K):
        shifted = F.pad(xBC, (0, 0, k, 0))[:, :-k]
        out = out + shifted * w[K - 1 - k].to(xBC.dtype)
    return silu(out + b.to(xBC.dtype))


def _pad_time(t, pad):
    """Zero-pad axis 1 (time) of a [b, l, ...] tensor at its end."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def _chunked(t, nc, chunk):
    """[b, nc*chunk, ...] -> [nc, b, chunk, ...] (chunk-major)."""
    b = t.shape[0]
    return t.reshape(b, nc, chunk, *t.shape[2:]).transpose(0, 1)


def _ssd_chunked(xh, dt, A, Bm, Cm, D, chunk: int):
    """SSD core. xh [b,l,h,p]; dt [b,l,h]; A [h]<0; Bm/Cm [b,l,g,n]; D [h].

    Loops over chunks carrying the [b,h,n,p] state, so peak activation
    memory is one chunk's quadratic block, not the whole sequence's.
    Returns y [b,l,h,p].
    """
    b, l_orig, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-l_orig) % chunk
    if pad:  # zero-pad the tail: dt=0, x=0 contribute nothing causally
        xh, dt, Bm, Cm = (_pad_time(t, pad) for t in (xh, dt, Bm, Cm))
    l = l_orig + pad
    nc = l // chunk
    f32 = torch.float32
    Bh = Bm.repeat_interleave(rep, dim=2)  # [b,l,h,n] groups -> heads
    Ch = Cm.repeat_interleave(rep, dim=2)
    a = dt.float() * A.float()                  # [b,l,h] log-decay <= 0
    xdt = xh * dt[..., None].to(xh.dtype)       # dt folded into inputs
    ac, xc_s, Bc_s, Cc_s, xres = (_chunked(t, nc, chunk)
                                  for t in (a, xdt, Bh, Ch, xh))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))
    hprev = torch.zeros((b, h, n, p), dtype=f32, device=xh.device)
    ys = []
    for c in range(nc):
        a_c, xc, Bc, Cc, xr = ac[c], xc_s[c], Bc_s[c], Cc_s[c], xres[c]
        cum = torch.cumsum(a_c, dim=1)               # [b,q,h]
        total = cum[:, -1:, :]                       # [b,1,h]
        # intra-chunk dual form
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # [b,q,k,h]
        Lmat = torch.where(tri[None, :, :, None], torch.exp(seg), 0.0)
        scores = torch.einsum("bqhn,bkhn->bqkh", Cc.float(),
                              Bc.float()) * Lmat
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores.to(xc.dtype), xc)
        # contribution of carried state
        y_off = torch.einsum("bqhn,bqh,bhnp->bqhp",
                             Cc.float(), torch.exp(cum), hprev)
        # new chunk state
        decay_to_end = torch.exp(total - cum)        # [b,k,h]
        S_c = torch.einsum("bkhn,bkh,bkhp->bhnp",
                           Bc.float(), decay_to_end, xc.float())
        hprev = hprev * torch.exp(total[:, 0, :])[..., None, None] + S_c
        y = y_diag.float() + y_off \
            + D.float()[None, None, :, None] * xr.float()
        ys.append(y.to(xh.dtype))
    return torch.stack(ys, 1).reshape(b, l, h, p)[:, :l_orig]


def _dt_a(dt_raw, p, dims: SSMDims):
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    if dims.dt_limits is not None:
        dt = dt.clamp(min=dims.dt_limits[0])
    A = -torch.exp(p["A_log"].float())
    return dt, A


def _mixer_params(p):
    """The mixer's own params (all but the two projections)."""
    return {k: v for k, v in p.items() if k not in ("in_proj", "out_proj")}


def _model_dim(mesh):
    """The index of ``mesh``'s ``model`` axis, or None."""
    names = mesh.mesh_dim_names or ()
    return names.index("model") if "model" in names else None


def _head_axis(proj, dims: SSMDims):
    """The mesh dim over which the mixer splits its heads, for the
    DTensor ``proj`` (the in-projection): the ``model`` axis, where it is
    larger than one, ``proj``'s rows are not split over it, and its size
    divides the heads with each rank's heads in whole groups or within
    one, and the gated norm is not taken per group.  Else None: the mixer
    then runs on each rank's rows (``on_local_rows``), as on a one-rank
    model axis, whose result is the plain path's bit for bit."""
    if not is_dtensor(proj) or dims.group_norm:
        return None
    from torch.distributed.tensor import Shard
    mesh = proj.device_mesh
    i = _model_dim(mesh)
    if i is None:
        return None
    n, H = mesh.size(i), dims.n_heads
    rep = H // dims.n_groups
    q = proj.placements[i]
    if n == 1 or (isinstance(q, Shard) and q.dim == 0) or H % n \
            or (H // n) % rep and rep % (H // n):
        return None
    return i


def head_columns(dims: SSMDims, n: int, r: int) -> np.ndarray:
    """The in-projection's columns that rank ``r`` of an ``n``-way
    ``model`` axis needs for its ``H / n`` heads, ascending, in the order
    ``_by_heads`` hands them on: its heads' z, then the conv's input —
    their x channels, B and C of their groups — then their dt."""
    din, N, H, G, P = (dims.d_inner, dims.d_state, dims.n_heads,
                       dims.n_groups, dims.head_dim)
    hl = H // n
    gl = max(hl * G // H, 1)
    c0, g0 = r * hl * P, r * hl * G // H * N
    spans = [(c0, c0 + hl * P), (din + c0, din + c0 + hl * P),
             (2 * din + g0, 2 * din + g0 + gl * N),
             (2 * din + G * N + g0, 2 * din + G * N + g0 + gl * N),
             (2 * din + 2 * G * N + r * hl, 2 * din + 2 * G * N
              + (r + 1) * hl)]
    return np.concatenate([np.arange(a, b) for a, b in spans])


def _by_heads(fn, proj, p, dims: SSMDims, axis: int):
    """``fn(q, z, xBC, dt_raw, hl, gl)`` on this rank's heads of the
    ``model`` axis (mesh dim ``axis``), as plain tensors: ``z``, ``dt_raw``
    and the conv's input — the rank's ``hl`` heads' x channels followed by
    B and C of their ``gl`` groups — are the rank's ``head_columns`` of
    the in-projection ``proj``, and the mixer's params are gathered whole
    and sliced alike into ``q``.  ``proj`` is laid out with its rows as
    ``rows`` lays them out and its columns split over the axis, as the
    column-parallel product leaves them; one all-to-all over the axis
    (``exchange_columns``) then hands each rank its heads' z, x and dt
    columns and an even piece of the B and C columns, and one all-gather
    of the pieces makes B and C whole on every rank (each keeps its
    groups').  Where the axis holds the columns whole already (weight
    gathering), each rank takes its own.  Returns ``(fn's result, proj
    so laid out, the rows layout's placements)``.  The gradient of the
    columns comes back to the rank that holds them by a reduce-scatter
    of B and C (the ranks' pieces summed) and the reverse all-to-all;
    the params' gradients are pending sums over the axis (each rank
    fills its heads' entries) and over the dims that split the rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.utils._pytree import tree_map
    mesh, last = proj.device_mesh, proj.ndim - 1
    whole = isinstance(proj.placements[axis], Replicate)
    pl = [q if isinstance(q, Shard) and q.dim == 0 else Replicate()
          for q in proj.placements]
    split = [Shard(last) if i == axis and not whole else q
             for i, q in enumerate(pl)]
    if list(proj.placements) != split:
        proj = proj.redistribute(mesh, split)
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    need = head_columns(dims, n, r)
    if whole:
        local = proj.to_local(grad_placements=[
            Partial() if i == axis else q for i, q in enumerate(split)])
        cols = local.index_select(-1, torch.as_tensor(need,
                                                      device=local.device))
    else:
        bc = 2 * dims.d_inner
        cols = exchange_columns(
            proj.to_local(grad_placements=split),
            [head_columns(dims, n, d) for d in range(n)], proj.shape[-1],
            (bc, bc + 2 * dims.n_groups * dims.d_state), mesh, axis)
    grad = [Partial() if q.is_shard() or i == axis else Replicate()
            for i, q in enumerate(pl)]
    params = tree_map(lambda w: w.redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)
        if is_dtensor(w) else w, _mixer_params(p))
    hl = dims.n_heads // n
    gl = max(hl * dims.n_groups // dims.n_heads, 1)
    dl = hl * dims.head_dim
    # the conv's channels: the proj columns of x, B and C less d_inner
    conv = torch.as_tensor(need[dl:-hl] - dims.d_inner, device=cols.device)
    h = slice(r * hl, (r + 1) * hl)
    q = {"conv_w": params["conv_w"].index_select(-1, conv),
         "conv_b": params["conv_b"].index_select(-1, conv),
         "A_log": params["A_log"][h], "D": params["D"][h],
         "dt_bias": params["dt_bias"][h],
         "norm": {"g": params["norm"]["g"][r * dl:(r + 1) * dl]}}
    return fn(q, cols[..., :dl], cols[..., dl:-hl], cols[..., -hl:], hl,
              gl), proj, pl


def mamba2_apply(p, x, *, dims: SSMDims, chunk: int = 256,
                 eps: float = 1e-6):
    """Full-sequence Mamba2 block. x [B,L,D] -> [B,L,D]; ``eps`` the gated
    norm's (the model's ``norm_eps``).

    On a mesh the mixer between the projections runs on each rank's rows
    and, over the ``model`` axis, on its share of the heads
    (``_head_axis``), as the reference's rule lays out its params
    (``in_proj P(f, t)``, ``conv_w P(None, t)``, ``norm P(t)``,
    ``out_proj P(t, f)``).  Each rank computes its block of the
    in-projection's columns and one all-to-all hands it its heads' z, x
    and dt (``_by_heads``); B and C (``2·G·N`` columns) are shared by the
    heads of a group and an all-gather makes them whole on every rank, so
    their conv runs on each: the only work done twice.  The gated norm's
    sum of squares is all-reduced over the axis.
    A rank's ``y`` columns are the K-split input of ``out_proj``."""
    proj = linear(p["in_proj"], x)
    axis = _head_axis(proj, dims)
    if axis is None:
        y = on_local_rows(lambda proj, q: _mix(q, proj, dims, chunk, eps),
                          (proj,), _mixer_params(p))
        return linear(p["out_proj"], y)
    from torch.distributed.tensor import DTensor, Shard
    mesh = proj.device_mesh

    def mean_sq(sq):
        """The mean of the squares over all heads' columns."""
        return sum_over(sq.sum(-1, keepdim=True), mesh, axis) / dims.d_inner

    y, _, pl = _by_heads(lambda q, z, xBC, dt_raw, hl, gl: _mix_heads(
        q, z, xBC, dt_raw, dims, hl, gl, chunk, eps, mean_sq), proj, p,
        dims,
        axis)
    pl[axis] = Shard(2)
    shape = torch.Size((x.shape[0], x.shape[1], dims.d_inner))
    y = DTensor.from_local(y, mesh, pl, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    return linear(p["out_proj"], y)


def _mix(p, proj, dims: SSMDims, chunk: int, eps: float):
    z, xBC, dt_raw = _split_proj(proj, dims)
    return _mix_heads(p, z, xBC, dt_raw, dims, dims.n_heads, dims.n_groups,
                      chunk, eps, None)


def _conv_heads(q, xBC, dims: SSMDims, hl: int, gl: int):
    """The conv over a rank's heads' channels, split into x [B,L,hl,P] and
    B, C [B,L,gl,N]."""
    B, L, _ = xBC.shape
    N, dl = dims.d_state, hl * dims.head_dim
    xBC = _causal_conv(xBC, q["conv_w"], q["conv_b"])
    return (xBC[..., :dl].reshape(B, L, hl, dims.head_dim),
            xBC[..., dl:dl + gl * N].reshape(B, L, gl, N),
            xBC[..., dl + gl * N:].reshape(B, L, gl, N))


def _mix_heads(q, z, xBC, dt_raw, dims: SSMDims, hl, gl, chunk, eps,
               mean_sq):
    """The mixer on ``hl`` heads of ``gl`` groups: y [B,L,hl·P] and its
    gated RMS norm (``_gated_norm``)."""
    B, L, _ = z.shape
    xh, Bm, Cm = _conv_heads(q, xBC, dims, hl, gl)
    dt, A = _dt_a(dt_raw, q, dims)
    y = _ssd_chunked(xh, dt, A, Bm, Cm, q["D"], min(chunk, L))
    return _gated_norm(q["norm"]["g"],
                       y.reshape(B, L, hl * dims.head_dim) * silu(z), dims,
                       eps, mean_sq)


def _gated_norm(g, y, dims: SSMDims, eps: float, mean_sq=None):
    """``y`` (the output times ``silu(z)``) RMS-normed with gain ``g``,
    ``rms_norm``'s arithmetic: over all ``d_inner`` columns, ``mean_sq``
    taking the mean of the squares (default: over the last dim), or with
    ``dims.group_norm`` over each group's ``d_inner / n_groups``."""
    yf = y.float()
    if dims.group_norm:
        yg = yf.unflatten(-1, (dims.n_groups, -1))
        yf = (yg * torch.rsqrt((yg * yg).mean(-1, keepdim=True)
                               + eps)).flatten(-2)
        return (yf * g).to(y.dtype)
    mean_sq = mean_sq or (lambda sq: sq.mean(-1, keepdim=True))
    return (yf * torch.rsqrt(mean_sq(yf * yf) + eps)
            * g).to(y.dtype)


def mamba2_states(p, x, *, dims: SSMDims, chunk: int = 256):
    """Final (conv_state, ssm_state) after a full prefill of x [B,L,D].
    On a mesh, by heads as ``mamba2_apply`` runs: the conv state [B,K-1,C]
    comes whole over the ``model`` axis (the in-projection's last K-1
    rows gathered), the SSM state [B,H,N,P] split by heads over it."""
    proj = linear(p["in_proj"], x)
    axis = _head_axis(proj, dims)
    if axis is None:
        return on_local_rows(lambda proj, q: _states(q, proj, dims, chunk),
                             (proj,), _mixer_params(p))
    from torch.distributed.tensor import DTensor, Shard
    mesh, K = proj.device_mesh, dims.d_conv

    def states(q, z, xBC, dt_raw, hl, gl):
        L = xBC.shape[1]
        xh, Bm, Cm = _conv_heads(q, xBC, dims, hl, gl)
        dt, A = _dt_a(dt_raw, q, dims)
        return _ssd_final_state(xh, dt, A, Bm, Cm, min(chunk, L))

    ssm, proj, pl = _by_heads(states, proj, p, dims, axis)
    B = x.shape[0]
    # the conv state: the last K - 1 rows of the in-projection, gathered
    tshape = torch.Size((B, K - 1, proj.shape[-1]))
    tail = DTensor.from_local(proj.to_local()[:, -(K - 1):], mesh,
                              proj.placements, run_check=False, shape=tshape,
                              stride=contiguous_stride(tshape))
    conv = _split_proj(rows(tail).to_local(), dims)[1]
    cshape = torch.Size((B, K - 1, conv.shape[-1]))
    shape = torch.Size((B, dims.n_heads, dims.d_state, dims.head_dim))
    conv = DTensor.from_local(conv, mesh, pl, run_check=False, shape=cshape,
                              stride=contiguous_stride(cshape))
    pl[axis] = Shard(1)
    return conv, DTensor.from_local(ssm, mesh, pl, run_check=False,
                                    shape=shape,
                                    stride=contiguous_stride(shape))


def _states(p, proj, dims: SSMDims, chunk: int):
    z, xBC_raw, dt_raw = _split_proj(proj, dims)
    conv_state = xBC_raw[:, -(dims.d_conv - 1):, :]
    xh, Bm, Cm = _conv_heads(p, xBC_raw, dims, dims.n_heads, dims.n_groups)
    dt, A = _dt_a(dt_raw, p, dims)
    return conv_state, _ssd_final_state(xh, dt, A, Bm, Cm,
                                        min(chunk, proj.shape[1]))


def _ssd_final_state(xh, dt, A, Bm, Cm, chunk):
    b, l, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-l) % chunk
    if pad:  # zero tail: dt=0 & x=0 leave the state untouched
        xh, dt, Bm, Cm = (_pad_time(t, pad) for t in (xh, dt, Bm, Cm))
        l += pad
    nc = l // chunk
    Bh = Bm.repeat_interleave(rep, dim=2)
    a = dt.float() * A.float()
    xdt = (xh * dt[..., None].to(xh.dtype)).float()
    hfin = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    for a_c, xc, Bc in zip(_chunked(a, nc, chunk), _chunked(xdt, nc, chunk),
                           _chunked(Bh, nc, chunk)):
        cum = torch.cumsum(a_c, dim=1)
        total = cum[:, -1:, :]
        decay_to_end = torch.exp(total - cum)
        S_c = torch.einsum("bkhn,bkh,bkhp->bhnp", Bc.float(),
                           decay_to_end, xc)
        hfin = hfin * torch.exp(total[:, 0, :])[..., None, None] + S_c
    # state layout used by decode: [B,H,N,P]
    return hfin


def _state_axis(conv_state, ssm_state):
    """The mesh dim over which decode splits the states as
    ``cache_shardings`` lays them out: the ``model`` axis where it splits
    both the SSM state's ``d_state`` and the conv state's channels (the
    rule splits each only where the axis divides it).  Else None."""
    if not is_dtensor(ssm_state):
        return None
    from torch.distributed.tensor import Shard
    i = _model_dim(ssm_state.device_mesh)
    return i if i is not None and ssm_state.placements[i] == Shard(2) \
        and conv_state.placements[i] == Shard(2) else None


def mamba2_decode(p, x, conv_state, ssm_state, *, dims: SSMDims,
                  eps: float = 1e-6):
    """O(1) recurrent step.  x [B,1,D]; conv_state [B,K-1,C];
    ssm_state [B,H,N,P]; ``eps`` the gated norm's.  Returns (y,
    conv_state, ssm_state); the states come back laid out as they came
    in.

    On a mesh whose ``model`` axis splits the states (``_state_axis``:
    the SSM state over ``d_state``, the conv state over its channels)
    each rank updates its own slices and no step gathers the SSM state:
    the step's in-projection (one token a row) is made whole, the conv
    runs on the rank's channels and its output [B, C] is gathered, the
    rank's ``N / tp`` slice of the state is updated with its slice of B,
    and ``y = Σ_n C[n]·state[n]`` is a pending sum, all-reduced once
    ([B, H, P]).  Elsewhere, and where the gated norm is taken per group,
    the step runs on each rank's rows (``on_local_rows``)."""
    proj = linear(p["in_proj"], x)[:, 0]                   # [B, d_in_proj]
    axis = None if dims.group_norm else _state_axis(conv_state, ssm_state)
    if axis is None:
        y, conv, ssm = on_local_rows(
            lambda proj, cs, ss, q: _step(q, proj, cs, ss, dims, x.dtype,
                                          eps),
            (proj, conv_state, ssm_state), _mixer_params(p))
        return linear(p["out_proj"], y)[:, None, :], \
            like(conv, conv_state), like(ssm, ssm_state)
    return _step_split(p, proj, conv_state, ssm_state, dims, axis, x.dtype,
                       eps)


def _step_split(p, proj, conv_state, ssm_state, dims: SSMDims, axis: int,
                dtype, eps: float):
    """``mamba2_decode`` with the states split over mesh dim ``axis``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils._pytree import tree_map
    mesh = ssm_state.device_mesh
    pl = [Replicate() if i == axis else q
          for i, q in enumerate(ssm_state.placements)]

    def wrap(t, shape, on_axis=Replicate()):
        """The rows ``t`` as a DTensor, ``on_axis`` its placement over the
        axis."""
        pls = [on_axis if i == axis else q for i, q in enumerate(pl)]
        return DTensor.from_local(t, mesh, pls, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))

    q = tree_map(lambda w: w.redistribute(mesh, [Replicate()] * mesh.ndim)
                 .to_local() if is_dtensor(w) else w, _mixer_params(p))
    proj = proj.redistribute(mesh, pl).to_local()
    B, Bg = proj.shape[0], ssm_state.shape[0]
    din, N, H, G, P = (dims.d_inner, dims.d_state, dims.n_heads,
                       dims.n_groups, dims.head_dim)
    n, r = mesh.size(axis), mesh.get_local_rank(axis)
    z, xBC, dt_raw = _split_proj(proj, dims)
    # conv over (state ++ current), on this rank's channels
    cs = conv_state.to_local()
    C = xBC.shape[-1]
    ch = slice(r * C // n, (r + 1) * C // n)
    full = torch.cat([cs, xBC[:, None, ch].to(cs.dtype)], 1)
    w = q["conv_w"][:, ch].to(full.dtype)
    conv = torch.einsum("bkc,kc->bc", full, w) + q["conv_b"][ch].to(w.dtype)
    conv = wrap(silu(conv), (Bg, C), Shard(1)).redistribute(mesh, pl) \
        .to_local()
    xh, Bm, Cm = _split_xbc(conv, dims)
    dt, A = _dt_a(dt_raw, q, dims)                                # [B,H]
    ns = slice(r * N // n, (r + 1) * N // n)
    rep = H // G
    Bh = Bm.reshape(B, G, N)[..., ns].repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B, G, N)[..., ns].repeat_interleave(rep, dim=1).float()
    xhh = xh.reshape(B, H, P).float()
    decay = torch.exp(dt * A)                               # [B,H]
    ss = ssm_state.to_local() * decay[..., None, None] \
        + torch.einsum("bhn,bh,bhp->bhnp", Bh, dt, xhh)
    y = wrap(torch.einsum("bhn,bhnp->bhp", Ch, ss), (Bg, H, P), Partial()) \
        .redistribute(mesh, pl).to_local()
    y = y + q["D"].float()[None, :, None] * xhh
    y = _gated_norm(q["norm"]["g"], y.reshape(B, din).to(dtype) * silu(z),
                    dims, eps)
    out = linear(p["out_proj"], wrap(y, (Bg, din)))[:, None, :]
    return (out,
            DTensor.from_local(full[:, 1:], mesh, conv_state.placements,
                               run_check=False, shape=conv_state.shape,
                               stride=conv_state.stride()),
            DTensor.from_local(ss, mesh, ssm_state.placements,
                               run_check=False, shape=ssm_state.shape,
                               stride=ssm_state.stride()))


def _step(p, proj, conv_state, ssm_state, dims: SSMDims, dtype, eps):
    """The step between the projections: on a CUDA tensor the kernels of
    ``kernels.ssm_decode``, else ``_step_plain``."""
    if proj.is_cuda:
        return ssm_step(p, proj, conv_state, ssm_state, dims, eps)
    return _step_plain(p, proj, conv_state, ssm_state, dims, dtype, eps)


def _step_plain(p, proj, conv_state, ssm_state, dims: SSMDims, dtype,
                eps: float):
    B = proj.shape[0]
    din, N, H, G = dims.d_inner, dims.d_state, dims.n_heads, dims.n_groups
    z, xBC, dt_raw = _split_proj(proj, dims)
    # conv over (state ++ current)
    full = torch.cat([conv_state, xBC[:, None, :].to(conv_state.dtype)], 1)
    w = p["conv_w"].to(full.dtype)
    conv = torch.einsum("bkc,kc->bc", full, w) + p["conv_b"].to(full.dtype)
    conv = silu(conv)
    conv_state = full[:, 1:]
    xh, Bm, Cm = _split_xbc(conv, dims)
    dt, A = _dt_a(dt_raw, p, dims)                                # [B,H]
    rep = H // G
    Bh = Bm.reshape(B, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(B, G, N).repeat_interleave(rep, dim=1).float()
    xhh = xh.reshape(B, H, dims.head_dim).float()
    decay = torch.exp(dt * A)                               # [B,H]
    ssm_state = ssm_state * decay[..., None, None] \
        + torch.einsum("bhn,bh,bhp->bhnp", Bh, dt, xhh)
    y = torch.einsum("bhn,bhnp->bhp", Ch, ssm_state) \
        + p["D"].float()[None, :, None] * xhh
    y = y.reshape(B, din).to(dtype) * silu(z)
    return _gated_norm(p["norm"]["g"], y, dims, eps), conv_state, ssm_state
