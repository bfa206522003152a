"""Mamba2 (SSD — state-space duality) blocks, chunked-parallel + decode.

Implements the SSD algorithm of arXiv:2405.21060: the sequence is split
into chunks; within a chunk the dual quadratic (attention-like) form runs
as matmuls; across chunks a small recurrent state [H, N, P] is carried
from one chunk to the next (a Python loop over chunks).  Decode is the
O(1) recurrent step.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (Init, init_linear, like, linear,
                                       on_local_rows, rms_norm, silu)


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int          # N
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64    # P
    n_groups: int = 1

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
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                     device=init.device))
    return {
        "in_proj": init_linear(init, lead, dims.d_model, d_in_proj),
        "conv_w": init.normal(lead + (dims.d_conv, conv_ch), 0.2),
        "conv_b": init.full(lead + (conv_ch,), 0.0),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": init.full(lead + (H,), 1.0),
        # inverse-softplus of dt_init=0.01 so softplus(dt_bias) ~ 0.01
        "dt_bias": init.full(lead + (H,), math.log(math.expm1(0.01))),
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


def _dt_a(dt_raw, p):
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return dt, A


def _mixer_params(p):
    """The mixer's own params (all but the two projections)."""
    return {k: v for k, v in p.items() if k not in ("in_proj", "out_proj")}


def mamba2_apply(p, x, *, dims: SSMDims, chunk: int = 256):
    """Full-sequence Mamba2 block. x [B,L,D] -> [B,L,D].  The mixer
    between the projections runs on each rank's rows on a mesh
    (``on_local_rows``)."""
    proj = linear(p["in_proj"], x)
    y = on_local_rows(lambda proj, q: _mix(q, proj, dims, chunk), (proj,),
                      _mixer_params(p))
    return linear(p["out_proj"], y)


def _mix(p, proj, dims: SSMDims, chunk: int):
    B, L, _ = proj.shape
    din, N, H, G = dims.d_inner, dims.d_state, dims.n_heads, dims.n_groups
    z, xBC, dt_raw = _split_proj(proj, dims)
    xBC = _causal_conv(xBC, p["conv_w"], p["conv_b"])
    xh, Bm, Cm = _split_xbc(xBC, dims)
    dt, A = _dt_a(dt_raw, p)
    y = _ssd_chunked(xh.reshape(B, L, H, dims.head_dim), dt, A,
                     Bm.reshape(B, L, G, N), Cm.reshape(B, L, G, N),
                     p["D"], min(chunk, L))
    y = y.reshape(B, L, din) * silu(z)
    return rms_norm(p["norm"], y)


def mamba2_states(p, x, *, dims: SSMDims, chunk: int = 256):
    """Final (conv_state, ssm_state) after a full prefill of x [B,L,D]."""
    proj = linear(p["in_proj"], x)
    return on_local_rows(lambda proj, q: _states(q, proj, dims, chunk),
                         (proj,), _mixer_params(p))


def _states(p, proj, dims: SSMDims, chunk: int):
    B, L, _ = proj.shape
    N, H, G = dims.d_state, dims.n_heads, dims.n_groups
    z, xBC_raw, dt_raw = _split_proj(proj, dims)
    conv_state = xBC_raw[:, -(dims.d_conv - 1):, :]
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    xh, Bm, Cm = _split_xbc(xBC, dims)
    dt, A = _dt_a(dt_raw, p)
    ssm_state = _ssd_final_state(
        xh.reshape(B, L, H, dims.head_dim), dt, A,
        Bm.reshape(B, L, G, N), Cm.reshape(B, L, G, N), min(chunk, L))
    return conv_state, ssm_state


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


def mamba2_decode(p, x, conv_state, ssm_state, *, dims: SSMDims):
    """O(1) recurrent step.  x [B,1,D]; conv_state [B,K-1,C];
    ssm_state [B,H,N,P].  Returns (y, conv_state, ssm_state).  On a mesh
    the step runs on each rank's rows and the states come back laid out
    as they came in."""
    proj = linear(p["in_proj"], x)[:, 0]                   # [B, d_in_proj]
    y, conv, ssm = on_local_rows(
        lambda proj, cs, ss, q: _step(q, proj, cs, ss, dims, x.dtype),
        (proj, conv_state, ssm_state), _mixer_params(p))
    return linear(p["out_proj"], y)[:, None, :], like(conv, conv_state), \
        like(ssm, ssm_state)


def _step(p, proj, conv_state, ssm_state, dims: SSMDims, dtype):
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
    dt, A = _dt_a(dt_raw, p)                                # [B,H]
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
    return rms_norm(p["norm"], y), conv_state, ssm_state
