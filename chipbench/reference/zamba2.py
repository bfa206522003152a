"""Plain PyTorch reference of Zamba2 (Zyphra/Zamba2-7B-Instruct; arXiv:
2411.15242) in float32: the equations of Hugging Face's
``modeling_zamba2.py`` (``Zamba2MambaMixer``'s plain path,
``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``, ``Zamba2HybridLayer``),
written out for one sequence with no cache and no batching.

* Every layer is a Mamba2 mixer after an RMSNorm, added to the residual.
  Its SSM runs as the sequential recurrence, position after position:
  ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t + D x_t``,
  with ``dt = softplus(dt_raw + dt_bias)`` floored at ``time_step_min``
  (the plain path's floor), then ``y * silu(z)`` RMS-normed over each of
  the ``mamba_ngroups`` groups of columns.
* Before each "hybrid" layer, shared block ``s % num_mem_blocks`` (``s``
  the site's index) takes ``concat(h, the embedding)`` through RMSNorm,
  rotary attention with logits scaled by ``(head_dim / 2)^-0.5``, o_proj,
  RMSNorm and the GELU-gated MLP with the site's adapter on gate and up,
  then the site's ``linear``; that output is added to the layer's input
  (before its norm), not to the residual.
* The head is the embedding's transpose; the embedding is not scaled.

Matrix products run in float32 with TF32 off (``mm="float32"``), or, for
the control, with both operands in float8 e4m3 (``mm="fp8"``, as
``dense_lm``); the recurrence and the convolution stay float32.

The weights are made here from the seed, leaf by leaf with a generator of
the leaf's own (``dense_lm.leaf_seed``); ``A_log``, ``dt_bias`` and ``D``
as the published init sets them: ``log(1..H)``, the inverse softplus of a
log-uniform dt in [time_step_min, time_step_max] floored at
time_step_floor, ones.  Nothing here comes from the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from chipbench.reference.dense_lm import (exact_float32, leaf_seed, matmul,
                                          rms_norm, rope)

#: leaves stacked over the Mamba layers, the shared blocks and the sites
MAMBA_LEAVES = ("ln", "in_proj", "conv_w", "conv_b", "A_log", "dt_bias",
                "D", "norm", "out_proj")
BLOCK_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "gate", "up", "down")
SITE_LEAVES = ("adapter", "adapter_gate", "adapter_up", "linear")


def dims(config: dict) -> dict:
    """The sizes the reference and the FLOP counts need, from the
    published configuration's keys."""
    D, H = config["hidden_size"], config["num_attention_heads"]
    types = config["layers_block_type"]
    din = config["mamba_expand"] * D
    return {"d_model": D, "n_heads": H,
            "n_kv_heads": config.get("num_key_value_heads", H),
            "head_dim": config.get("attention_head_dim", 2 * D // H),
            "d_ff": config["intermediate_size"],
            "vocab": config["vocab_size"], "n_layers": len(types),
            "sites": [i for i, t in enumerate(types) if t == "hybrid"],
            "n_blocks": config["num_mem_blocks"],
            "adapter_rank": config["adapter_rank"],
            "d_inner": din, "d_state": config["mamba_d_state"],
            "n_groups": config["mamba_ngroups"],
            "ssm_heads": config["n_mamba_heads"],
            "ssm_head_dim": din // config["n_mamba_heads"],
            "d_conv": config["mamba_d_conv"],
            "dt_limits": (config["time_step_min"], config["time_step_max"],
                          config["time_step_floor"]),
            "rope_theta": float(config.get("rope_theta", 10000.0)),
            "norm_eps": float(config["rms_norm_eps"])}


def leaf_specs(d: dict) -> list:
    """``(name, shape, scale)`` of every weight; scale None is a norm gain
    of ones, a string a published init (``make_leaf``).  Mamba leaves are
    stacked over layers, block leaves over the shared blocks, site leaves
    over the sites."""
    D, V, L, F = d["d_model"], d["vocab"], d["n_layers"], d["d_ff"]
    H, KH, hd = d["n_heads"], d["n_kv_heads"], d["head_dim"]
    din, N, G, Hs = d["d_inner"], d["d_state"], d["n_groups"], d["ssm_heads"]
    C, K = din + 2 * G * N, d["d_conv"]
    NB, NS, r = d["n_blocks"], len(d["sites"]), d["adapter_rank"]
    return [("embed", (V, D), 0.02), ("final_norm", (D,), None),
            ("ln", (L, D), None),
            ("in_proj", (L, D, 2 * din + 2 * G * N + Hs), D ** -0.5),
            ("conv_w", (L, K, C), 0.2), ("conv_b", (L, C), 0.1),
            ("A_log", (L, Hs), "A_log"), ("dt_bias", (L, Hs), "dt_bias"),
            ("D", (L, Hs), None), ("norm", (L, din), None),
            ("out_proj", (L, din, D), din ** -0.5),
            ("ln1", (NB, 2 * D), None),
            ("wq", (NB, 2 * D, H * hd), (2 * D) ** -0.5),
            ("wk", (NB, 2 * D, KH * hd), (2 * D) ** -0.5),
            ("wv", (NB, 2 * D, KH * hd), (2 * D) ** -0.5),
            ("wo", (NB, H * hd, D), (H * hd) ** -0.5),
            ("ln2", (NB, D), None), ("gate", (NB, D, F), D ** -0.5),
            ("up", (NB, D, F), D ** -0.5), ("down", (NB, F, D), F ** -0.5),
            ("adapter", (NS, D, r), D ** -0.5),
            ("adapter_gate", (NS, r, F), r ** -0.5),
            ("adapter_up", (NS, r, F), r ** -0.5),
            ("linear", (NS, D, D), D ** -0.5)]


def make_leaf(d: dict, name: str, seed: int, device) -> torch.Tensor:
    for i, (n, shape, scale) in enumerate(leaf_specs(d)):
        if n != name:
            continue
        if scale is None:
            return torch.ones(shape, dtype=torch.float32, device=device)
        if scale == "A_log":
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(a).expand(shape).clone()
        g = torch.Generator(device=device).manual_seed(leaf_seed(seed, i))
        if scale == "dt_bias":
            lo, hi, floor = d["dt_limits"]
            u = torch.rand(shape, generator=g, dtype=torch.float32,
                           device=device)
            dt = torch.exp(u * (math.log(hi) - math.log(lo))
                           + math.log(lo)).clamp(min=floor)
            return dt + torch.log(-torch.expm1(-dt))
        return torch.randn(shape, generator=g, dtype=torch.float32,
                           device=device).mul_(scale)
    raise KeyError(name)


def make_weights(d: dict, seed: int, device) -> dict:
    return {n: make_leaf(d, n, seed, device) for n, _, _ in leaf_specs(d)}


def _layer(W, names, i):
    return {n: W[n][i] for n in names}


def ssm_scan(xs, dt, A, Bm, Cm, Dv, chunk: int = 256):
    """The sequential recurrence over positions: xs [S, H, P], dt [S, H],
    A and Dv [H], Bm and Cm [S, H, N].  Returns y [S, H, P].  ``dt_t B_t
    x_t`` is formed a chunk of positions at a time; the state then steps
    one position at a time."""
    S, H, P = xs.shape
    N = Bm.shape[-1]
    decay = torch.exp(dt * A)                                # [S, H]
    state = xs.new_zeros(H, P, N)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        dbx = (dt[sl, :, None] * xs[sl])[..., None] * Bm[sl, :, None, :]
        states = torch.empty_like(dbx)                       # [c, H, P, N]
        for t in range(dbx.shape[0]):
            state = torch.addcmul(dbx[t], state, decay[c0 + t, :, None,
                                                       None],
                                  out=states[t])
        ys.append(torch.einsum("shpn,shn->shp", states, Cm[sl]))
    return torch.cat(ys) + Dv[:, None] * xs


def mamba(w, x, d, mm):
    """One Mamba2 mixer on x [S, D] (already normed)."""
    S = x.shape[0]
    din, N, G, H, P = (d["d_inner"], d["d_state"], d["n_groups"],
                       d["ssm_heads"], d["ssm_head_dim"])
    K = d["d_conv"]
    proj = mm(x, w["in_proj"])
    z, xbc, dt = proj.split([din, din + 2 * G * N, H], -1)
    # depthwise causal convolution: w[K-1] weighs the current position
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    conv = sum(pad[k:k + S] * w["conv_w"][k] for k in range(K))
    xbc = F.silu(conv + w["conv_b"])
    xs, Bm, Cm = xbc.split([din, G * N, G * N], -1)
    dt = F.softplus(dt + w["dt_bias"]).clamp(min=d["dt_limits"][0])
    A = -torch.exp(w["A_log"])
    rep = H // G
    y = ssm_scan(xs.view(S, H, P), dt, A,
                 Bm.view(S, G, N).repeat_interleave(rep, 1),
                 Cm.view(S, G, N).repeat_interleave(rep, 1), w["D"])
    y = y.reshape(S, din) * F.silu(z)
    yg = y.view(S, G, din // G)
    yg = yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True) + d["norm_eps"])
    return mm(yg.reshape(S, din) * w["norm"], w["out_proj"])


def shared_block(b, s, h, x_emb, positions, d, mm):
    """Shared block ``b`` at site ``s`` on h and the embedding [S, D]."""
    S = h.shape[0]
    H, KH, hd, eps = d["n_heads"], d["n_kv_heads"], d["head_dim"], \
        d["norm_eps"]
    x = rms_norm(torch.cat([h, x_emb], -1), b["ln1"], eps)
    q = rope(mm(x, b["wq"]).view(1, S, H, hd), positions, d["rope_theta"])
    k = rope(mm(x, b["wk"]).view(1, S, KH, hd), positions, d["rope_theta"])
    v = mm(x, b["wv"]).view(1, S, KH, hd)
    rep = H // KH
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
        * (hd / 2) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(S, H * hd)
    a = rms_norm(mm(o, b["wo"]), b["ln2"], eps)
    r = mm(a, s["adapter"])
    gate = mm(a, b["gate"]) + mm(r, s["adapter_gate"])
    up = mm(a, b["up"]) + mm(r, s["adapter_up"])
    return mm(mm(F.gelu(gate) * up, b["down"]), s["linear"])


def hidden(W, tokens, d, mm):
    """The final normed hidden states [S, D] of one sequence ``tokens``
    [S]."""
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    h = W["embed"][tokens.long()]
    x_emb = h
    site = {layer: s for s, layer in enumerate(d["sites"])}
    for i in range(d["n_layers"]):
        w = _layer(W, MAMBA_LEAVES, i)
        inp = h
        if i in site:
            s = site[i]
            inp = h + shared_block(
                _layer(W, BLOCK_LEAVES, s % d["n_blocks"]),
                _layer(W, SITE_LEAVES, s), h, x_emb, positions, d, mm)
        h = h + mamba(w, rms_norm(inp, w["ln"], d["norm_eps"]), d, mm)
    return rms_norm(h, W["final_norm"], d["norm_eps"])


def logits_at(W: dict, tokens, first: int, d: dict, mm: str = "float32"):
    """Logits [n, V] at positions ``first..`` of one sequence ``tokens``
    [S] (position j's logits predict token j + 1)."""
    f = matmul(mm)
    with exact_float32(), torch.no_grad():
        h = hidden(W, tokens, d, f)[first:]
        return f(h, W["embed"].t())
