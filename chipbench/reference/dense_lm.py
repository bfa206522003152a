"""Plain PyTorch reference of a dense decoder-only LM in float32: DeepSeek
LLM's block (the Llama block: RMSNorm, rotary attention with the halves
rotated, a SiLU-gated MLP, pre-norm residuals), its loss and AdamW.

It follows the published equations with one departure, kept because the
system under test makes it: the token embedding is multiplied by
``sqrt(hidden_size)``.  Matrix products run in float32 with TF32 off
(``mm="float32"``), or, for the control, with both operands rounded to
float8 e4m3 under a per-tensor scale (``mm="fp8"``).

The weights are made here from the seed, leaf by leaf with a generator of
the leaf's own, so one leaf can be made again alone; the harness hands
the same tensors to the program.  Nothing here comes from the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

#: e4m3's largest finite value
FP8_MAX = 448.0
#: the weights stacked over layers
LAYER_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "up", "gate", "down")


def dims(config: dict) -> dict:
    """The sizes the reference and the FLOP counts need, from a
    Hugging Face style configuration."""
    d, h = config["hidden_size"], config["num_attention_heads"]
    return {"d_model": d, "n_heads": h,
            "n_kv_heads": config.get("num_key_value_heads", h),
            "head_dim": config.get("head_dim", d // h),
            "d_ff": config["intermediate_size"],
            "vocab": config["vocab_size"],
            "n_layers": config["num_hidden_layers"],
            "rope_theta": float(config.get("rope_theta", 10000.0)),
            "norm_eps": float(config.get("rms_norm_eps", 1e-6))}


def leaf_specs(d: dict) -> list:
    """``(name, shape, scale)`` of every weight; scale None is a norm gain
    of ones.  Layer weights are stacked on a leading axis of layers."""
    D, H, KH, hd, F, V, L = (d["d_model"], d["n_heads"], d["n_kv_heads"],
                             d["head_dim"], d["d_ff"], d["vocab"],
                             d["n_layers"])
    return [("embed", (V, D), 0.02), ("head", (D, V), D ** -0.5),
            ("final_norm", (D,), None), ("ln1", (L, D), None),
            ("wq", (L, D, H * hd), D ** -0.5),
            ("wk", (L, D, KH * hd), D ** -0.5),
            ("wv", (L, D, KH * hd), D ** -0.5),
            ("wo", (L, H * hd, D), (H * hd) ** -0.5),
            ("ln2", (L, D), None), ("up", (L, D, F), D ** -0.5),
            ("gate", (L, D, F), D ** -0.5), ("down", (L, F, D), F ** -0.5)]


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1000003 + 7919 * (index + 1)) % (1 << 63)


def make_leaf(d: dict, name: str, seed: int, device) -> torch.Tensor:
    for i, (n, shape, scale) in enumerate(leaf_specs(d)):
        if n == name:
            if scale is None:
                return torch.ones(shape, dtype=torch.float32, device=device)
            g = torch.Generator(device=device).manual_seed(leaf_seed(seed, i))
            return torch.randn(shape, generator=g, dtype=torch.float32,
                               device=device).mul_(scale)
    raise KeyError(name)


def make_weights(d: dict, seed: int, device) -> dict:
    return {n: make_leaf(d, n, seed, device) for n, _, _ in leaf_specs(d)}


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off while the block runs."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    b.cuda.matmul.allow_tf32 = False
    b.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to float8 under one scale for the whole tensor (its
    largest magnitude at the format's largest value), back in float32."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    """``a @ b`` as float8 training computes it: both operands in e4m3
    forward, the incoming gradient in e5m2 backward."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _fp8(a), _fp8(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return (_reduce_to(gq @ bq.transpose(-1, -2), aq.shape),
                _reduce_to(aq.transpose(-1, -2) @ gq, bq.shape))


def _reduce_to(grad, shape):
    """A broadcast operand's gradient summed back to its shape."""
    while grad.dim() > len(shape):
        grad = grad.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and grad.shape[i] != 1:
            grad = grad.sum(i, keepdim=True)
    return grad


def matmul(mm: str):
    if mm == "float32":
        return torch.matmul
    if mm == "fp8":
        return _Fp8MatMul.apply
    raise ValueError(mm)


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rope(x, positions, theta):
    """x [B, S, H, hd]; the halves of each head rotated by position."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                        device=x.device) / hd))
    ang = positions.to(torch.float32)[:, None] * inv.to(torch.float32)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def layer(W, h, positions, d, mm):
    """One block; ``W`` holds this layer's weights."""
    B, S, D = h.shape
    H, KH, hd, eps = d["n_heads"], d["n_kv_heads"], d["head_dim"], \
        d["norm_eps"]
    x = rms_norm(h, W["ln1"], eps)
    q = rope(mm(x, W["wq"]).view(B, S, H, hd), positions, d["rope_theta"])
    k = rope(mm(x, W["wk"]).view(B, S, KH, hd), positions,
             d["rope_theta"])
    v = mm(x, W["wv"]).view(B, S, KH, hd)
    rep = H // KH
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    o = mm(probs, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H * hd)
    h = h + mm(o, W["wo"])
    x = rms_norm(h, W["ln2"], eps)
    gate = mm(x, W["gate"])
    return h + mm(mm(x, W["up"]) * (gate * torch.sigmoid(gate)),
                  W["down"])


def hidden(W, tokens, d, mm, remat=False):
    """The final normed hidden states [B, S, D] of ``tokens`` [B, S]."""
    from torch.utils.checkpoint import checkpoint
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = W["embed"][tokens.long()] * math.sqrt(d["d_model"])
    # each stacked leaf split once: its gradient is stacked once, where
    # indexing it a layer at a time would add a whole-stack zero tensor
    # for every layer
    per_layer = [dict(zip(LAYER_LEAVES, ws)) for ws in
                 zip(*(W[n].unbind(0) for n in LAYER_LEAVES))]
    for w in per_layer:
        if remat:
            h = checkpoint(layer, w, h, positions, d, mm,
                           use_reentrant=False)
        else:
            h = layer(w, h, positions, d, mm)
    return rms_norm(h, W["final_norm"], d["norm_eps"])


def loss(W, tokens, d, mm) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` [B, S] (positions
    ``0..S-2`` predict ``1..S-1``)."""
    h = hidden(W, tokens[:, :-1], d, mm, remat=True)
    logits = mm(h, W["head"])
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long())


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up, then cosine decay to a tenth of ``lr``."""
    w, total = opt["warmup_steps"], opt["total_steps"]
    if step < w:
        return opt["lr"] * step / max(w, 1)
    prog = min(max((step - w) / max(total - w, 1), 0.0), 1.0)
    return opt["lr"] * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def train(d: dict, seed: int, batches: list, opt: dict, device,
          mm: str = "float32") -> dict:
    """AdamW steps from the seed's weights, one a batch of ``batches``
    (token tensors [B, S]): each step's loss, each leaf's gradient norm as
    the optimizer takes it (clipped) at the first step, and each leaf's
    change after the last step.  The loss of a batch is the mean of its
    rows' losses, computed row by row."""
    f = matmul(mm)
    W = make_weights(d, seed, device)
    for p in W.values():
        p.requires_grad_(True)
    m = {n: torch.zeros_like(p) for n, p in W.items()}
    v = {n: torch.zeros_like(p) for n, p in W.items()}
    b1, b2 = opt["b1"], opt["b2"]
    out = {"loss": [], "grad_norm": None, "change": {}}
    with exact_float32():
        for step, tokens in enumerate(batches, start=1):
            total = 0.0
            for row in tokens:
                row_loss = loss(W, row[None], d, f) / tokens.shape[0]
                row_loss.backward()
                total += float(row_loss.detach())
            out["loss"].append(total)
            with torch.no_grad():
                grads = {n: p.grad for n, p in W.items()}
                gnorm = math.sqrt(sum(float(g.double().pow(2).sum())
                                      for g in grads.values()))
                scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
                lr = lr_at(opt, step)
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                if step == 1:
                    out["grad_norm"] = {n: float(g.norm()) * scale
                                        for n, g in grads.items()}
                for n, p in W.items():
                    g = grads[n] * scale
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + opt["eps"])
                    p.sub_(lr * (upd + opt["weight_decay"] * p))
                    p.grad = None
    del m, v
    with torch.no_grad():
        for n in list(W):
            p = W.pop(n)
            out["change"][n] = float((p - make_leaf(d, n, seed, device))
                                     .norm())
    return out


def logits_at(W: dict, tokens, first: int, d: dict, mm: str = "float32"):
    """Logits [n, V] at positions ``first..`` of one sequence ``tokens``
    [S] (position j's logits predict token j + 1)."""
    f = matmul(mm)
    with exact_float32(), torch.no_grad():
        h = hidden(W, tokens[None], d, f)[0, first:]
        return f(h, W["head"])
