"""Composable LM definition covering all assigned architecture families.

A ``ModelConfig`` is a list of stacks (see blocks.py) + embedding/head and
optional encoder (whisper) / vision-stub (internvl2) plumbing.  All models
share one forward/prefill/decode implementation.

Params are a tree of float32 tensors with the reference's keys and
nesting (``stacks`` a list per stack of a list per block; shared blocks
unstacked), so a tree of numpy arrays carries weights between the two
packages: ``params_from_numpy`` checks it against ``init_params``' tree
and places it on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.vm import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.blocks import BlockSpec, SharedBlocks, StackSpec
from repro_torch.models.layers import (COMPUTE_DTYPE, Init,
                                       contiguous_stride, init_norm,
                                       is_dtensor, project, rms_norm, rows)
from repro_torch.models.ssm import SSMDims


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Whisper-style encoder: precomputed frame embeddings in, memory out."""
    stacks: tuple[StackSpec, ...]
    frame_dim: int            # stub frontend output dim (== d_model)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int
    stacks: tuple[StackSpec, ...]
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    shared_expert_d_ff: int = 0
    # SSM
    ssm: Optional[SSMDims] = None
    # enc-dec (audio)
    encoder: Optional[EncoderSpec] = None
    # VLM stub: number of precomputed patch-embedding tokens prepended
    vision_tokens: int = 0
    # execution mode: time-multiplexed (tm) vs spatial (split per layer)
    scan_layers: bool = True
    # sinusoidal absolute positions added to decoder embeddings (whisper)
    use_abs_pos: bool = False
    # remat policy for the training slice ('full' | 'dots')
    remat_policy: str = "full"
    # attention family flags
    full_attention: bool = True   # False => sub-quadratic (ssm/hybrid/local)
    aux_loss_weight: float = 0.01
    # Zamba2's (out of the repr, which the registry's configs share with
    # the reference's): its shared transformer blocks between the (mamba)
    # layers; the head the embedding's transpose (no "head" param); the
    # embedding left unscaled (the reference multiplies by sqrt(d_model))
    shared: Optional[SharedBlocks] = dataclasses.field(default=None,
                                                       repr=False)
    tie_embed: bool = dataclasses.field(default=False, repr=False)
    embed_scale: bool = dataclasses.field(default=True, repr=False)

    @property
    def n_layers(self) -> int:
        return sum(s.count * len(s.blocks) for s in self.stacks)

    def param_count(self) -> int:
        """Total params (from shapes: ``init_params`` on the meta device,
        which allocates nothing)."""
        shapes = init_params(self, device="meta")
        return sum(x.numel() for x in B.tree_leaves(shapes))

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k+shared experts only)."""
        total = self.param_count()
        if not self.n_experts:
            return total
        per_expert = 3 * self.d_model * self.expert_d_ff
        n_moe = sum(s.count for s in self.stacks
                    for b in s.blocks if b.moe)
        inactive = n_moe * (self.n_experts - self.top_k) * per_expert
        return total - inactive


def dense_stacks(n_layers: int, *, window_pattern=None, moe=False,
                 causal=True, use_rope=True) -> tuple[StackSpec, ...]:
    """Uniform dense/MoE stacks; window_pattern=(sizes...) cycles layers."""
    if window_pattern is None:
        return (StackSpec(n_layers, (BlockSpec("attn", moe=moe,
                                               causal=causal,
                                               use_rope=use_rope),)),)
    P = len(window_pattern)
    full, rem = divmod(n_layers, P)
    sts = []
    if full:
        sts.append(StackSpec(full, tuple(
            BlockSpec("attn", window=w, moe=moe) for w in window_pattern)))
    if rem:
        sts.append(StackSpec(1, tuple(
            BlockSpec("attn", window=w, moe=moe)
            for w in window_pattern[:rem])))
    return tuple(sts)


# ----------------------------------------------------------------- params
def _init_params(cfg: ModelConfig, init: Init) -> dict:
    p = {"embed": init.normal((cfg.vocab, cfg.d_model), 0.02)}
    if not cfg.tie_embed:
        p["head"] = init.normal((cfg.d_model, cfg.vocab),
                                cfg.d_model ** -0.5)
    p["final_norm"] = init_norm(init, (), cfg.d_model)
    p["stacks"] = [B.init_stack(init, cfg, s) for s in cfg.stacks]
    if cfg.encoder is not None:
        p["enc_stacks"] = [B.init_stack(init, cfg, s)
                           for s in cfg.encoder.stacks]
        p["enc_norm"] = init_norm(init, (), cfg.d_model)
    if cfg.shared is not None:
        p["shared"] = B.init_shared(init, cfg)
    return p


def _head(cfg, params):
    """The head weight [D, V]: the embedding's transpose where tied."""
    return params["embed"].t() if cfg.tie_embed else params["head"]


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None) -> dict:
    """Seeded weights drawn by ``generator`` on ``device`` (None: the CUDA
    device; ``"meta"`` for shapes only).  The shapes and scales are the
    reference's; its ``jax.random`` stream cannot be reproduced, so
    weights cross between the packages through ``params_from_numpy``."""
    return _init_params(cfg, Init.torch(generator, resolve_device(device)))


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """Weights of ``init_params``' shapes and scales drawn by
    ``numpy.random.RandomState(seed)``: a tree of float32 numpy arrays,
    for ``params_from_numpy`` and for the reference (``jnp.asarray``)."""
    tree = _init_params(cfg, Init.numpy(seed))
    return B.tree_map(lambda t: t.numpy(), tree)


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> dict:
    """The weight carrier: a tree of arrays with the reference's keys and
    nesting (``jax.tree.map(np.asarray, params)`` of the reference, or
    ``numpy_params``) as float32 tensors on ``device``.  Raises where the
    tree's keys, list lengths or shapes differ from ``init_params``'."""
    device = resolve_device(device)
    want = init_params(cfg, device="meta")

    def carry(w, a, path):
        if isinstance(w, dict):
            if not isinstance(a, dict) or set(a) != set(w):
                raise ValueError(f"params{path}: keys {sorted(a)} != "
                                 f"{sorted(w)}")
            return {k: carry(w[k], a[k], f"{path}[{k!r}]") for k in w}
        if isinstance(w, list):
            if not isinstance(a, (list, tuple)) or len(a) != len(w):
                raise ValueError(f"params{path}: expected a list of "
                                 f"{len(w)}")
            return [carry(x, y, f"{path}[{i}]")
                    for i, (x, y) in enumerate(zip(w, a))]
        arr = np.asarray(a, dtype=np.float32)
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"params{path}: shape {arr.shape} != "
                             f"{tuple(w.shape)}")
        return torch.tensor(arr, device=device)

    return carry(want, tree, "")


# ---------------------------------------------------------------- forward
def _embed(cfg, params, tokens):
    w = params["embed"].to(COMPUTE_DTYPE)
    h = _lookup(w, tokens) if is_dtensor(w) else w[tokens]
    if not cfg.embed_scale:
        return h
    # sqrt(d_model) rounded to the compute dtype, as the reference's
    # jnp.asarray(..., COMPUTE_DTYPE); a Python number, so no host copy
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=COMPUTE_DTYPE).item()
    return h * scale


def _lookup(w, tokens):
    """``w[tokens]`` for a DTensor table, as each rank computes it: the
    rank's rows of the vocab looked up locally (masked where the vocab is
    split), the result sharded as the tokens are and pending a sum over
    the vocab's axis (``Partial``); the table's gradient pending a sum
    over the tokens' axes.  DTensor's own rules cannot carry this on torch
    2.11 (the indexing's backward, an ``index_put``, fails to shard; the
    embedding op's vocab-parallel rule loses its mask)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = w.device_mesh
    tok = tokens.placements if is_dtensor(tokens) \
        else [Replicate()] * mesh.ndim
    out, grad = [], []
    for pw, pt in zip(w.placements, tok):
        split = isinstance(pw, Shard)
        if split and not isinstance(pt, Replicate):
            raise ValueError(f"vocab and tokens split on one mesh dim: "
                             f"{w.placements} / {tok}")
        out.append(Partial() if split else pt)
        grad.append(pw if split else Partial() if isinstance(pt, Shard)
                    else Replicate())
    local = w.to_local(grad_placements=grad)
    ids = tokens.to_local() if is_dtensor(tokens) else tokens
    if any(isinstance(p, Shard) for p in w.placements):
        (n, _), (v0, _) = compute_local_shape_and_global_offset(
            w.shape, mesh, w.placements)
        inside = (ids >= v0) & (ids < v0 + n)
        h = local[torch.where(inside, ids - v0, 0)] \
            * inside[..., None].to(local.dtype)
    else:
        h = local[ids]
    shape = torch.Size((*tokens.shape, w.shape[1]))
    return DTensor.from_local(h, mesh, out, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def _sinusoid(S, D, dtype, device):
    pos = np.arange(S)[:, None]
    dim = np.arange(0, D, 2)[None, :] / D
    ang = pos / (10000.0 ** dim)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.from_numpy(emb).to(device=device, dtype=dtype)


def _positions(Bsz, S, device):
    return torch.arange(S, device=device)[None].expand(Bsz, S)


def encode(cfg, params, frame_embeds):
    """Whisper encoder: frame_embeds [B,S,D] (stub frontend output)."""
    h = frame_embeds.to(COMPUTE_DTYPE) \
        + _sinusoid(frame_embeds.shape[1], cfg.d_model, COMPUTE_DTYPE,
                    frame_embeds.device)[None]
    positions = _positions(h.shape[0], h.shape[1], h.device)
    for sp, stack in zip(params["enc_stacks"], cfg.encoder.stacks):
        h, _, _ = B.run_stack(cfg, stack, sp, h, positions, mode="train")
    return rms_norm(params["enc_norm"], h, cfg.norm_eps)


def forward(cfg: ModelConfig, params, tokens, *, extra_embeds=None,
            frame_embeds=None, mode="train", caches=None):
    """Full-sequence pass.  tokens [B,S]; extra_embeds [B,Sv,D] (vision);
    frame_embeds [B,Se,D] (audio encoder input).

    Returns (logits [B,S_total,V], aux_loss, new_caches); with shared
    blocks, the sites' caches follow the stacks' (``init_caches``).
    """
    h = rows(_embed(cfg, params, tokens))
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    Bsz, S, _ = h.shape
    if cfg.use_abs_pos:
        h = h + _sinusoid(S, cfg.d_model, h.dtype, h.device)[None]
    positions = _positions(Bsz, S, h.device)
    memory, mem_pos = None, None
    if cfg.encoder is not None:
        memory = encode(cfg, params, frame_embeds)
        mem_pos = _positions(memory.shape[0], memory.shape[1], h.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
    new_caches = []
    sites = None if cfg.shared is None else B.Sites(
        cfg, params, h, mode, positions,
        None if caches is None else caches[len(cfg.stacks)])
    first = 0
    for i, (sp, stack) in enumerate(zip(params["stacks"], cfg.stacks)):
        h, aux, c = B.run_stack(
            cfg, stack, sp, h, positions, mode=mode, memory=memory,
            mem_positions=mem_pos,
            caches=None if caches is None else caches[i], sites=sites,
            first=first)
        first += stack.count
        aux_total = aux_total + aux
        new_caches.append(c)
    if sites is not None and mode == "prefill":
        new_caches.append(sites.new_caches())
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = project(h, _head(cfg, params))
    return logits, aux_total, new_caches


def loss_fn(cfg, params, batch):
    """Next-token cross entropy.  batch: tokens [B,S] (+ stub embeds)."""
    tokens = batch["tokens"]
    logits, aux, _ = forward(
        cfg, params, tokens[:, :-1],
        extra_embeds=batch.get("vision_embeds"),
        frame_embeds=batch.get("frame_embeds"), mode="train")
    # targets align with the text positions (vision prefix emits no loss)
    tgt = tokens[:, 1:]
    return _mean_nll(logits[:, -tgt.shape[1]:].float(), tgt) \
        + cfg.aux_loss_weight * aux


def _mean_nll(logits, tgt):
    """The mean over tokens of ``logsumexp(logits) - logits[tgt]``.  On a
    mesh, a vocab-parallel cross entropy: each rank keeps its block of
    rows and of the vocab (pending sums reduced first); the logsumexp's
    max and sum and the gold logit are reduced over the mesh dims that
    split the vocab; the blocks' means over rows are summed pending
    (``Partial``).  Where no mesh dim splits the vocab, a rank's block
    takes ``nll``'s own arithmetic, so a one-rank mesh is the plain path
    bit for bit."""
    def nll(lg, t):
        logz = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, t[..., None].long())[..., 0]
        return (logz - gold).mean()

    if not is_dtensor(logits):
        return nll(logits, tgt)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh = logits.device_mesh
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    lg = logits.redistribute(mesh, pl).to_local()
    (nb, ns, nv), (b0, s0, v0) = compute_local_shape_and_global_offset(
        logits.shape, mesh, pl)
    row_pl = [p if isinstance(p, Shard) and p.dim < 2 else Replicate()
              for p in pl]
    t = tgt.redistribute(mesh, row_pl).to_local() if is_dtensor(tgt) \
        else tgt[b0:b0 + nb, s0:s0 + ns]
    vocab = [i for i, p in enumerate(pl) if isinstance(p, Shard)
             and p.dim == 2]

    def over_vocab(x, op):
        """``x`` [nb, ns] reduced by ``op`` over the vocab's mesh dims."""
        shape = logits.shape[:2]
        d = DTensor.from_local(x, mesh, [Partial(op) if i in vocab else p
                                         for i, p in enumerate(row_pl)],
                               run_check=False, shape=shape,
                               stride=contiguous_stride(shape))
        return d.redistribute(mesh, row_pl).to_local()

    if vocab:
        m = over_vocab(lg.detach().amax(-1), "max")
        se = over_vocab(torch.exp(lg - m[..., None]).sum(-1), "sum")
        inside = (t >= v0) & (t < v0 + nv)
        gold = torch.gather(lg, -1, torch.where(inside, t - v0, 0)
                            [..., None].long())[..., 0]
        gold = over_vocab(torch.where(inside, gold, 0.0), "sum")
        mean = (torch.log(se) + m - gold).mean()
    else:
        mean = nll(lg, t)
    part = mean / (logits.shape[0] * logits.shape[1] // (nb * ns))
    return DTensor.from_local(part, mesh, [Partial() if isinstance(p, Shard)
                                           else Replicate() for p in row_pl],
                              run_check=False, shape=torch.Size(()),
                              stride=())


# ------------------------------------------------------------------ caches
def init_caches(cfg, batch, cache_len, mem_len=0, dtype=torch.bfloat16,
                device=None):
    """One cache tree a stack; with shared blocks, the sites' K/V
    (``blocks.init_shared_cache``) last.  Every leaf is [layers, batch,
    ...]."""
    device = resolve_device(device)
    caches = [B.init_stack_cache(cfg, s, batch, cache_len, mem_len, dtype,
                                 device=device)
              for s in cfg.stacks]
    if cfg.shared is not None:
        caches.append(B.init_shared_cache(cfg, batch, cache_len, dtype,
                                          device))
    return caches


def prefill(cfg, params, tokens, *, cache_len=None, extra_embeds=None,
            frame_embeds=None, layout="2d"):
    """Run the full prompt, returning (logits_last, caches).  With DTensor
    params the caches are DTensors laid out by ``cache_shardings`` for
    ``layout``, as decode takes them."""
    S = tokens.shape[1] + (extra_embeds.shape[1] if extra_embeds is not None
                           else 0)
    cache_len = cache_len or S
    mem_len = frame_embeds.shape[1] if frame_embeds is not None else 0
    if is_dtensor(params["embed"]):
        caches = _caches_on_mesh(cfg, params["embed"], tokens.shape[0],
                                 cache_len, mem_len, layout)
    else:
        caches = init_caches(cfg, tokens.shape[0], cache_len, mem_len,
                             device=tokens.device)
    logits, _, new_caches = forward(
        cfg, params, tokens, extra_embeds=extra_embeds,
        frame_embeds=frame_embeds, mode="prefill", caches=caches)
    return logits[:, -1], new_caches


def _caches_on_mesh(cfg, like, batch, cache_len, mem_len, layout):
    """Zero caches as DTensors on the mesh of the DTensor ``like``, placed
    by ``cache_shardings``: each rank allocates its own block alone, on
    the device of ``like``'s block."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.runtime import sharding as S
    mesh, dev = like.device_mesh, like.to_local().device
    with FakeTensorMode():   # the global shapes: no storage, no allocation
        shapes = init_caches(cfg, batch, cache_len, mem_len, device="meta")
    specs = S.sanitize(S.cache_shardings(cfg, mesh, batch,
                                         S.for_mesh(mesh, layout)),
                       shapes, mesh)

    def zeros(like, spec):
        pl = S.to_placements(spec, mesh)
        local = list(like.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(i)
        return DTensor.from_local(
            torch.zeros(local, dtype=like.dtype, device=dev), mesh, pl,
            run_check=False, shape=like.shape,
            stride=contiguous_stride(like.shape))
    return B.tree_map(zeros, shapes, specs)


def decode_step(cfg, params, caches, token, pos):
    """One token step.  token [B,1]; pos absolute position (an int, or a
    0-d tensor read once on the host).

    Returns (logits [B,V], new_caches): the K/V caches given, slot
    ``pos`` written in place, and new states (``steps.make_decode_step``
    states the contract)."""
    pos = int(pos)
    h = rows(_embed(cfg, params, token))
    if cfg.use_abs_pos:
        D = cfg.d_model
        pos_f = torch.full((), float(pos), dtype=torch.float32,
                           device=h.device)
        dim = torch.arange(0, D, 2, device=h.device) / D
        ang = pos_f / (10000.0 ** dim)
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
        h = h + emb.to(h.dtype)[None, None, :]
    new_caches = []
    sites = None if cfg.shared is None else B.Sites(
        cfg, params, h, "decode", caches=caches[len(cfg.stacks)], pos=pos)
    first = 0
    for i, (sp, stack) in enumerate(zip(params["stacks"], cfg.stacks)):
        h, _, c = B.run_stack(cfg, stack, sp, h, None, mode="decode",
                              caches=caches[i], pos=pos, sites=sites,
                              first=first)
        first += stack.count
        new_caches.append(c)
    if sites is not None:
        new_caches.append(sites.new_caches())
    h = rms_norm(params["final_norm"], h, cfg.norm_eps)
    logits = project(h, _head(cfg, params))[:, 0]
    return logits, new_caches
