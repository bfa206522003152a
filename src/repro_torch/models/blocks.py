"""Residual blocks + stack runner.

A model is an ordered list of *stacks*; each stack applies its tuple of
``BlockSpec``s ``count`` times with params stacked on a leading axis.

The stack runner keeps the reference's two execution modes.  In eager
PyTorch both are a Python loop over the layers and compute the same
thing bit for bit:

  * ``tm`` (time-multiplexed, default) — the one block body re-issued
    over the layer stream (the reference's ``lax.scan``).  Prefill
    indexes the stacked params layer by layer; decode splits each stacked
    leaf once (``torch.unbind``: one host op a leaf a step); train splits
    each stacked leaf once (``torch.unbind``: backward stacks the per-layer
    grads once, where indexing would add a whole-stack zero tensor per
    layer) and rematerialises each layer in backward
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``
    of the scanned body does: ``remat_policy="full"`` saves nothing,
    ``"dots"`` saves the 2-D weight products (``aten.mm``, the
    reference's ``dots_with_no_batch_dims_saveable``).
  * ``spatial`` — the stacked params split into one set per layer first,
    then every layer applied in turn (the reference's unrolled loop, no
    remat).

``shared=True`` blocks (zamba2's shared attention) keep ONE param set that
is re-applied at every layer — the paper's time-multiplexing taken to the
weight level.  ``SharedBlocks`` (Zamba2 as published) keeps ``n_blocks``
sets beside the stacks, each re-applied in turn at its share of a list of
sites (``Sites``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.ssm_decode import MambaStack
from repro_torch.kernels.ssm_decode import rms_norm as ssm_rms_norm
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (AttnDims, Init, apply_rope,
                                       attention_apply, attention_decode,
                                       heads, init_attention, init_linear,
                                       init_mlp, init_moe, init_norm,
                                       is_dtensor, like, linear, mlp_apply,
                                       moe_apply, on_local_heads, project,
                                       rms_norm, rows)
from repro_torch.telemetry import span


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str                    # "attn" | "mamba"
    window: int | None = None    # sliding-window size (attn)
    moe: bool = False
    shared: bool = False         # params shared across layers (zamba2)
    cross: bool = False          # + cross-attention sublayer (whisper dec)
    causal: bool = True
    use_rope: bool = True


@dataclasses.dataclass(frozen=True)
class StackSpec:
    count: int
    blocks: tuple[BlockSpec, ...]


@dataclasses.dataclass(frozen=True)
class SharedBlocks:
    """Zamba2's shared transformer blocks (arXiv:2411.15242; Hugging Face
    ``Zamba2HybridLayer``): ``n_blocks`` parameter sets, site ``s`` of
    ``sites`` running set ``s % n_blocks`` before the Mamba layer whose
    index (over the model's layers, stacks of one block each) it names.
    The block takes ``concat(h, the embedding)``, 2 d_model wide, through
    RMSNorm, attention (the config's heads and head dim; logits times
    ``attn_scale``, default hd^-0.5) back to d_model, RMSNorm and a gated
    MLP (GELU on the gate) with the site's own rank-``adapter_rank``
    adapter added to gate and up, then the site's own d_model x d_model
    ``linear``; no residual inside.  Its output is added to that Mamba
    layer's input, not to the residual stream."""
    sites: tuple[int, ...]
    n_blocks: int = 2
    adapter_rank: int = 128
    attn_scale: float | None = None


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a tree of dicts, lists and tuples (a
    ``None`` is an empty subtree), and over the leaves of ``rest`` at the
    same keys and indices (trees of the same structure)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_leaves_with_path(tree, path: str = "") -> list:
    """``(path, leaf)`` in ``jax.tree_util``'s order — dict keys sorted,
    then list / tuple index — with ``path`` spelt as ``jax.tree_util.keystr``
    spells it (``['stacks'][0][0]['attn']['wq']['w']``).  ``tree_leaves``
    keeps insertion order; this is the order the reference sums and names
    leaves in (``global_norm``, checkpoints)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]


def tree_map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree (paths as ``tree_leaves_with_path``
    spells them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_stack(trees):
    """One tree of stacked leaves from trees of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)


# ----------------------------------------------------------- param builders
def init_block(init: Init, lead, cfg, spec: BlockSpec):
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if spec.kind == "mamba":
        return {"ln": init_norm(init, lead, cfg.d_model),
                "mixer": ssm_mod.init_mamba2(init, lead, cfg.ssm)}
    p = {"ln1": init_norm(init, lead, cfg.d_model),
         "attn": init_attention(init, lead, cfg.d_model, dims),
         "ln2": init_norm(init, lead, cfg.d_model)}
    if spec.moe:
        p["moe"] = init_moe(init, lead, cfg.d_model, cfg.expert_d_ff,
                            cfg.n_experts,
                            n_shared=cfg.n_shared_experts,
                            shared_d_ff=cfg.shared_expert_d_ff)
    else:
        p["mlp"] = init_mlp(init, lead, cfg.d_model, cfg.d_ff)
    if spec.cross:
        p["lnx"] = init_norm(init, lead, cfg.d_model)
        p["xattn"] = init_attention(init, lead, cfg.d_model, dims)
    return p


def init_stack(init: Init, cfg, stack: StackSpec):
    """Params for one stack: leaves [count, ...] (shared blocks unstacked)."""
    return [init_block(init, () if spec.shared else (stack.count,), cfg,
                       spec)
            for spec in stack.blocks]


def init_shared(init: Init, cfg):
    """``SharedBlocks``' params: ``blocks``, leaves [n_blocks, ...], and
    ``sites``, the per-site adapter (``adapter`` d_model -> rank, then
    ``adapter_gate`` and ``adapter_up`` rank -> d_ff) and ``linear``,
    leaves [n_sites, ...]."""
    sb, D, F = cfg.shared, cfg.d_model, cfg.d_ff
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    lead, n, r = (sb.n_blocks,), (len(sb.sites),), sb.adapter_rank
    return {"blocks": {"ln1": init_norm(init, lead, 2 * D),
                       "attn": init_attention(init, lead, D, dims, 2 * D),
                       "ln2": init_norm(init, lead, D),
                       "mlp": init_mlp(init, lead, D, F)},
            "sites": {"adapter": init_linear(init, n, D, r),
                      "adapter_gate": init_linear(init, n, r, F),
                      "adapter_up": init_linear(init, n, r, F),
                      "linear": init_linear(init, n, D, D)}}


# ------------------------------------------------------------- cache builders
def init_block_cache(cfg, spec: BlockSpec, batch: int, cache_len: int,
                     mem_len: int = 0, dtype=torch.bfloat16, lead=(),
                     device=None):
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)

    def zeros(*shape, dt=dtype):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    if spec.kind == "mamba":
        d = cfg.ssm
        conv_ch = d.d_inner + 2 * d.n_groups * d.d_state
        return {"conv": zeros(batch, d.d_conv - 1, conv_ch),
                "ssm": zeros(batch, d.n_heads, d.d_state, d.head_dim,
                             dt=torch.float32)}
    S = min(cache_len, spec.window) if spec.window else cache_len
    c = {"k": zeros(batch, S, dims.n_kv_heads, dims.head_dim),
         "v": zeros(batch, S, dims.n_kv_heads, dims.head_dim)}
    if spec.cross:
        c["xk"] = zeros(batch, mem_len, dims.n_kv_heads, dims.head_dim)
        c["xv"] = zeros(batch, mem_len, dims.n_kv_heads, dims.head_dim)
    return c


def init_stack_cache(cfg, stack: StackSpec, batch, cache_len, mem_len=0,
                     dtype=torch.bfloat16, device=None):
    return [init_block_cache(cfg, spec, batch, cache_len, mem_len, dtype,
                             lead=(stack.count,), device=device)
            for spec in stack.blocks]


def init_shared_cache(cfg, batch, cache_len, dtype=torch.bfloat16,
                      device=None):
    """The sites' K/V caches, leaves [n_sites, B, S, KH, hd]."""
    return init_block_cache(cfg, BlockSpec("attn"), batch, cache_len,
                            dtype=dtype, lead=(len(cfg.shared.sites),),
                            device=device)


def _ring_fill(like, x):
    """A zero cache shaped like ``like`` [B,W,...] holding ``x`` [B,S,...]
    in the ring layout: absolute position p at slot p % W (decode assumes
    it).  A DTensor cache is filled rank by rank: ``x`` is laid out as the
    cache is and each rank writes its own block (the cache's position dim
    must not be split)."""
    if is_dtensor(like):
        from torch.distributed.tensor import DTensor, Shard
        mesh, pl = like.device_mesh, like.placements
        if any(isinstance(p, Shard) and p.dim == 1 for p in pl):
            raise ValueError(f"a cache split over positions ({pl}) cannot "
                             "be filled by prefill")
        local = _ring_fill(like.to_local(), x.redistribute(mesh, pl)
                           .to_local())
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=like.shape, stride=like.stride())
    S, W = x.shape[1], like.shape[1]
    new = torch.zeros_like(like)
    if S <= W:
        new[:, :S] = x.to(new.dtype)
    else:
        slots = torch.arange(S - W, S, device=x.device) % W
        new[:, slots] = x[:, -W:].to(new.dtype)
    return new


# --------------------------------------------------------------- block apply
def _decode_norm(p, x, eps, extra=None):
    """``rms_norm`` of ``x`` (plus ``extra``) in a decode step: on a plain
    CUDA tensor one launch of ``kernels.ssm_decode.rms_norm`` (which has
    no backward)."""
    if x.is_cuda and not is_dtensor(x):
        return ssm_rms_norm(x, p["g"], eps, extra)
    return rms_norm(p, x if extra is None else x + extra, eps)


def _mixer_input(p, h, extra, eps, decode=False):
    """A mamba block's normed input: ``h``, plus a shared block's output
    ``extra`` where one ran before it."""
    if decode:
        return _decode_norm(p["ln"], h, eps, extra)
    return rms_norm(p["ln"], h if extra is None else h + extra, eps)


def block_apply(cfg, spec: BlockSpec, p, h, positions, memory=None,
                mem_positions=None, extra=None):
    """Full-sequence (train / prefill) application.  Returns (h, aux): aux
    is the MoE load-balance loss, 0.0 for a dense block and None for a
    mamba block (whose input takes ``extra``, see ``SharedBlocks``)."""
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    eps = cfg.norm_eps
    if spec.kind == "mamba":
        return h + rows(ssm_mod.mamba2_apply(
            p["mixer"], _mixer_input(p, h, extra, eps), dims=cfg.ssm,
            eps=eps)), None
    a = attention_apply(p["attn"], rms_norm(p["ln1"], h, eps), dims=dims,
                        positions=positions, causal=spec.causal,
                        window=spec.window, rope_theta=cfg.rope_theta,
                        use_rope=spec.use_rope)
    h = h + rows(a)
    if spec.cross:
        x = attention_apply(p["xattn"], rms_norm(p["lnx"], h, eps), dims=dims,
                            positions=positions, causal=False, window=None,
                            rope_theta=cfg.rope_theta, use_rope=False,
                            kv=memory, kv_positions=mem_positions)
        h = h + rows(x)
    inner = rms_norm(p["ln2"], h, eps)
    if spec.moe:
        out, aux = moe_apply(p["moe"], inner, top_k=cfg.top_k)
    else:
        out, aux = mlp_apply(p["mlp"], inner), 0.0
    return h + rows(out), aux


def block_decode(cfg, spec: BlockSpec, p, h, cache, pos, extra=None):
    """Single-token decode; cache is this block's dict (unstacked).  A
    mamba block's mixer runs in the profiler range ``decode.ssm_step``."""
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    eps = cfg.norm_eps
    if spec.kind == "mamba":
        with span("decode.ssm_step"):
            y, conv, ssm_st = ssm_mod.mamba2_decode(
                p["mixer"], _mixer_input(p, h, extra, eps, decode=True),
                cache["conv"], cache["ssm"], dims=cfg.ssm, eps=eps)
        return h + rows(y), {"conv": conv, "ssm": ssm_st}
    a, ck, cv = attention_decode(p["attn"], rms_norm(p["ln1"], h, eps),
                                 cache["k"], cache["v"], pos, dims=dims,
                                 window=spec.window,
                                 rope_theta=cfg.rope_theta,
                                 use_rope=spec.use_rope)
    h = h + rows(a)
    new_cache = dict(cache, k=ck, v=cv)
    if spec.cross:
        # cross K/V were filled at prefill; attend over all memory slots
        B = h.shape[0]
        q = heads(linear(p["xattn"]["wq"], rms_norm(p["lnx"], h, eps)),
                  B, 1, dims.n_kv_heads, dims.n_heads // dims.n_kv_heads,
                  dims.head_dim)

        def core(q, xk, xv, _, __):
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(),
                                  xk.to(q.dtype).float())
            logits = logits * dims.head_dim ** -0.5
            probs = torch.softmax(logits, -1).to(h.dtype)
            return torch.einsum("bhgqk,bkhd->bqhgd", probs, xv.to(h.dtype))

        o = on_local_heads(core, q, cache["xk"], cache["xv"], None, None)
        o = o.reshape(B, 1, dims.n_heads * dims.head_dim)
        h = h + rows(linear(p["xattn"]["wo"], o))
    inner = rms_norm(p["ln2"], h, eps)
    if spec.moe:
        out, _ = moe_apply(p["moe"], inner, top_k=cfg.top_k)
    else:
        out = mlp_apply(p["mlp"], inner)
    return h + rows(out), new_cache


def block_fill_cache(cfg, spec: BlockSpec, p, h_pre, cache, memory=None,
                     extra=None):
    """Populate a block's KV cache from a full prefill pass.

    h_pre is the block input (and ``extra`` a mamba block's, as in
    ``block_apply``); recomputes k/v projections (cheap vs attn)."""
    if spec.kind == "mamba":
        conv_st, ssm_st = ssm_mod.mamba2_states(
            p["mixer"], _mixer_input(p, h_pre, extra, cfg.norm_eps),
            dims=cfg.ssm)
        return dict(cache, conv=like(conv_st.to(cache["conv"].dtype),
                                     cache["conv"]),
                    ssm=like(ssm_st, cache["ssm"]))
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    B = h_pre.shape[0]
    new = _fill_kv(cfg, p["attn"], rms_norm(p["ln1"], h_pre, cfg.norm_eps),
                   cache, spec.use_rope)
    if spec.cross and memory is not None:
        Sm = memory.shape[1]
        xk = heads(linear(p["xattn"]["wk"], memory), B, Sm,
                   dims.n_kv_heads, dims.head_dim)
        xv = heads(linear(p["xattn"]["wv"], memory), B, Sm,
                   dims.n_kv_heads, dims.head_dim)
        new["xk"] = xk.to(cache["xk"].dtype)
        new["xv"] = xv.to(cache["xv"].dtype)
    return new


def _fill_kv(cfg, p, x, cache, use_rope=True):
    """``cache`` with the k and v of the normed inputs ``x`` [B,S,·] of
    attention ``p`` in its ring layout."""
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    B, S, _ = x.shape
    k = heads(linear(p["wk"], x), B, S, dims.n_kv_heads, dims.head_dim)
    v = heads(linear(p["wv"], x), B, S, dims.n_kv_heads, dims.head_dim)
    if use_rope:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
        k = apply_rope(k, pos, cfg.rope_theta)
    return dict(cache, k=_ring_fill(cache["k"], k),
                v=_ring_fill(cache["v"], v))


# ------------------------------------------------------------- shared blocks
def shared_block(cfg, pb, ps, h, x_emb, positions=None, cache=None,
                 pos=None):
    """One site of ``SharedBlocks``: block params ``pb``, site params
    ``ps``.  Full sequence (``cache`` None) or one decode token at ``pos``
    through the site's K/V ``cache``.  Returns (the output to add to the
    Mamba layer's input, the attention's normed input, the new cache or
    None)."""
    sb, eps = cfg.shared, cfg.norm_eps
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    norm = rms_norm if cache is None else _decode_norm
    x = norm(pb["ln1"], torch.cat([h, x_emb], -1), eps)
    new = None
    if cache is None:
        a = attention_apply(pb["attn"], x, dims=dims, positions=positions,
                            rope_theta=cfg.rope_theta, scale=sb.attn_scale)
    else:
        a, ck, cv = attention_decode(pb["attn"], x, cache["k"], cache["v"],
                                     pos, dims=dims,
                                     rope_theta=cfg.rope_theta,
                                     scale=sb.attn_scale)
        new = {"k": ck, "v": cv}
    a = norm(pb["ln2"], a, eps)
    r = linear(ps["adapter"], a)
    gate = linear(pb["mlp"]["gate"], a) + linear(ps["adapter_gate"], r)
    up = linear(pb["mlp"]["up"], a) + linear(ps["adapter_up"], r)
    out = linear(pb["mlp"]["down"], F.gelu(gate) * up)
    return linear(ps["linear"], out), x, new


class Sites:
    """``SharedBlocks`` over one pass of the model (mode train, prefill or
    decode): ``sites(layer, h)`` is the output of the shared block that
    runs before Mamba layer ``layer`` on its input ``h``, or None where
    none does.  ``x_emb`` is the embedding the blocks take beside ``h``;
    ``caches`` the sites' K/V (``init_shared_cache``), filled by prefill
    and read and written by decode; ``new_caches()`` gives the new ones
    (profiler range ``decode.cache_stack``): the caches given where every
    site wrote its slot in place (``attention_decode``), else stacked.  A
    site runs in the range ``decode.shared_block``
    (``prefill.shared_block``)."""

    def __init__(self, cfg, params, x_emb, mode, positions=None,
                 caches=None, pos=None):
        sb = cfg.shared
        if any(len(st.blocks) != 1 for st in cfg.stacks):
            raise ValueError("shared blocks run between the layers of "
                             "stacks of one block each")
        self.cfg, self.x_emb, self.mode = cfg, x_emb, mode
        self.positions, self.pos = positions, pos
        self.index = {layer: s for s, layer in enumerate(sb.sites)}
        self.blocks = _unbind(params["shared"]["blocks"], sb.n_blocks)
        self.sites = _unbind(params["shared"]["sites"], len(sb.sites))
        self.given = caches
        self.caches = None if caches is None \
            else _unbind(caches, len(sb.sites))
        self.span = {"prefill": "prefill.shared_block",
                     "decode": "decode.shared_block"}.get(mode)
        self.new = []

    def __contains__(self, layer: int) -> bool:
        return layer in self.index

    def __call__(self, layer: int, h):
        s = self.index.get(layer)
        if s is None:
            return None
        pb = self.blocks[s % self.cfg.shared.n_blocks]
        with span(self.span) if self.span else contextlib.nullcontext():
            if self.mode == "decode":
                out, _, new = shared_block(self.cfg, pb, self.sites[s], h,
                                           self.x_emb, cache=self.caches[s],
                                           pos=self.pos)
            else:
                out, x, _ = shared_block(self.cfg, pb, self.sites[s], h,
                                         self.x_emb, self.positions)
                new = None if self.mode == "train" else \
                    _fill_kv(self.cfg, pb["attn"], x, self.caches[s])
            if new is not None:
                self.new.append(new)
        return out

    def new_caches(self):
        with span("decode.cache_stack"):
            return _restack(self.given, self.caches, self.new)


# --------------------------------------------------------------- stack runner
def run_stack(cfg, stack: StackSpec, sp, h, positions, *, mode="train",
              memory=None, mem_positions=None, caches=None, pos=None,
              sites=None, first=0):
    """Apply one stack.  mode: train|prefill|decode.

    Returns (h, aux_sum, new_caches).  In tm mode prefill indexes the
    stacked leaves layer by layer, decode splits them once (one op a
    leaf, not one a leaf a layer: a step's host launches are its pace),
    and train splits them once and rematerialises each layer; in spatial
    mode they are split per layer first.  Shared-block params are the
    same tree at every layer.  ``sites`` (a ``Sites``) gives layer
    ``first + i`` of a stack of one block the output of the shared block
    that runs before it.  The layers' new caches are stacked inside the
    profiler range ``decode.cache_stack`` (prefill's too), but for
    leaves that every layer left as the view it was given (a decode's
    K/V written in place by ``attention_decode``, cross K/V): those are
    the stacked caches given.  A mamba layer's prefill runs in the range
    ``prefill.ssm_step``.  A decode of
    a stack of one Mamba2 block on a CUDA tensor is
    ``_mamba_stack_decode``'s.
    """
    tm = getattr(cfg, "scan_layers", True)
    specs = stack.blocks
    if mode == "decode" and _stack_decode_fused(specs, h):
        return _mamba_stack_decode(cfg, stack, sp, h, caches, sites, first)

    def step(h, params_l, cache_l, extra=None):
        aux_total = 0.0
        new_caches = []
        for j, spec in enumerate(specs):
            pj = sp[j] if spec.shared else params_l[j]
            if mode == "decode":
                h, c_new = block_decode(cfg, spec, pj, h, cache_l[j], pos,
                                        extra)
                new_caches.append(c_new)
                continue
            with span("prefill.ssm_step") if mode == "prefill" \
                    and spec.kind == "mamba" else contextlib.nullcontext():
                h_pre = h
                h_new, aux = block_apply(cfg, spec, pj, h, positions,
                                         memory, mem_positions, extra)
                if aux is not None:
                    aux_total = aux_total + aux
                if mode == "prefill":
                    new_caches.append(block_fill_cache(
                        cfg, spec, pj, h_pre, cache_l[j], memory, extra))
            h = h_new
        return h, aux_total, new_caches

    stacked = [None if s.shared else sp[j] for j, s in enumerate(specs)]
    if tm and mode == "train":
        step = _remat(step, getattr(cfg, "remat_policy", "full"))
    if tm and mode == "prefill":
        per_layer = [(tree_map(lambda x: x[i], stacked),
                      tree_map(lambda x: x[i], caches))
                     for i in range(stack.count)]
    else:
        per_layer = list(zip(_unbind(stacked, stack.count),
                             _unbind(caches, stack.count)))
    aux_layers = []
    outs = []
    for i, (params_l, cache_l) in enumerate(per_layer):
        extra = None if sites is None else sites(first + i, h)
        h, aux, c_new = step(h, params_l, cache_l, extra)
        aux_layers.append(aux)
        outs.append(c_new)
    aux = _sum_layers(aux_layers, h.device)
    if mode == "train":
        return h, aux, []
    with span("decode.cache_stack"):
        return h, aux, _restack(caches, [c for _, c in per_layer], outs)


def _stack_decode_fused(specs, h) -> bool:
    """Whether ``run_stack`` decodes a stack by ``_mamba_stack_decode``:
    a stack of one Mamba2 block, on a plain CUDA tensor."""
    return specs == (BlockSpec("mamba"),) and h.is_cuda \
        and not is_dtensor(h)


def _mamba_stack_decode(cfg, stack, sp, h, caches, sites, first):
    """``run_stack``'s decode of a stack of Mamba2 layers on plain CUDA
    tensors (``kernels.ssm_decode.MambaStack``): ``block_decode``'s
    arithmetic in fewer launches.  A layer's residual add is folded into
    the next layer's input norm (the stream updated in place in a copy of
    ``h``), and its step between the projections is one launch that
    writes its new states into the step's stacked caches (nothing left to
    stack).  A shared block's site takes the stream with every add done.
    Each layer runs in the range ``decode.ssm_step``."""
    p, eps = sp[0], cfg.norm_eps
    h = h.clone()
    run = MambaStack(p["mixer"], p["ln"]["g"], caches[0], cfg.ssm, eps, h)
    w_in = torch.unbind(p["mixer"]["in_proj"]["w"])
    w_out = torch.unbind(p["mixer"]["out_proj"]["w"])
    y = None
    for i in range(stack.count):
        extra = None
        if sites is not None and first + i in sites:
            if y is not None:
                h, y = h + y[:, None], None
            extra = sites(first + i, h)
        with span("decode.ssm_step"):
            x = run.norm(i, h, y, extra)
            y = project(run.step(i, project(x, w_in[i])), w_out[i])
    return h + y[:, None], _sum_layers([], h.device), \
        [{"conv": run.conv, "ssm": run.ssm}]


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the 2-D weight products
    (``aten.mm``; attention's einsums are ``aten.bmm`` and recompute)."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(step, policy: str):
    """``step`` rematerialised in backward under ``policy`` ("dots": the
    weight products saved; anything else, as in the reference, "full":
    nothing saved but the layer's inputs).  The model draws no random
    numbers, so no RNG state is kept."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)

    def body(*args):
        return checkpoint(step, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return body


def _unbind(tree, count):
    """The spatial layout: ``count`` per-layer trees, every stacked leaf
    split by ``torch.unbind`` before any layer runs (node by node: one
    pass over the tree)."""
    if tree is None:
        return [None] * count
    if isinstance(tree, dict):
        parts = [(k, _unbind(v, count)) for k, v in tree.items()]
        return [{k: v[i] for k, v in parts} for i in range(count)]
    if isinstance(tree, (list, tuple)):
        parts = [_unbind(v, count) for v in tree]
        return [type(tree)(v[i] for v in parts) for i in range(count)]
    return torch.unbind(tree)


def _restack(stacked, given, new):
    """A pass's new caches from ``new``, its per-layer trees:
    ``tree_stack(new)``, but a leaf that every layer returned as the view
    of ``stacked`` it was given (``given``, the per-layer trees of
    ``stacked``) is that leaf of ``stacked`` itself, nothing copied."""
    if isinstance(stacked, dict):
        return {k: _restack(v, [g[k] for g in given], [n[k] for n in new])
                for k, v in stacked.items()}
    if isinstance(stacked, (list, tuple)):
        return type(stacked)(_restack(v, [g[i] for g in given],
                                      [n[i] for n in new])
                             for i, v in enumerate(stacked))
    if len(new) == len(given) and all(n is g for n, g in zip(new, given)):
        return stacked
    return torch.stack(new)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` (``tree_leaves``'
    order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _sum_layers(aux_layers, device):
    """The per-layer aux losses summed as the reference's scan does
    (stacked, then one sum); 0.0 where no layer has one."""
    if not any(isinstance(a, torch.Tensor) for a in aux_layers):
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack([torch.as_tensor(a, dtype=torch.float32,
                                        device=device)
                        for a in aux_layers]).sum()
