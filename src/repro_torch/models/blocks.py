"""Residual blocks + stack runner.

A model is an ordered list of *stacks*; each stack applies its tuple of
``BlockSpec``s ``count`` times with params stacked on a leading axis.

The stack runner keeps the reference's two execution modes.  In eager
PyTorch both are a Python loop over the layers and compute the same
thing bit for bit:

  * ``tm`` (time-multiplexed, default) — the one block body re-issued
    over the layer stream (the reference's ``lax.scan``).  Prefill and
    decode index the stacked params layer by layer; train splits each
    stacked leaf once (``torch.unbind``: backward stacks the per-layer
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
weight level.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (AttnDims, Init, apply_rope,
                                       attention_apply, attention_decode,
                                       heads, init_attention, init_mlp,
                                       init_moe, init_norm, is_dtensor, like,
                                       linear, mlp_apply, moe_apply,
                                       on_local_heads, rms_norm, rows)
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
def block_apply(cfg, spec: BlockSpec, p, h, positions, memory=None,
                mem_positions=None):
    """Full-sequence (train / prefill) application.  Returns (h, aux): aux
    is the MoE load-balance loss, 0.0 for a dense block and None for a
    mamba block."""
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if spec.kind == "mamba":
        return h + rows(ssm_mod.mamba2_apply(
            p["mixer"], rms_norm(p["ln"], h), dims=cfg.ssm)), None
    a = attention_apply(p["attn"], rms_norm(p["ln1"], h), dims=dims,
                        positions=positions, causal=spec.causal,
                        window=spec.window, rope_theta=cfg.rope_theta,
                        use_rope=spec.use_rope)
    h = h + rows(a)
    if spec.cross:
        x = attention_apply(p["xattn"], rms_norm(p["lnx"], h), dims=dims,
                            positions=positions, causal=False, window=None,
                            rope_theta=cfg.rope_theta, use_rope=False,
                            kv=memory, kv_positions=mem_positions)
        h = h + rows(x)
    inner = rms_norm(p["ln2"], h)
    if spec.moe:
        out, aux = moe_apply(p["moe"], inner, top_k=cfg.top_k)
    else:
        out, aux = mlp_apply(p["mlp"], inner), 0.0
    return h + rows(out), aux


def block_decode(cfg, spec: BlockSpec, p, h, cache, pos):
    """Single-token decode; cache is this block's dict (unstacked)."""
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    if spec.kind == "mamba":
        y, conv, ssm_st = ssm_mod.mamba2_decode(
            p["mixer"], rms_norm(p["ln"], h), cache["conv"], cache["ssm"],
            dims=cfg.ssm)
        return h + rows(y), {"conv": conv, "ssm": ssm_st}
    a, ck, cv = attention_decode(p["attn"], rms_norm(p["ln1"], h),
                                 cache["k"], cache["v"], pos, dims=dims,
                                 window=spec.window,
                                 rope_theta=cfg.rope_theta,
                                 use_rope=spec.use_rope)
    h = h + rows(a)
    new_cache = dict(cache, k=ck, v=cv)
    if spec.cross:
        # cross K/V were filled at prefill; attend over all memory slots
        B = h.shape[0]
        q = heads(linear(p["xattn"]["wq"], rms_norm(p["lnx"], h)),
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
    inner = rms_norm(p["ln2"], h)
    if spec.moe:
        out, _ = moe_apply(p["moe"], inner, top_k=cfg.top_k)
    else:
        out = mlp_apply(p["mlp"], inner)
    return h + rows(out), new_cache


def block_fill_cache(cfg, spec: BlockSpec, p, h_pre, cache, memory=None):
    """Populate a block's KV cache from a full prefill pass.

    h_pre is the block input; recomputes k/v projections (cheap vs attn)."""
    if spec.kind == "mamba":
        conv_st, ssm_st = ssm_mod.mamba2_states(
            p["mixer"], rms_norm(p["ln"], h_pre), dims=cfg.ssm)
        return dict(cache, conv=like(conv_st.to(cache["conv"].dtype),
                                     cache["conv"]),
                    ssm=like(ssm_st, cache["ssm"]))
    dims = AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    B, S, _ = h_pre.shape
    x = rms_norm(p["ln1"], h_pre)
    k = heads(linear(p["attn"]["wk"], x), B, S, dims.n_kv_heads,
              dims.head_dim)
    v = heads(linear(p["attn"]["wv"], x), B, S, dims.n_kv_heads,
              dims.head_dim)
    if spec.use_rope:
        pos = torch.arange(S, device=h_pre.device)[None].expand(B, S)
        k = apply_rope(k, pos, cfg.rope_theta)
    new = dict(cache, k=_ring_fill(cache["k"], k),
               v=_ring_fill(cache["v"], v))
    if spec.cross and memory is not None:
        Sm = memory.shape[1]
        xk = heads(linear(p["xattn"]["wk"], memory), B, Sm,
                   dims.n_kv_heads, dims.head_dim)
        xv = heads(linear(p["xattn"]["wv"], memory), B, Sm,
                   dims.n_kv_heads, dims.head_dim)
        new["xk"] = xk.to(cache["xk"].dtype)
        new["xv"] = xv.to(cache["xv"].dtype)
    return new


# --------------------------------------------------------------- stack runner
def run_stack(cfg, stack: StackSpec, sp, h, positions, *, mode="train",
              memory=None, mem_positions=None, caches=None, pos=None):
    """Apply one stack.  mode: train|prefill|decode.

    Returns (h, aux_sum, new_caches).  In tm mode prefill and decode
    index the stacked leaves layer by layer, and train splits them once
    and rematerialises each layer; in spatial mode they are split per
    layer first.  Shared-block params are the same tree at every layer.
    The layers' new caches are stacked inside the profiler range
    ``decode.cache_stack`` (prefill's too).
    """
    tm = getattr(cfg, "scan_layers", True)
    specs = stack.blocks

    def step(h, params_l, cache_l):
        aux_total = 0.0
        new_caches = []
        for j, spec in enumerate(specs):
            pj = sp[j] if spec.shared else params_l[j]
            if mode == "decode":
                h_new, c_new = block_decode(cfg, spec, pj, h, cache_l[j],
                                            pos)
                new_caches.append(c_new)
            else:
                h_pre = h
                h_new, aux = block_apply(cfg, spec, pj, h, positions,
                                         memory, mem_positions)
                if aux is not None:
                    aux_total = aux_total + aux
                if mode == "prefill":
                    new_caches.append(block_fill_cache(
                        cfg, spec, pj, h_pre, cache_l[j], memory))
            h = h_new
        return h, aux_total, new_caches

    stacked = [None if s.shared else sp[j] for j, s in enumerate(specs)]
    if tm and mode == "train":
        step = _remat(step, getattr(cfg, "remat_policy", "full"))
    if tm and mode != "train":
        per_layer = [(tree_map(lambda x: x[i], stacked),
                      tree_map(lambda x: x[i], caches))
                     for i in range(stack.count)]
    else:
        per_layer = list(zip(_unbind(stacked, stack.count),
                             _unbind(caches, stack.count)))
    aux_layers = []
    outs = []
    for params_l, cache_l in per_layer:
        h, aux, c_new = step(h, params_l, cache_l)
        aux_layers.append(aux)
        outs.append(c_new)
    aux = _sum_layers(aux_layers, h.device)
    if mode == "train":
        return h, aux, []
    with span("decode.cache_stack"):
        return h, aux, tree_stack(outs)


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
    split by ``torch.unbind`` before any layer runs."""
    split = [torch.unbind(x) for x in tree_leaves(tree)]
    return [tree_unflatten(tree, [s[i] for s in split])
            for i in range(count)]


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
