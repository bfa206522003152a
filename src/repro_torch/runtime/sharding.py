"""Sharding rules: DP / FSDP / TP (+pod) specs for params, caches,
activations and optimizer state (the reference's ``runtime/sharding.py``).

Baseline layout (MaxText-style 2D):
  * batch + FSDP dims ride the ('pod','data') axes (flattened),
  * tensor-parallel dims ride 'model',
  * per-tensor fallbacks when a dim is not divisible by the axis size
    (e.g. GQA kv_heads=8 on a 16-way model axis shards head_dim instead;
    odd head counts replicate).

A rule produces a tree of ``Spec``s — one entry per tensor dim, each
``None``, a mesh axis name or a tuple of names, as the reference's
``PartitionSpec`` — and ``to_placements`` turns a ``Spec`` into the DTensor
placements of a ``DeviceMesh``.  The rules read only the mesh's axis names
and sizes: ``mesh`` is a ``DeviceMesh`` or a ``(names, sizes)`` pair, so a
spec tree is built without a process group.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.models.blocks import BlockSpec, tree_map


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return (e[0] if len(e) == 1 else e) if e else None
    return e


class Spec:
    """A ``PartitionSpec``: per tensor dim ``None`` (replicated), one mesh
    axis name, or a tuple of names (the dim split over them, major
    first).  Missing trailing entries are ``None``.  As ``PartitionSpec``
    does, a one-name tuple is stored as the name and an empty one as
    ``None``.  A leaf of the tree
    helpers (it is not a tuple)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __eq__(self, other):
        return isinstance(other, Spec) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or a
    ``(names, sizes)`` pair."""
    if isinstance(mesh, tuple):
        names, sizes = mesh
        return dict(zip(names, (int(s) for s in sizes)))
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


@dataclasses.dataclass(frozen=True)
class Axes:
    """Mesh axis naming for one run."""
    batch: tuple[str, ...] = ("data",)   # DP/FSDP axes (may include 'pod')
    tp: str | None = "model"

    def sizes(self, mesh) -> tuple[int, int]:
        shape = mesh_axes(mesh)
        d = math.prod(shape[a] for a in self.batch)
        t = shape[self.tp] if self.tp is not None else 1
        return d, t


def for_mesh(mesh, layout: str = "2d") -> Axes:
    """layout '2d': DP/FSDP x TP (baseline).  layout 'fsdp': every axis is
    a batch/FSDP axis — no tensor parallelism, no per-layer activation
    all-reduces."""
    names = tuple(mesh_axes(mesh))
    if layout == "fsdp":
        return Axes(batch=names, tp=None)
    return Axes(batch=tuple(n for n in names if n != "model"), tp="model")


def _div(n, k):
    return n % k == 0


# ------------------------------------------------------------ param rules
def _attn_shardings(ax: Axes):
    f, t = ax.batch, ax.tp
    return {
        "wq": {"w": Spec(f, t)}, "wk": {"w": Spec(f, t)},
        "wv": {"w": Spec(f, t)}, "wo": {"w": Spec(t, f)},
    }


def _block_shardings(cfg, spec: BlockSpec, ax: Axes, tp: int):
    f, t = ax.batch, ax.tp
    if spec.kind == "mamba":
        d = cfg.ssm
        return {
            "ln": {"g": Spec(None)},
            "mixer": {
                "in_proj": {"w": Spec(f, t)},
                "conv_w": Spec(None, t), "conv_b": Spec(t),
                "A_log": Spec(None), "D": Spec(None), "dt_bias": Spec(None),
                "norm": {"g": Spec(t) if _div(d.d_inner, tp)
                         else Spec(None)},
                "out_proj": {"w": Spec(t, f)},
            },
        }
    p = {"ln1": {"g": Spec(None)}, "ln2": {"g": Spec(None)},
         "attn": _attn_shardings(ax)}
    if spec.moe:
        p["moe"] = {
            "router": {"w": Spec(f, None)},
            "w_up": Spec(None, f, t), "w_gate": Spec(None, f, t),
            "w_down": Spec(None, t, f),
        }
        if cfg.n_shared_experts:
            p["moe"]["shared"] = {
                "up": {"w": Spec(f, t)}, "gate": {"w": Spec(f, t)},
                "down": {"w": Spec(t, f)}}
    else:
        p["mlp"] = {"up": {"w": Spec(f, t)}, "gate": {"w": Spec(f, t)},
                    "down": {"w": Spec(t, f)}}
    if spec.cross:
        p["lnx"] = {"g": Spec(None)}
        p["xattn"] = _attn_shardings(ax)
    return p


def _stack_shardings(cfg, stack, ax: Axes, tp: int):
    out = []
    for spec in stack.blocks:
        bs = _block_shardings(cfg, spec, ax, tp)
        if not spec.shared:  # stacked leaves gain a leading layer dim
            bs = tree_map(lambda s: Spec(None, *s), bs)
        out.append(bs)
    return out


def param_shardings(cfg, mesh, ax: Axes | None = None):
    """Spec tree matching ``init_params(cfg)`` exactly."""
    ax = ax or for_mesh(mesh)
    _, tp = ax.sizes(mesh)
    f, t = ax.batch, ax.tp
    p = {
        "embed": Spec(t, None),         # vocab-sharded
        "head": Spec(f, t),
        "final_norm": {"g": Spec(None)},
        "stacks": [_stack_shardings(cfg, s, ax, tp) for s in cfg.stacks],
    }
    if cfg.encoder is not None:
        p["enc_stacks"] = [_stack_shardings(cfg, s, ax, tp)
                           for s in cfg.encoder.stacks]
        p["enc_norm"] = {"g": Spec(None)}
    return p


# ------------------------------------------------------------ cache rules
def _kv_head_spec(cfg, mesh, ax: Axes):
    """(kh_spec, hd_spec): shard kv_heads if divisible, else head_dim."""
    if ax.tp is None:
        return None, None
    tp = mesh_axes(mesh)[ax.tp]
    if _div(cfg.n_kv_heads, tp):
        return ax.tp, None
    if _div(cfg.head_dim, tp):
        return None, ax.tp
    return None, None


def cache_shardings(cfg, mesh, global_batch: int, ax: Axes | None = None):
    """Cache spec tree matching ``init_caches(cfg)``'s structure.

    batch >= dp => shard batch over DP axes; batch==1 (long-context) =>
    shard the cache SEQUENCE over the DP axes instead (context parallel).
    """
    ax = ax or for_mesh(mesh)
    dp, tp = ax.sizes(mesh)
    seq_parallel = not _div(global_batch, dp)
    bspec = None if seq_parallel else ax.batch
    sspec = ax.batch if seq_parallel else None
    kh, hd = _kv_head_spec(cfg, mesh, ax)
    out = []
    for stack in cfg.stacks:
        st = []
        for spec in stack.blocks:
            if spec.kind == "mamba":
                d = cfg.ssm
                st.append({
                    "conv": Spec(None, bspec, None,
                                 ax.tp if _div(d.d_inner + 2 * d.n_groups
                                               * d.d_state, tp) else None),
                    "ssm": Spec(None, bspec, None,
                                ax.tp if _div(d.d_state, tp) else None,
                                None),
                })
            else:
                c = {"k": Spec(None, bspec, sspec, kh, hd),
                     "v": Spec(None, bspec, sspec, kh, hd)}
                if spec.cross:
                    c["xk"] = Spec(None, bspec, sspec, kh, hd)
                    c["xv"] = Spec(None, bspec, sspec, kh, hd)
                st.append(c)
        out.append(st)
    return out


# -------------------------------------------------------------- batch rules
def batch_shardings(cfg, mesh, global_batch: int, kind: str,
                    ax: Axes | None = None):
    ax = ax or for_mesh(mesh)
    dp, _ = ax.sizes(mesh)
    bspec = ax.batch if _div(global_batch, dp) else None
    b = {"tokens": Spec(bspec, None)}
    if cfg.vision_tokens:
        b["vision_embeds"] = Spec(bspec, None, None)
    if cfg.encoder is not None:
        b["frame_embeds"] = Spec(bspec, None, None)
    return b


def opt_shardings(param_specs):
    """AdamW state mirrors param sharding (ZeRO-style: fully sharded)."""
    return {"m": param_specs, "v": param_specs, "count": Spec()}


def _axis_size(entry, shape: dict[str, int]) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        return math.prod(shape[a] for a in entry)
    return shape[entry]


def sanitize(spec_tree, shape_tree, mesh):
    """Drop sharding on any dim the axis size does not divide.

    Configs have odd dims (vocab 51865, head_dim 112, 80 ssm heads...).
    Walks the spec tree against the matching tree of tensors (the meta
    device's will do: only ``.shape`` is read) and nulls offending axes.
    """
    shape = mesh_axes(mesh)

    def fix(spec, like):
        dims = tuple(like.shape)
        ent = list(spec) + [None] * (len(dims) - len(spec))
        return Spec(*(e if e is not None and d % _axis_size(e, shape) == 0
                      else None for d, e in zip(dims, ent[:len(dims)])))

    return tree_map(fix, spec_tree, shape_tree)


def to_placements(spec: Spec, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per MESH dim,
    ``Shard(d)`` where tensor dim ``d`` names that axis, else
    ``Replicate()``.  A dim split over several axes is ``Shard(d)`` on each
    of them, major first — ``NamedSharding``'s layout, so a rank holds the
    slice that the JAX device at the same mesh coordinate holds.  A mesh
    dim of size 1 splits nothing: its placement is ``Replicate()``, the
    same layout, which leaves DTensor's sharding propagation nothing to
    refuse (some torch releases refuse views of a dim "sharded" one way).
    Raises where the spec names an axis twice, or splits a dim over axes
    in another order than the mesh's (DTensor shards a dim over mesh dims
    in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    shape = mesh_axes(mesh)
    names = list(shape)
    out = [Replicate() for _ in names]
    seen = set()
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = e if isinstance(e, tuple) else (e,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} splits over {axes}, not in "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            if i in seen:
                raise ValueError(f"{spec}: mesh axis {names[i]!r} named "
                                 "twice")
            seen.add(i)
            if shape[names[i]] > 1:
                out[i] = Shard(d)
    return out
