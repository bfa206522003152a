"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
process group of 256 or 512 ranks (the reference's ``launch/dryrun.py``).

For each cell this writes artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json:
  * memory (per-device bytes: arguments, outputs, the traced peak's temp),
  * cost (per-device FLOPs and bytes accessed of the eager local ops),
  * per-collective wire bytes (ring model) of the functional collectives
    DTensor issues,
  * the three roofline terms (compute / memory / collective seconds) with
    one H100's constants, and MODEL_FLOPS = 6 N_active D (train) or
    2 N_active D (serve).

Usage:
  python -m repro_torch.launch.dryrun --arch deepseek-7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]

There is no HLO in PyTorch, so the port traces its own step instead of
compiling it.  The state is DTensors on the production ``DeviceMesh`` of a
``fake`` process group (one process; its collectives move nothing) whose
local shards are meta tensors: no storage.  The port's own
``make_train_step`` / ``make_prefill_step`` / ``make_decode_step`` runs
once on them inside ``_Tracer``, a dispatch mode that lets DTensor
desugar each op first (as ``CommDebugMode`` does) and so sees what ONE
rank runs: its local ops, and the functional collectives of every
redistribution.  It counts their FLOPs, bytes and collectives and the
peak of the local storage alive.  ``mesh=None`` traces the same step on
plain meta tensors.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCHS, SHAPES, get_config,
                                 get_smoke_config, skip_reason)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.blocks import tree_leaves, tree_map
from repro_torch.runtime import optim as O
from repro_torch.runtime import sharding as S
from repro_torch.runtime import steps as St

# ------------------------------------------------------- hardware constants
#: dense bf16 tensor-core FLOP/s of one H100 SXM (NVIDIA's datasheet)
PEAK_FLOPS = 989e12
#: HBM3 B/s of one H100 SXM (NVIDIA's datasheet)
HBM_BW = 3.35e12
#: B/s a GPU across nodes: one 400 Gb/s NDR InfiniBand NIC a GPU, a DGX
#: H100 node's scale-out port.  The (16, 16) mesh of 8-GPU nodes crosses
#: nodes on both axes, so the NIC, not NVLink 4 (450 GB/s a direction
#: inside a node), bounds a ring over either of them.
LINK_BW = 50e9

#: the functional collectives DTensor issues -> the reference's HLO kinds;
#: ``shard_dim_alltoall`` is DTensor's Shard(i) -> Shard(j) move
_KINDS = {"all_reduce": "all-reduce",
          "all_reduce_coalesced": "all-reduce",
          "all_gather_into_tensor": "all-gather",
          "all_gather_into_tensor_coalesced": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "reduce_scatter_tensor_coalesced": "reduce-scatter",
          "all_to_all_single": "all-to-all",
          "shard_dim_alltoall": "all-to-all"}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor")

def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Per-device wire bytes of one collective (ring model), ``nbytes``
    being its result's size: the reference's ``parse_collectives``
    arithmetic."""
    g = max(group, 2)
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2 * nbytes * frac           # ring: reduce-scatter+all-gather
    if kind == "all-gather":
        return nbytes * frac               # result is the gathered buffer
    if kind == "reduce-scatter":
        return nbytes * g * frac           # result is the scattered shard
    if kind == "all-to-all":
        return nbytes * frac
    return nbytes                          # collective-permute


# -------------------------------------------------------------- the tracer
def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None \
        and not rets[0].alias_info.is_write


def _group_size(args, kwargs) -> int:
    """The size of a functional collective's group, named by its last
    string argument (or given as a process group)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed([*args, *kwargs.values()]):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    raise ValueError(f"no process group among {args} {kwargs}")


def all_to_all_wire_bytes(splits, row_bytes: int) -> float:
    """Per-device wire bytes of an all-to-all whose rank s sends
    ``splits[s, d]`` rows to rank d: its busiest rank's rows sent to the
    others or received from them, whichever are more (an all-to-all
    ends with its busiest rank; a rank's own split stays on the device).
    With even splits that is every rank's ``(g - 1) / g`` of its result,
    ``wire_bytes``' ring model."""
    own = splits.diagonal()
    return float(max((splits.sum(1) - own).max(),
                     (splits.sum(0) - own).max())) * row_bytes


class _Tracer(TorchDispatchMode):
    """Counts what one rank runs.  DTensor ops are left to DTensor
    (``NotImplemented``): it redistributes and calls the local op, which
    comes back here on plain (meta) tensors.  Ops that take or make fake
    tensors are DTensor's shape propagation at the global shape, not
    work: skipped.

    ``flops`` (``torch.utils.flop_counter``'s formulas), ``bytes`` (each
    non-view op's tensor inputs and outputs), ``collectives`` (kind,
    result bytes, group, wire bytes) and ``peak_bytes``: the most
    local storage alive at once — the arguments (``hold``) and every
    storage an op returned, each dropped when it dies.  Inside it a
    Shard(i) -> Shard(j) move is one all-to-all, as on an NCCL mesh
    (``_alltoall_as_on_nccl``), and an all-to-all of
    ``layers._all_to_all`` is counted by its busiest rank: the traced
    rank sees only its own splits, so the whole split matrix is noted
    as the call goes by (``_noted_all_to_all``)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor, self._fake = DTensor, FakeTensor
        self._flop = flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: list[dict] = []
        self._live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._splits = None

    def __enter__(self):
        self._alltoall = _alltoall_as_on_nccl()
        self._alltoall.__enter__()
        self._real_all_to_all, L._all_to_all = L._all_to_all, \
            self._noted_all_to_all
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            L._all_to_all = self._real_all_to_all
            self._alltoall.__exit__(None, None, None)

    def _noted_all_to_all(self, t, splits, r, group):
        self._splits = splits
        try:
            return self._real_all_to_all(t, splits, r, group)
        finally:
            self._splits = None

    def hold(self, tensors) -> None:
        """Track ``tensors``' storages as alive."""
        for t in tensors:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        if func is torch.ops.aten.equal.default and all(
                a.is_meta for a in args):
            # a check on values (DTensor's mask buffer asks it): meta
            # tensors have none, and equal shapes are all there is to see
            return args[0].shape == args[1].shape
        out = func(*args, **kwargs)
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if any(isinstance(a, self._fake) for a in ins + outs):
            return out
        for o in outs:
            self._track(o)
        self.ops += 1
        ns, _, name = str(func._overloadpacket).partition(".")
        if ns in _COLLECTIVE_NS:
            if name in _KINDS:
                kind, group = _KINDS[name], _group_size(args, kwargs)
                for o in outs:
                    size = o.numel() * o.element_size()
                    wire = wire_bytes(kind, size, group)
                    if name == "all_to_all_single" \
                            and self._splits is not None:
                        wire = all_to_all_wire_bytes(
                            self._splits,
                            math.prod(o.shape[1:]) * o.element_size())
                    self.collectives.append({
                        "kind": kind, "bytes": size, "group": group,
                        "wire_bytes": wire})
            return out
        fn = self._flop.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        if not _is_view(func) and not name.startswith("empty"):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        return out


@contextlib.contextmanager
def _alltoall_as_on_nccl():
    """DTensor's Shard(i) -> Shard(j) move lowered as on an NCCL mesh,
    whatever the mesh's device type: one ``_dtensor.shard_dim_alltoall``
    (an all-to-all of the local shard).  On a ``cpu`` mesh, the dry run's,
    DTensor would lower it to an all-gather and a chunk (gloo has no
    all-to-all), which the tracer would count as an all-gather of the
    whole.  The rebinding holds in every module of DTensor that imported
    ``shard_dim_alltoall``, for the ``with`` block alone."""
    from torch.distributed.tensor import _collective_utils as cu
    real = cu.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("torch.distributed.tensor")
            and getattr(m, "shard_dim_alltoall", None) is real]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m in mods:
            m.shard_dim_alltoall = real


@dataclasses.dataclass
class Traced:
    """One traced step: what ``run_cell`` reads (the reference's
    ``Compiled``)."""
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    flops: float
    bytes_accessed: float
    collectives: list
    ops: int

    def memory_analysis(self) -> dict:
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "temp_size_in_bytes": self.peak_bytes - self.argument_bytes,
                "generated_code_size_in_bytes": 0,
                "note": "traced eager PyTorch on meta shards: temp is the "
                        "peak of live local storage less the arguments; "
                        "no code is generated"}

    def cost_analysis(self) -> dict:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.bytes_accessed),
                "local_ops": float(self.ops)}


def _local_tensors(tree) -> list:
    """The local (meta) tensors of a tree of tensors and DTensors."""
    return [x.to_local() if L.is_dtensor(x) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """The bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


# -------------------------------------------------------------- input specs
def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape: str, spatial: bool = False,
                remat: str = "full", smoke: bool = False):
    """Meta-tensor stand-ins (shape and dtype, no storage) for every model
    input of one cell; ``smoke`` takes the arch's smoke config."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if spatial:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    if remat != "full":
        cfg = dataclasses.replace(cfg, remat_policy=remat)
    seq, gbatch, kind = SHAPES[shape]
    batch = {}
    if kind in ("train", "prefill"):
        batch["tokens"] = _sds((gbatch, seq), torch.int32)
        if cfg.vision_tokens:
            batch["tokens"] = _sds((gbatch, seq - cfg.vision_tokens),
                                   torch.int32)
            batch["vision_embeds"] = _sds(
                (gbatch, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
        if cfg.encoder is not None:
            batch["frame_embeds"] = _sds((gbatch, seq, cfg.d_model),
                                         torch.bfloat16)
    else:  # decode
        batch["tokens"] = _sds((gbatch, 1), torch.int32)
    return cfg, batch, (seq, gbatch, kind)


def _place(like: torch.Tensor, spec, mesh):
    """``like`` as a DTensor on ``mesh`` with ``spec``'s placements, its
    local shard a meta tensor of the local shape.  ``spec`` is sanitized:
    every split divides."""
    from torch.distributed.tensor import DTensor, Shard
    pl = S.to_placements(spec, mesh)
    local = list(like.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(_sds(local, like.dtype), mesh, pl,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def trace_step(cfg, batch, kind: str, seq: int, gbatch: int, mesh=None,
               layout: str = "2d", mixed: bool = False):
    """The reference's ``lower_cell``: trace one step of ``cfg`` on
    ``batch`` (meta stand-ins, global shapes) placed on ``mesh`` (any
    ``DeviceMesh`` with the production axis names; None: plain meta
    tensors), with weight gathering on for ``layout="fsdp"`` and off again
    after.  Returns ``(Traced, t_setup_s, t_trace_s)``."""
    t0 = time.time()
    ax = S.for_mesh(mesh, layout) if mesh is not None else None

    def placed(tree, rule, *rule_args):
        """``tree`` placed by the sharding ``rule``; as it is on no mesh."""
        if mesh is None:
            return tree
        specs = rule(cfg, mesh, *rule_args, ax)
        if isinstance(tree, dict):
            specs = {k: specs[k] for k in tree}
        return tree_map(lambda x, sp: _place(x, sp, mesh), tree,
                        S.sanitize(specs, tree, mesh))

    params = M.init_params(cfg, device="meta")
    if mixed:
        params = tree_map(lambda x: _sds(x.shape, torch.bfloat16), params)
    params = placed(params, S.param_shardings)
    batch = placed(batch, S.batch_shardings, gbatch, kind)
    if kind == "train":
        opt = O.init_opt_mixed(params) if mixed else O.init_opt(params)
        step = St.make_train_step(cfg, O.OptConfig(), mixed=mixed,
                                  donate=True)
        args = (params, opt, batch)
    elif kind == "prefill":
        step = St.make_prefill_step(cfg, layout=layout)
        args = (params, batch)
    else:
        caches = placed(M.init_caches(cfg, gbatch, seq,
                                      mem_len=seq if cfg.encoder else 0,
                                      device="meta"),
                        S.cache_shardings, gbatch)
        step = St.make_decode_step(cfg)
        args = (params, caches, batch["tokens"], seq - 1)
    t_setup = time.time() - t0
    t0 = time.time()
    tracer = _Tracer()
    local_args = _local_tensors(args)
    arg_bytes = _storage_bytes(local_args)
    L.set_weight_gather(layout == "fsdp")
    try:
        with tracer:
            tracer.hold(local_args)
            with St._dtensor_mode(mesh is not None):
                out = step(*args)
    finally:
        L.set_weight_gather(False)
    t_trace = time.time() - t0
    return Traced(arg_bytes, _storage_bytes(_local_tensors(out)),
                  tracer.peak_bytes, tracer.flops, tracer.bytes,
                  tracer.collectives, tracer.ops), t_setup, t_trace


# ---------------------------------------------------------------- the mesh
def fake_world(n: int) -> None:
    """A ``fake`` default process group of ``n`` ranks in this process
    (rank 0; its collectives move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def production_mesh(mesh_name: str):
    """The production mesh of ``mesh_name`` ("single": (16, 16), "multi":
    (2, 16, 16)) over a fake world of its size."""
    multi = mesh_name == "multi"
    fake_world(512 if multi else 256)
    return make_production_mesh(multi_pod=multi, device_type="cpu")


def run_cell(arch: str, shape: str, mesh_name: str, outdir: str,
             spatial: bool = False, layout: str = "2d",
             mixed: bool = False, remat: str = "full", *, mesh=None,
             smoke: bool = False):
    """Trace one cell and write its record.  ``mesh`` (default: the
    production mesh of ``mesh_name``) and ``smoke`` (the arch's smoke
    config) let tests and the card run small cells."""
    reason = skip_reason(arch, shape)
    variant = ("" if layout == "2d" else f"_{layout}") + \
        ("_mixed" if mixed else "") + \
        ("" if remat == "full" else f"_remat-{remat}")
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "mode": "spatial" if spatial else "tm",
           "layout": layout, "mixed": mixed, "remat": remat}
    fname = os.path.join(
        outdir, f"{arch}_{shape}_{mesh_name}{variant}.json".replace("/", "-"))
    if reason:
        rec["skipped"] = reason
        _write(fname, rec)
        print(f"[skip] {arch} x {shape} ({mesh_name}): {reason}")
        return rec
    try:
        mesh = mesh if mesh is not None else production_mesh(mesh_name)
        n_chips = mesh.size()
        cfg, batch, (seq, gbatch, kind) = input_specs(arch, shape, spatial,
                                                      remat, smoke)
        traced, t_lo, t_co = trace_step(cfg, batch, kind, seq, gbatch, mesh,
                                        layout, mixed)
    except Exception as e:  # a failure here is a bug in the system
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        _write(fname, rec)
        print(f"[FAIL] {arch} x {shape} ({mesh_name}): {rec['error']}")
        return rec
    rec["memory"] = traced.memory_analysis()
    rec["cost"] = traced.cost_analysis()
    agg = {}
    for c in traced.collectives:
        a = agg.setdefault(c["kind"], {"count": 0, "wire_bytes": 0.0})
        a["count"] += 1
        a["wire_bytes"] += c["wire_bytes"]
    rec["collectives"] = agg
    coll_bytes = sum(a["wire_bytes"] for a in agg.values())

    hlo_flops = rec["cost"]["flops"]
    hlo_bytes = rec["cost"]["bytes accessed"]
    # model FLOPs: 6 N D train, 2 N D serve (active params for MoE)
    n_active = cfg.active_param_count()
    tokens = gbatch * (seq if kind != "decode" else 1)
    model_flops = (6 if kind == "train" else 2) * n_active * tokens
    rec["roofline"] = {
        "chips": n_chips,
        "hlo_flops_per_device": hlo_flops,
        "hlo_bytes_per_device": hlo_bytes,
        "collective_wire_bytes_per_device": coll_bytes,
        "t_compute_s": hlo_flops / PEAK_FLOPS,
        "t_memory_s": hlo_bytes / HBM_BW,
        "t_collective_s": coll_bytes / LINK_BW,
        "model_flops_total": model_flops,
        "model_flops_per_device": model_flops / n_chips,
        "useful_flops_ratio": (model_flops / n_chips) / hlo_flops
        if hlo_flops else None,
    }
    terms = {k: rec["roofline"][f"t_{k}_s"]
             for k in ("compute", "memory", "collective")}
    rec["roofline"]["bottleneck"] = max(terms, key=terms.get)
    rec["timing"] = {"lower_s": t_lo, "compile_s": t_co}
    _write(fname, rec)
    print(f"[ok] {arch} x {shape} ({mesh_name}): "
          f"compute {terms['compute']:.4f}s memory {terms['memory']:.4f}s "
          f"coll {terms['collective']:.4f}s -> "
          f"{rec['roofline']['bottleneck']}  (trace {t_co:.0f}s)")
    return rec


def _write(fname, rec):
    os.makedirs(os.path.dirname(fname) or ".", exist_ok=True)
    with open(fname, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--spatial", action="store_true",
                    help="split layer stacks per layer first (the paper's "
                         "SCFU-analogue datapoint)")
    ap.add_argument("--layout", default="2d", choices=["2d", "fsdp"])
    ap.add_argument("--mixed", action="store_true",
                    help="bf16 params + f32 master in opt state")
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config")
    ap.add_argument("--fake-mesh", default=None, metavar="D,M",
                    help="a (data D, model M) mesh of D*M fake ranks "
                         "instead of the production mesh")
    args = ap.parse_args(argv)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    small = None
    if args.fake_mesh:
        from torch.distributed.device_mesh import init_device_mesh
        dims = tuple(int(n) for n in args.fake_mesh.split(","))
        fake_world(dims[0] * dims[1])
        small = init_device_mesh("cpu", dims,
                                 mesh_dim_names=("data", "model"))
    failures = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                fname = os.path.join(
                    args.out, f"{arch}_{shape}_{mesh_name}.json")
                if args.skip_existing and os.path.exists(fname):
                    try:
                        with open(fname) as f:
                            if "error" not in json.load(f):
                                continue
                    except Exception:
                        pass
                rec = run_cell(arch, shape, mesh_name, args.out,
                               spatial=args.spatial, layout=args.layout,
                               mixed=args.mixed, remat=args.remat,
                               mesh=small, smoke=args.smoke)
                failures += 1 if "error" in rec else 0
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    sys.exit(main())
