"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, beside
the reference's ``launch/dryrun.py``.

* the 40 cells and their skips, and every non-skipped cell's input specs
  (shapes and dtypes), against the reference's;
* ``wire_bytes`` against the reference's ``parse_collectives`` on HLO
  lines of every collective kind;
* trap 1: the per-device FLOPs of one product on a fake (2, 2) mesh are a
  quarter of the global count;
* a Shard(0) -> Shard(1) move inside the tracer is one all-to-all of the
  local shard, as an NCCL mesh runs it (not the gloo fallback's
  all-gather of the whole);
* Mamba2's in-projection on a fake (2, 2) mesh: no collective over the
  ``model`` group moves it whole; its exchange of head columns a pass is
  one all-to-all, counted by its busiest rank, and one all-gather of the
  B and C pieces;
* the whole-cell estimator on a fake (2, 2) mesh, in a subprocess (a
  fake process group would otherwise stay in this process): the
  deepseek-7b, qwen2-moe, mamba2 and zamba2 smoke configs, train,
  prefill and decode (Mamba2's decode gathering no SSM state), and
  ``--mixed``, ``--layout fsdp``, ``--remat dots`` and ``--spatial`` once
  each; every record has the reference's keys, its bottleneck is one of
  the three, weight gathering is off again after; every arch and kind of
  step on a fake (2, 8) mesh;
* the sharded estimates held against what does not come from the
  tracer's DTensor path: a rank's FLOPs against a quarter of the same
  step traced on plain tensors; the per-device argument bytes, and the
  dense cells' FLOPs and collective bytes, against the reference's
  lowering of the same cells on four fake XLA devices;
* the CLI writes ``[skip]`` / ``[ok]`` / ``[FAIL]`` records and exits 1 on
  a failure.

The reference's functions run in a subprocess too: importing its
``launch/dryrun.py`` forces 512 XLA host devices.  Each subprocess has a
timeout.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import (ARCHS, SHAPES, cells, get_smoke_config,
                                 skip_reason)
from repro_torch.launch import dryrun as D
from repro_torch.models.ssm import head_columns

ROOT = Path(__file__).resolve().parent.parent

#: the reference test's three HLO lines, plus a reduce-scatter and an
#: all-to-all
HLO = """
  %ar = f32[16,1024]{1,0} all-reduce(f32[16,1024] %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[32,512]{1,0} all-gather(bf16[2,512] %y), replica_groups=[8,16]<=[128], dimensions={0}
  %cp = bf16[8,8]{1,0} collective-permute(bf16[8,8] %z), source_target_pairs={{0,1}}
  %rs = f32[4,256]{1,0} reduce-scatter(f32[64,256] %w), replica_groups=[16,16]<=[256], dimensions={0}, to_apply=%add
  %aa = bf16[64,128]{1,0} all-to-all(bf16[64,128] %v), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
"""

#: small shapes of each kind for the smoke configs
TINY = {"tiny_train": (64, 8, "train"), "tiny_prefill": (64, 4, "prefill"),
        "tiny_decode": (64, 8, "decode")}

_REF_SCRIPT = r"""
import json, sys
TINY = json.loads(sys.argv[2])
from repro.configs import ARCHS, SHAPES, cells, skip_reason
from repro.launch.dryrun import input_specs, parse_collectives
specs = {}
for arch in ARCHS:
    for shape in SHAPES:
        if skip_reason(arch, shape):
            continue
        _, batch, dims = input_specs(arch, shape)
        specs[f"{arch}|{shape}"] = {
            "dims": list(dims),
            "batch": {k: [list(v.shape), str(v.dtype)]
                      for k, v in batch.items()}}
every_cell = [list(c) for c in cells()]
# the smoke cells of the estimator's tests, lowered on a (2, 2) mesh of
# four of the fake devices, spatial (HloCostAnalysis counts a scanned
# layer once)
import jax
import repro.launch.dryrun as RD
from repro.configs import get_smoke_config
RD.get_config = get_smoke_config
SHAPES.update(TINY)
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
small = {}
for arch in ("deepseek-7b", "qwen2-moe-a2.7b"):
    for shape in TINY:
        _, comp, *_ = RD.lower_cell(arch, shape, mesh, "fake2x2",
                                    spatial=True)
        colls = parse_collectives(comp.as_text())
        small[f"{arch}|{shape}"] = {
            "flops": comp.cost_analysis()["flops"],
            "argument_size_in_bytes":
                comp.memory_analysis().argument_size_in_bytes,
            "wire_bytes": sum(c["wire_bytes"] for c in colls)}
# the reference's closed form of every train_4k cell
from benchmarks.analytic import cell_model
analytic = {arch: cell_model(arch, "train_4k").flops_dev for arch in ARCHS}
print(json.dumps({"cells": every_cell, "specs": specs,
                  "colls": parse_collectives(sys.argv[1]), "small": small,
                  "analytic": analytic}))
"""


def _run(cmd, timeout=300, **env):
    full = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                **env)
    full.pop("XLA_FLAGS", None)
    return subprocess.run(cmd, env=full, capture_output=True, text=True,
                          timeout=timeout, cwd=str(ROOT))


@pytest.fixture(scope="module")
def ref():
    proc = _run([sys.executable, "-c", _REF_SCRIPT, HLO, json.dumps(TINY)],
                JAX_PLATFORMS="cpu")
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cells_cover_40_with_the_references_skips(ref):
    assert [list(c) for c in cells()] == ref["cells"]
    assert len(cells()) == 40


_LIVE = [(a, s) for a in ARCHS for s in SHAPES if not skip_reason(a, s)]


@pytest.mark.parametrize("arch,shape", _LIVE,
                         ids=[f"{a}-{s}" for a, s in _LIVE])
def test_input_specs_are_the_references(ref, arch, shape):
    _, batch, dims = D.input_specs(arch, shape)
    want = ref["specs"][f"{arch}|{shape}"]
    assert list(dims) == want["dims"]
    got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
           for k, v in batch.items()}
    assert got == want["batch"]
    assert all(v.is_meta for v in batch.values())


def test_wire_bytes_is_the_references_ring_model(ref):
    colls = ref["colls"]
    assert sorted(c["kind"] for c in colls) == sorted(
        ["all-reduce", "all-gather", "collective-permute", "reduce-scatter",
         "all-to-all"])
    for c in colls:
        assert D.wire_bytes(c["kind"], c["bytes"], c["group"]) \
            == c["wire_bytes"], c


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_smokes_analytic_flops_are_the_references(ref, arch):
    """``chip_smoke.py`` holds each train_4k cell to the reference's
    closed form (``benchmarks/analytic.py::cell_model``) through a copy of
    it that imports nothing of the reference: the same FLOPs a device, for
    every arch (attention, Mamba2 and MoE blocks)."""
    import importlib.util
    from repro_torch.configs import get_config
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    seq, gbatch, _ = SHAPES["train_4k"]
    got = cs.analytic_train_flops(get_config(arch), seq, gbatch, 256)
    assert got == pytest.approx(ref["analytic"][arch], rel=1e-12)


_TRAP1 = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun as D

D.fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
x = torch.empty((64, 512), device="meta")
w = torch.empty((512, 256), device="meta")
with FlopCounterMode(display=False) as fc:
    x @ w
xs = DTensor.from_local(torch.empty((32, 512), device="meta"), mesh,
                        [Shard(0), Replicate()], run_check=False,
                        shape=x.shape, stride=x.stride())
ws = DTensor.from_local(torch.empty((512, 128), device="meta"), mesh,
                        [Replicate(), Shard(1)], run_check=False,
                        shape=w.shape, stride=w.stride())
tr = D._Tracer()
with tr:
    y = xs @ ws
with FlopCounterMode(display=False) as over:
    xs @ ws
print(json.dumps({"global": fc.get_total_flops(), "per_device": tr.flops,
                  "dtensor_counter": over.get_total_flops(),
                  "placements": [str(p) for p in y.placements],
                  "collectives": len(tr.collectives)}))
"""


_ALLTOALL = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun as D

D.fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
x = DTensor.from_local(torch.empty((8, 16), device="meta"), mesh,
                       [Replicate(), Shard(0)], run_check=False,
                       shape=(16, 16), stride=(16, 1))
tr = D._Tracer()
with tr:
    y = x.redistribute(mesh, [Replicate(), Shard(1)])
print(json.dumps({"collectives": tr.collectives,
                  "local": list(y.to_local().shape)}))
"""


def test_a_shard_to_shard_move_is_one_all_to_all():
    """Shard(0) -> Shard(1) over the model axis of a fake (2, 2) mesh,
    typed ``cpu`` as the dry run's meshes are: DTensor would lower it to
    gloo's all-gather and chunk; inside the tracer it is one
    ``all-to-all`` whose result is the new local shard (8 x 16 -> 16 x 8
    float32, 512 bytes), and no all-gather."""
    proc = _run([sys.executable, "-c", _ALLTOALL])
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["local"] == [16, 8]
    assert got["collectives"] == [{
        "kind": "all-to-all", "bytes": 512, "group": 2,
        "wire_bytes": D.wire_bytes("all-to-all", 512, 2)}]


def test_flops_are_counted_per_device_not_globally():
    """Trap 1: ``FlopCounterMode`` over DTensors counts the global product;
    the tracer counts one rank's local product — a quarter of it on a
    (2, 2) mesh with the rows split over one axis and the columns over
    the other, with no collective."""
    proc = _run([sys.executable, "-c", _TRAP1])
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["global"] == 2 * 64 * 512 * 256
    assert got["per_device"] * 4 == got["global"], got
    assert got["dtensor_counter"] == got["global"], got
    assert got["collectives"] == 0, got


_MAMBA_HEADS = r"""
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.launch import dryrun as D

D.SHAPES["tiny_train"] = (64, 8, "train")
D.fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
model = mesh.get_group("model").group_name
seen = []


class Tracer(D._Tracer):
    # each collective the tracer counts, with its group and the elements
    # of its input and its result
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        n = len(self.collectives)
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for c in self.collectives[n:]:
            seen.append(dict(c, op=str(func._overloadpacket),
                             model=model in args,
                             elements=max(args[0].numel(), out.numel())))
        return out


D._Tracer = Tracer
cfg, batch, (seq, gbatch, kind) = D.input_specs("mamba2-2.7b", "tiny_train",
                                                smoke=True)
D.trace_step(cfg, batch, kind, seq, gbatch, mesh)
d = cfg.ssm
print(json.dumps({"seen": seen, "layers": cfg.stacks[0].count,
                  "dims": [d.d_inner, d.d_state, d.head_dim, d.n_heads,
                           d.n_groups],
                  "tokens": gbatch // 2 * (seq - 1)}))
"""


def test_mamba_in_projection_moves_only_head_columns():
    """mamba2-2.7b's smoke config (d_inner 128, N 16, P 16, H 8, G 1: 296
    in-projection columns, 148 a rank's block, 164 its heads' columns) in
    a train step on a fake (2, 2) mesh.  No collective over the ``model``
    group moves the in-projection whole (a rank's rows x 296 columns: the
    all-gather and reduce-scatter of a gathered in-projection would).  At
    each layer the forward and its remat recompute do one all-to-all of
    z, x, dt and a rank's 16-column piece of B and C, then one all-gather
    of the pieces (32 columns); the backward one reduce-scatter of them
    and the reverse all-to-all.  Each all-to-all counts the busiest
    rank's columns sent or received, as the shapes give them."""
    proc = _run([sys.executable, "-c", _MAMBA_HEADS])
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    dims = get_smoke_config("mamba2-2.7b").ssm
    din, N, P, H, G = got["dims"]
    assert [din, N, P, H, G] == [dims.d_inner, dims.d_state, dims.head_dim,
                                 dims.n_heads, dims.n_groups]
    width, tokens, layers = 2 * din + 2 * G * N + H, got["tokens"], \
        got["layers"]
    assert width == 296
    on_model = [c for c in got["seen"] if c["model"]]
    assert on_model
    assert max(c["elements"] for c in on_model) < tokens * width, \
        sorted(on_model, key=lambda c: -c["elements"])[0]
    # each model rank's block is half the columns; B and C, [256, 288),
    # go out in halves, each all-gathered onto both ranks
    blocks = [set(range(0, 148)), set(range(148, 296))]
    bc = set(range(2 * din, 2 * din + 2 * G * N))
    needs = [set(head_columns(dims, 2, r).tolist()) for r in (0, 1)]
    assert [len(x) for x in needs] == [164, 164]
    wants = [needs[0] - bc | set(range(256, 272)),
             needs[1] - bc | set(range(272, 288))]
    cols = max(max(len(wants[r] - blocks[r]), len(wants[1 - r] & blocks[r]))
               for r in (0, 1))
    assert cols == 64
    exchanges = [c for c in got["seen"] if c["kind"] == "all-to-all"]
    assert all(c["model"] and c["op"] == "_c10d_functional.all_to_all_single"
               for c in exchanges)
    assert len(exchanges) == 3 * layers
    assert [c["wire_bytes"] for c in exchanges] \
        == [cols * tokens * 2] * len(exchanges)
    pieces = [c for c in on_model if c["elements"] == 2 * G * N * tokens
              and c["kind"] in ("all-gather", "reduce-scatter")]
    assert sorted(c["kind"] for c in pieces) \
        == ["all-gather"] * 2 * layers + ["reduce-scatter"] * layers


_CELLS = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
import repro_torch.models.layers as L
from repro_torch.launch import dryrun as D

out = sys.argv[1]
D.SHAPES.update(json.loads(sys.argv[2]))
D.fake_world(4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
runs, plain = {}, {}
for arch in ("deepseek-7b", "qwen2-moe-a2.7b", "mamba2-2.7b", "zamba2-7b"):
    for shape in ("tiny_train", "tiny_prefill", "tiny_decode"):
        runs[f"{arch}|{shape}"] = D.run_cell(arch, shape, "fake2x2", out,
                                             mesh=mesh, smoke=True)
        cfg, batch, (seq, gbatch, kind) = D.input_specs(arch, shape,
                                                        smoke=True)
        plain[f"{arch}|{shape}"] = D.trace_step(cfg, batch, kind, seq,
                                                gbatch)[0].flops
# the largest all-gather of Mamba2's decode step, and its SSM state
cfg, batch, (seq, gbatch, kind) = D.input_specs("mamba2-2.7b", "tiny_decode",
                                                smoke=True)
traced = D.trace_step(cfg, batch, kind, seq, gbatch, mesh)[0]
d = cfg.ssm
state = gbatch // 2 * d.n_heads * d.d_state * d.head_dim * 4
gathers = [c["bytes"] for c in traced.collectives if c["kind"] == "all-gather"]
variants = {"mixed": dict(mixed=True), "fsdp": dict(layout="fsdp"),
            "dots": dict(remat="dots"), "spatial": dict(spatial=True)}
gather_after = {}
for name, kw in variants.items():
    runs[f"deepseek-7b|tiny_train|{name}"] = D.run_cell(
        "deepseek-7b", "tiny_train", "fake2x2", out, mesh=mesh, smoke=True,
        **kw)
    gather_after[name] = L._WEIGHT_GATHER
print(json.dumps({"runs": runs, "plain_flops": plain,
                  "mamba_decode": {"largest_gather": max(gathers),
                                   "state": state},
                  "gather_after": gather_after,
                  "files": sorted(__import__("os").listdir(out))}))
"""


@pytest.fixture(scope="module")
def estimates(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    proc = _run([sys.executable, "-c", _CELLS, str(out), json.dumps(TINY)],
                timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


REF_KEYS = {"arch", "shape", "mesh", "mode", "layout", "mixed", "remat",
            "memory", "cost", "collectives", "roofline", "timing"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes"}
ROOF_KEYS = {"chips", "hlo_flops_per_device", "hlo_bytes_per_device",
             "collective_wire_bytes_per_device", "t_compute_s", "t_memory_s",
             "t_collective_s", "model_flops_total", "model_flops_per_device",
             "useful_flops_ratio", "bottleneck"}
#: the cells the reference lowers too
REF_SMALL = [f"{a}|{s}" for a in ("deepseek-7b", "qwen2-moe-a2.7b")
             for s in TINY]
SMALL = REF_SMALL + [f"{a}|{s}" for a in ("mamba2-2.7b", "zamba2-7b")
                     for s in TINY]
RUNS = SMALL \
    + [f"deepseek-7b|tiny_train|{v}"
       for v in ("mixed", "fsdp", "dots", "spatial")]


@pytest.mark.parametrize("run", RUNS)
def test_every_record_has_the_references_keys(estimates, run):
    rec = estimates["runs"][run]
    assert "error" not in rec, rec.get("traceback")
    assert REF_KEYS <= set(rec), set(rec)
    assert MEMORY_KEYS <= set(rec["memory"])
    assert rec["memory"]["generated_code_size_in_bytes"] == 0
    assert {"flops", "bytes accessed"} <= set(rec["cost"])
    assert ROOF_KEYS <= set(rec["roofline"])
    assert {"lower_s", "compile_s"} <= set(rec["timing"])
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0


@pytest.mark.parametrize("run", RUNS)
def test_a_mesh_cell_counts_its_collectives(estimates, run):
    rec = estimates["runs"][run]
    assert rec["roofline"]["chips"] == 4
    assert rec["collectives"], rec
    for kind, agg in rec["collectives"].items():
        assert kind in ("all-reduce", "all-gather", "reduce-scatter",
                        "all-to-all", "collective-permute"), kind
        assert agg["count"] > 0 and agg["wire_bytes"] > 0


@pytest.mark.parametrize("run", SMALL)
def test_a_rank_does_a_quarter_of_the_plain_steps_work(estimates, run):
    """The per-device FLOPs on the (2, 2) mesh against the same step
    traced on plain tensors: a quarter of them, to within 3 %.  The MoE
    reads up to 1.0070: its router runs on both ranks of the model axis,
    as the reference's replicated router does; 1.03 is that plus 2 %.
    deepseek, mamba2 and zamba2 read 1.0 (Mamba2's mixer by heads: the
    conv of B and C, duplicated on each rank, counts no product).  A
    product or a mixer computed whole on every rank of an axis shows as
    a multiple."""
    got = estimates["runs"][run]["roofline"]["hlo_flops_per_device"]
    quarter = estimates["plain_flops"][run] / 4
    assert quarter <= got <= 1.03 * quarter, (got, quarter)


def test_mamba_decode_gathers_no_ssm_state(estimates):
    """Mamba2's decode step on the (2, 2) mesh updates each rank's
    ``d_state`` slice of the SSM state in place: no all-gather is as
    large as one layer's state of a rank's rows, which a step that
    gathered the state would move at every layer."""
    got = estimates["mamba_decode"]
    assert got["largest_gather"] < got["state"], got


@pytest.mark.parametrize("run", REF_SMALL)
def test_arguments_per_device_are_the_references(ref, estimates, run):
    """Per-device argument bytes against the reference's
    ``memory_analysis`` of the same cell on four fake XLA devices: the
    same bytes (decode's position is a 4-byte argument there, a Python
    int here)."""
    got = estimates["runs"][run]["memory"]["argument_size_in_bytes"]
    want = ref["small"][run]["argument_size_in_bytes"]
    assert got + (4 if run.endswith("decode") else 0) == want


@pytest.mark.parametrize("run,ref_cell,key,lo,hi", [
    ("deepseek-7b|tiny_train|spatial", "deepseek-7b|tiny_train", "flops",
     0.75, 1.05),
    ("deepseek-7b|tiny_prefill", "deepseek-7b|tiny_prefill", "flops",
     0.75, 1.05),
    ("deepseek-7b|tiny_train|spatial", "deepseek-7b|tiny_train",
     "wire_bytes", 0.5, 2.0)])
def test_dense_cells_are_near_the_references(ref, estimates, run, ref_cell,
                                             key, lo, hi):
    """Per-device FLOPs and collective wire bytes of the dense smoke cells
    against the reference's lowering on four fake XLA devices (spatial:
    its cost analysis counts a scanned layer once).  The port counts the
    products alone, XLA an element-wise op's every element too, so the
    port's FLOPs are the lower; more than 5 % above would be work the
    reference does not do.  The two partitioners pick different
    collectives (XLA's SPMD pass against the port's explicit layouts and
    DTensor), so the wire bytes are held within a factor of two: enough
    to catch an activation or a gradient moved whole where a shard
    would do."""
    roof = estimates["runs"][run]["roofline"]
    got = {"flops": roof["hlo_flops_per_device"],
           "wire_bytes": roof["collective_wire_bytes_per_device"]}[key]
    want = ref["small"][ref_cell][key]
    assert lo <= got / want <= hi, (got, want)


def test_variants_and_weight_gather_switch(estimates):
    runs = estimates["runs"]
    base = runs["deepseek-7b|tiny_train"]
    assert set(estimates["gather_after"].values()) == {False}
    mixed = runs["deepseek-7b|tiny_train|mixed"]
    # bf16 params + f32 master, m, v: 14 B a param against 12
    assert mixed["memory"]["argument_size_in_bytes"] \
        > base["memory"]["argument_size_in_bytes"]
    assert mixed["mixed"] and runs["deepseek-7b|tiny_train|fsdp"][
        "layout"] == "fsdp"
    assert runs["deepseek-7b|tiny_train|spatial"]["mode"] == "spatial"
    assert runs["deepseek-7b|tiny_train|dots"]["remat"] == "dots"
    # the same step: the same products, whatever the variant
    for v in ("mixed", "dots", "spatial"):
        assert runs[f"deepseek-7b|tiny_train|{v}"]["cost"]["flops"] \
            == pytest.approx(base["cost"]["flops"], rel=0.35), v
    files = estimates["files"]
    for f in ("deepseek-7b_tiny_train_fake2x2.json",
              "deepseek-7b_tiny_train_fake2x2_fsdp.json",
              "deepseek-7b_tiny_train_fake2x2_mixed.json",
              "deepseek-7b_tiny_train_fake2x2_remat-dots.json"):
        assert f in files, files


_EVERY = r"""
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun as D

out = sys.argv[1]
D.SHAPES.update(json.loads(sys.argv[2]))
D.fake_world(16)
mesh = init_device_mesh("cpu", (2, 8), mesh_dim_names=("data", "model"))
errors = {}
for arch in ARCHS:
    for shape in json.loads(sys.argv[2]):
        rec = D.run_cell(arch, shape, "fake2x8", out, mesh=mesh, smoke=True)
        errors[f"{arch}|{shape}"] = rec.get("traceback")
print(json.dumps(errors))
"""

#: every kind of cell, and a decode of one sequence (the batch cannot be
#: split: caches split over positions, as long_500k's are)
EVERY_KIND = dict(TINY, tiny_long=(64, 1, "decode"))


@pytest.fixture(scope="module")
def every_cell(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_every")
    proc = _run([sys.executable, "-c", _EVERY, str(out),
                 json.dumps(EVERY_KIND)], timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", EVERY_KIND)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_traces_every_kind_on_a_2x8_mesh(every_cell, arch,
                                                    shape):
    """Each arch's smoke config, each kind of step, on a fake (2, 8) mesh:
    kv heads that an 8-way model axis cannot split (caches split over
    head_dim instead, cross-attention's too), a batch of one."""
    assert every_cell[f"{arch}|{shape}"] is None, \
        every_cell[f"{arch}|{shape}"]


def test_cli_skip_ok_and_fail(tmp_path):
    """The CLI: a skipped cell's ``[skip]`` record, an ``[ok]`` cell on a
    fake (2, 2) mesh, exit 0; a failing cell written as ``error`` +
    ``traceback``, ``[FAIL]`` and exit 1."""
    ok = _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               "deepseek-7b", "--shape", "long_500k", "--out",
               str(tmp_path)])
    assert ok.returncode == 0, ok.stderr[-3000:]
    assert ok.stdout.startswith("[skip] deepseek-7b x long_500k (single)")
    rec = json.loads((tmp_path / "deepseek-7b_long_500k_single.json")
                     .read_text())
    assert rec["skipped"] == skip_reason("deepseek-7b", "long_500k")
    run = _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                "mamba2-2.7b", "--shape", "decode_32k", "--smoke",
                "--fake-mesh", "2,2", "--out", str(tmp_path)])
    assert run.returncode == 0, run.stderr[-3000:]
    assert "[ok] mamba2-2.7b x decode_32k (single)" in run.stdout
    assert run.stdout.strip().endswith("done; 0 failures")
    boom = _run([sys.executable, "-c",
                 "import sys\n"
                 "from repro_torch.launch import dryrun as D\n"
                 "def fail(*a, **k):\n"
                 "    raise RuntimeError('boom')\n"
                 "D.trace_step = fail\n"
                 "D.main(sys.argv[1:])\n",
                 "--arch", "deepseek-7b", "--shape", "train_4k",
                 "--smoke", "--fake-mesh", "2,2", "--out", str(tmp_path)])
    assert boom.returncode == 1
    assert "[FAIL] deepseek-7b x train_4k (single): RuntimeError: boom" \
        in boom.stdout
    rec = json.loads((tmp_path / "deepseek-7b_train_4k_single.json")
                     .read_text())
    assert rec["error"] == "RuntimeError: boom" and "traceback" in rec


def test_the_roofline_uses_one_h100s_constants():
    assert (D.PEAK_FLOPS, D.HBM_BW, D.LINK_BW) == (989e12, 3.35e12, 50e9)
