"""``BENCHMARK.json`` against the benchmark's contract, every name
resolved to its files, and a new cell added by files and entries alone."""

import ast
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from chipbench.tests.support import ROOT, TINY_LM, run_tiny

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["chipbench"]
    assert SPEC["command"] == ["python3", "chipbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names_units_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    seen = set()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_every_cell_reports_what_it_must():
    from chipbench.lib.spec import resolve
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        cell = resolve(SPEC, w["name"], ROOT)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_workload_resolves_to_its_files(workload):
    from chipbench.lib.spec import load_module, resolve
    cell = resolve(SPEC, workload, ROOT)
    assert cell.driver_path.is_file() and cell.reference_path.is_file()
    assert callable(load_module(cell.driver_path).run)
    for m in cell.per_layer:
        assert callable(load_module(cell.metric_path(m["name"])).read)
    entry = next(c for c in SPEC["configs"] if c["name"] == cell.config_name)
    assert entry["file"].startswith("chipbench/")
    for key in entry["reduced"]:
        assert NAME.match(key) and key in cell.config


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "chipbench").rglob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & FORBIDDEN, f"{f} imports {tops & FORBIDDEN}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((ROOT / "chipbench" / "reference").glob("*.py")):
        names = _imports(f)
        assert not any(n.split(".")[0] == "repro_torch" for n in names), f
        assert not any(n.startswith("chipbench.drivers") for n in names), f


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chipbench_run_forbidden", ROOT / "chipbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    fake = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in FORBIDDEN}
    fake["repro_torch.core"] = object()
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == []
    fake["jax.numpy"] = object()
    fake["repro.core"] = object()
    assert run.forbidden_modules() == ["jax", "repro"]


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", str(2 ** 31 + 11),
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
        text=True, timeout=120)


def test_refuses_without_a_card(no_card, tmp_path):
    """No result and a non-zero exit where there is no CUDA device, in
    the checkout and in a directory that holds only ``BENCHMARK.json``
    and the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        r = _run(cwd)
        assert r.returncode != 0 and r.stdout.strip() == "", r.stderr


def _digests(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a per-layer metric are added as
    new files and new entries; no file that is there changes, and the new
    cell runs and reports its metric."""
    from chipbench.lib.record import read_metrics
    from chipbench.lib.spec import resolve
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "chipbench")
    spec = json.loads(json.dumps(SPEC))
    cfg = json.loads((ROOT / "chipbench/configs/deepseek-7b.json")
                     .read_text())
    cfg.update(TINY_LM, name="tiny-dense")
    (tmp_path / "chipbench/configs/tiny-dense.json").write_text(
        json.dumps(cfg))
    mix = json.loads((ROOT / "chipbench/traffic/train.json").read_text())
    mix.update(seq_len=32, pool_rows=8,
               limits={"loss_rel_gap": 1e-3, "grad_norm_gap": 4e-3,
                       "change_norm_gap": 2.5e-3})
    (tmp_path / "chipbench/traffic/tiny-train.json").write_text(
        json.dumps(mix))
    (tmp_path / "chipbench/metrics/train.steps_in_window.py").write_text(
        "def read(rec):\n    return rec.counters.get('steps')\n")
    spec["configs"].append({"name": "tiny-dense", "source": "test",
                            "file": "chipbench/configs/tiny-dense.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-dense.train",
                              "config": "tiny-dense",
                              "traffic": "tiny-train", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "train.steps_in_window",
                              "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "train_tokens_per_s"})
    for m in spec["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("tiny-dense.train")
    cell = resolve(spec, "tiny-dense.train", tmp_path)
    assert cell.driver_path.parent == tmp_path / "chipbench" / "drivers"
    assert "train.steps_in_window" in [m["name"] for m in cell.per_layer]
    rec = run_tiny(cell)
    assert rec.correct, rec.checks
    rec.traced = True
    got = read_metrics(cell, rec)
    assert got["train.steps_in_window"]["value"] >= 1
    after = _digests(tmp_path / "chipbench")
    assert {p: d for p, d in after.items() if p in before} == before


_FINISH = """
import importlib.util, sys
from pathlib import Path
root, fakes = Path(sys.argv[1]), sys.argv[2]
sys.path[:0] = [fakes, str(root)]
spec = importlib.util.spec_from_file_location("run", root / "chipbench/run.py")
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
import torch
torch.cuda.get_device_name = lambda *a: "a test card"
from chipbench.lib.record import Record
from chipbench.lib.spec import load_benchmark, resolve
cell = resolve(load_benchmark(root), sys.argv[3], root)
rec = Record(seed=1, seconds=1.0, traced=True, t_start=0.0)
rec.attempted = 1
rec.check("max_ulp", 0, 0)
sys.exit(run.finish(cell, rec, None))
"""


@pytest.mark.parametrize("loads_jax", [True, False])
def test_a_reader_that_loads_jax_stops_the_result(tmp_path, loads_jax):
    """The look for JAX comes after every per-layer reader has been
    loaded: a new reader that imports a module named ``jax`` leaves the
    run with no result line; the same reader without the import is
    read into it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    fakes = tmp_path / "fakes"
    fakes.mkdir()
    (fakes / "jax.py").write_text("")
    body = ("    import jax  # noqa: F401\n" if loads_jax else "") \
        + "    return 1.0\n"
    (tmp_path / "chipbench/metrics/probe.reader.py").write_text(
        "def read(rec):\n" + body)
    spec = json.loads(json.dumps(SPEC))
    cell = spec["workloads"][0]["name"]
    moves = next(m["name"] for m in spec["end_to_end"]
                 if cell in m.get("workloads", []))
    spec["per_layer"].append({"name": "probe.reader", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": moves,
                              "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    r = subprocess.run([sys.executable, "-c", _FINISH, str(tmp_path),
                        str(fakes), cell], capture_output=True, text=True,
                       timeout=120)
    if loads_jax:
        assert r.returncode != 0 and r.stdout.strip() == "", r.stdout
        assert "jax" in r.stderr
    else:
        assert r.returncode == 0, r.stderr
        res = json.loads(r.stdout.strip().splitlines()[-1])
        assert res["metrics"]["probe.reader"]["value"] == 1.0
        assert list(res)[-1] == "checks"


def test_a_run_keeps_to_one_core_and_says_which():
    """``pin_cpu`` leaves the process on one of the cores it may use and
    returns that core, which the result's ``device`` carries."""
    code = ("import importlib.util, json, os, sys\n"
            "spec = importlib.util.spec_from_file_location('run', sys.argv[1])\n"
            "run = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(run)\n"
            "before = sorted(os.sched_getaffinity(0))\n"
            "core = run.pin_cpu()\n"
            "print(json.dumps([core, before, "
            "sorted(os.sched_getaffinity(0))]))\n")
    r = subprocess.run([sys.executable, "-c", code,
                        str(ROOT / "chipbench" / "run.py")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    core, before, after = json.loads(r.stdout)
    assert after == [core] and core in before
    assert core == before[min(2, len(before) - 1)]
