"""``BENCHMARK.json`` and the files each of its names leads to.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Each name is resolved to files by a fixed rule, so a later change
adds a configuration, a mix or a metric by adding files and entries:

* configuration ``c``: the ``file`` of its ``configs`` entry (JSON);
* traffic mix ``t``: ``chipbench/traffic/<t>.json``, whose ``driver``
  key names ``chipbench/drivers/<driver>.py``;
* per-layer metric ``m``: ``chipbench/metrics/<m>.py`` (a ``read(record)``);
* the configuration's ``reference`` key: ``chipbench/reference/<r>.py``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

#: the checkout's root: this file is ``chipbench/lib/spec.py``
ROOT = Path(__file__).resolve().parents[2]


class SpecError(RuntimeError):
    """``BENCHMARK.json`` or a file it names is missing or malformed."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    driver_path: Path
    reference_path: Path | None
    end_to_end: list        # the metric entries this cell reports
    per_layer: list         # the per-layer entries this cell reports
    root: Path

    def metric_path(self, name: str) -> Path:
        return self.root / "chipbench" / "metrics" / f"{name}.py"


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} is missing: nothing names the cells")
    return json.loads(path.read_text())


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: {path} is missing")
    return json.loads(path.read_text())


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether a cell reports ``metric``: the cells its ``workloads`` key
    lists; without the key, every cell (an end-to-end metric) or every
    cell that reports the end-to-end metric it ``moves`` (a per-layer
    one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"{workload}: no configuration {w['config']!r}")
    config = _read_json(root / configs[w["config"]]["file"],
                        f"configuration {w['config']}")
    traffic = _read_json(root / "chipbench" / "traffic"
                         / f"{w['traffic']}.json", f"traffic {w['traffic']}")
    if "driver" not in traffic:
        raise SpecError(f"traffic {w['traffic']}: no 'driver' key")
    driver = root / "chipbench" / "drivers" / f"{traffic['driver']}.py"
    if not driver.is_file():
        raise SpecError(f"traffic {w['traffic']}: driver {driver} missing")
    ref = None
    if config.get("reference"):
        ref = root / "chipbench" / "reference" / f"{config['reference']}.py"
        if not ref.is_file():
            raise SpecError(f"configuration {w['config']}: reference "
                            f"{ref} missing")
    e2e = [m for m in spec["end_to_end"] if reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if reports(m, workload, names)]
    cell = Cell(name=workload, chips=int(w["chips"]),
                config_name=w["config"], config=config,
                traffic=traffic,
                driver_path=driver, reference_path=ref, end_to_end=e2e,
                per_layer=per_layer, root=root)
    for m in per_layer:
        if not cell.metric_path(m["name"]).is_file():
            raise SpecError(f"metric {m['name']}: reader "
                            f"{cell.metric_path(m['name'])} missing")
    return cell


def load_module(path: Path):
    """Import a file of the benchmark: a module of the ``chipbench``
    package in use by its dotted name (so that it is one module however
    it is reached), any other file by its path (a metric's name may hold
    dots and dashes), once per process."""
    import chipbench
    path = Path(path).resolve()
    pkg = Path(chipbench.__file__).resolve().parent
    if path.is_relative_to(pkg):
        parts = path.relative_to(pkg).with_suffix("").parts
        if all(p.isidentifier() for p in parts):
            return importlib.import_module(".".join(("chipbench",) + parts))
    key = "chipbench_file_" + re.sub(r"\W", "_", str(path))
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[key]
        raise
    return mod
