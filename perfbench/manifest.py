"""The benchmark's manifest: ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix, one cell or
one metric sits in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``  -- the configuration's sizes (the file the
  manifest's ``file`` names);
* ``traffic/<traffic>.json`` -- a traffic mix: the generator it feeds and
  its parameters;
* ``workloads/<cell>.json``  -- a cell's serving configuration, ramp,
  traced sub-window and the limits of its correctness check;
* ``metrics/<metric>.py``    -- a metric's reader (``read(record)``) with
  its declarations;
* ``generators/<name>.py``   -- a traffic generator (``make(mix, seed,
  vocab, bench_dir)``).

Adding a cell, a mix or a metric adds files; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

@dataclasses.dataclass
class Cell:
    """One cell of the manifest with the files it names, loaded."""
    root: Path                      # the checkout (holds BENCHMARK.json)
    bench: dict                     # BENCHMARK.json
    entry: dict                     # the cell's entry in ``workloads``
    config: dict                    # configs/<config>.json
    traffic: dict                   # traffic/<traffic>.json
    workload: dict                  # workloads/<cell>.json
    end_to_end: List[dict]          # the e2e metrics this cell reports
    per_layer: List[dict]           # the per-layer metrics this cell reports

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def bench_dir(self) -> Path:
        """The benchmark's own folder (its first path)."""
        return self.root / self.bench["paths"][0]


def load_bench(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (a metric without a
    ``workloads`` key is reported by every cell)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    bench = load_bench(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; the cells are "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    bdir = root / bench["paths"][0]
    return Cell(
        root=root, bench=bench, entry=entry,
        config=_read_json(root / configs[entry["config"]]["file"]),
        traffic=_read_json(bdir / "traffic" / f"{entry['traffic']}.json"),
        workload=_read_json(bdir / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)])


def _load_module(path: Path, tag: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(tag, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MODULES: Dict[Path, ModuleType] = {}


def module_at(path: Path, tag: str) -> ModuleType:
    """The module of a file under the benchmark's folder, loaded once.
    Metric files are named after their metric (``step_ms.decode.py``), so
    they load by path, not by import name."""
    path = Path(path).resolve()
    if path not in _MODULES:
        _MODULES[path] = _load_module(path, tag)
    return _MODULES[path]


def metric_module(bench_dir: Path, name: str) -> ModuleType:
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    return module_at(path, "perfbench_metric_" + name.replace(".", "_")
                     .replace("-", "_"))


def generator_module(bench_dir: Path, name: str) -> ModuleType:
    path = Path(bench_dir) / "generators" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"generator {name!r} missing at {path}")
    return module_at(path, "perfbench_generator_" + name.replace("-", "_"))

