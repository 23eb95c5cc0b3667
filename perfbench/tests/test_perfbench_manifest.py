"""The manifest keeps the benchmark's contract: names and units of the
allowed characters, bounds in range, every cell reporting the set-up time,
another end-to-end metric and a per-layer one, each per-layer metric's
``moves`` reported by each of its cells, each metric's file declaring what
the manifest says, and each configuration's file the size it runs."""
import dataclasses
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import manifest  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]
# keys that name a width: never cut
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|d_model|d_ff|experts_per_tok)")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in BENCH["paths"])


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in ("why", "layer", "source"):
        if k in entry:
            assert _line(entry[k])


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) \
        <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_setup_time_is_an_end_to_end_metric():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if manifest.reports(m, cell)]
    layers = [m for m in BENCH["per_layer"] if manifest.reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], m["moves"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for w in m.get("workloads", ()):
            assert w in CELLS


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_file_declares_what_the_manifest_says(metric):
    mod = manifest.metric_module(ROOT / BENCH["paths"][0], metric["name"])
    assert callable(mod.read)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (
        metric["unit"], metric["better"], metric["source"])
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_published_size(entry):
    from repro_torch.configs import get_arch
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    assert not [k for k in entry["reduced"] if WIDTH.search(k)]
    arch = dataclasses.asdict(get_arch(cfg["arch"]))
    changed = {k for k, v in cfg["model"].items() if arch[k] != v}
    # what the file sets beyond the port's architecture is listed as cut
    assert changed <= set(entry["reduced"])
    assert (ROOT / BENCH["paths"][0] / "reference"
            / f"{cfg['reference']}.py").exists()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = manifest.load_cell(ROOT, cell)
    bdir = c.bench_dir()
    assert (bdir / "generators" / f"{c.traffic['generator']}.py").exists()
    assert {"serve", "ramp_s", "trace", "check"} <= set(c.workload)
    assert {"served_tokens", "max_requests", "min_tokens",
            "max_logit_gap"} <= set(c.workload["check"])
