"""A throwaway benchmark for the CPU tests: the benchmark's folder and
manifest copied into a temporary directory, with a cell, a traffic mix, a
configuration and an end-to-end metric of its own added as new files and
manifest entries only. The cell serves a two-layer model on the port's
CPU path for about a second."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "tiny.mix"
METRIC = "tiny_tokens"

CONFIG = {
    "name": "tiny", "arch": "gpt-13b", "source": "test", "reference": "dense",
    "reduced": ["num_layers", "d_model", "num_heads", "num_kv_heads",
                "head_dim", "d_ff", "vocab_size"],
    "dtype": "bfloat16", "deployment": "the CPU",
    "model": {"num_layers": 2, "d_model": 64, "num_heads": 4,
              "num_kv_heads": 4, "head_dim": 16, "d_ff": 256,
              "vocab_size": 512}}
MIX = {"generator": "open_loop", "rate": 16.0, "deck": 16, "strata": 4,
       "strata_by": "output", "prompt": {"uniform": [8, 40]},
       "output": {"uniform": [8, 24]}}
WORKLOAD = {
    "serve": {"max_slots": 4, "max_len": 128, "prefill_chunk": 16,
              "policy": "pim_aware", "pack": True, "fuse": True,
              "superstep": 4},
    "ramp_s": 0.3, "trace": {"warm_s": 0.1, "window_s": 0.2},
    "check": {"served_tokens": 300, "max_requests": 20, "min_tokens": 20,
              "max_logit_gap": 0.015}}
METRIC_SRC = '''"""Tokens returned in the window (a throwaway metric)."""
from perfbench import readings

UNIT, BETTER, SOURCE = "tokens", "higher", "host_clock"


def read(rec):
    return readings.tokens_in_window(rec)
'''


def build(tmp: Path) -> Path:
    """The throwaway benchmark's root under ``tmp``."""
    root = Path(tmp) / "bench"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache",
                                                  "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": CONFIG["reduced"], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "tiny",
                               "traffic": "tinymix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": METRIC, "unit": "tokens",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": [CELL]})
    for m in bench["end_to_end"]:
        if m["name"] in ("output_tok_s", "ttft_p90_ms"):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    p = root / "perfbench"
    (p / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (p / "traffic" / "tinymix.json").write_text(json.dumps(MIX))
    (p / "workloads" / f"{CELL}.json").write_text(json.dumps(WORKLOAD))
    (p / "metrics" / f"{METRIC}.py").write_text(METRIC_SRC)
    return root
