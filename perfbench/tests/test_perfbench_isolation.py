"""The benchmark loads no JAX and nothing of the JAX package (top-level
module names compared whole: ``repro_torch`` is not ``repro``), the
reference loads nothing of the port either, and no file of the benchmark
reads the JAX package's ``benchmarks/``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BDIR = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(ROOT), check=True,
        capture_output=True, text=True, timeout=240).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                {str(Path(__file__).parent)!r}]
import torch
torch.set_num_threads(2)
import perfbench_tiny
from perfbench import control, harness
root = perfbench_tiny.build({str(tmp_path)!r})
out = harness.run_cell(root, perfbench_tiny.CELL, 5, 2.0, False,
                       time.perf_counter(), device="cpu")
assert out["checks"]["tokens_compared"]["value"] > 0
print(json.dumps(sorted(sys.modules)))
"""
    loaded = _loaded(code)
    assert "repro_torch.serve.engine" in loaded
    assert {m.split(".")[0] for m in loaded} & FORBIDDEN == set()


def test_the_reference_loads_nothing_of_the_port():
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}]
import torch
from perfbench.reference import dense
sizes = dict(num_layers=1, d_model=8, num_heads=2, num_kv_heads=1,
             head_dim=4, d_ff=16, vocab_size=32, norm="layernorm",
             act="gelu", tie_embeddings=True, rope_theta=1e4)
g = torch.Generator().manual_seed(0)
r = lambda *s: torch.randn(*s, generator=g)
w = {{"attn/wq": r(8, 2, 4), "attn/wk": r(8, 1, 4), "attn/wv": r(8, 1, 4),
      "attn/wo": r(2, 4, 8), "ffn/wi": r(8, 16), "ffn/wo": r(16, 8),
      "norm1/scale": r(8), "norm2/scale": r(8)}}
out = dense.logits_at(sizes, {{"tok": r(32, 8)}}, {{"scale": r(8)}},
                      lambda l: w, [torch.arange(6)], [torch.arange(6)],
                      precision="fp8")
assert out[0].shape == (6, 32)
print(json.dumps(sorted(sys.modules)))
"""
    tops = {m.split(".")[0] for m in _loaded(code)}
    assert tops & (FORBIDDEN | {"repro_torch", "perfbench"}) == \
        {"perfbench"}


SOURCES = sorted(p for p in BDIR.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(BDIR).as_posix())
def test_sources_import_no_jax_and_read_no_benchmarks(path):
    src = path.read_text()
    assert "benchmarks/" not in src
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names & FORBIDDEN == set()
    if "reference" in path.parts:
        assert names & {"repro_torch", "perfbench"} == set()
