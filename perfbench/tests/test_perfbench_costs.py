"""The frozen flop formulas count what the port's own cost counter
(``launch/cost.py``) counts as dot-class flops, for one decode round and
one packed prefill chunk of each configuration at ``.reduced()`` size.
The counter counts attention over every cache position and the whole
[prefix; chunk] score matrix, so the formulas are given those pairs."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import costs, harness  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402
from repro_torch.sched.packing import plan_packed_job  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = [c["file"] for c in BENCH["configs"]]


def _reduced(path):
    return harness.model_config(json.loads((ROOT / path).read_text())
                                ).reduced()


@pytest.mark.parametrize("path", CONFIGS)
def test_decode_round_flops_equal_the_counter(path):
    cfg = _reduced(path)
    B, L = 3, 32
    params = init_params(T.param_defs(cfg), device="cpu", seed=1)
    cache = init_params(T.cache_defs(cfg, B, L), device="cpu")
    z = torch.zeros(B, dtype=torch.int32)
    with CostCounter() as c:
        T.decode_and_sample(cfg, params, cache, z + 1, z + 5,
                            torch.ones(B, dtype=torch.bool), z, z + 8, None,
                            temperature=0.0, eos_token=None, max_len=L)
    assert c.flops_dot == costs.decode_round_flops(cfg, [L] * B)


@pytest.mark.parametrize("path", CONFIGS)
def test_packed_prefill_chunk_flops_equal_the_counter(path):
    cfg = _reduced(path)
    B, C, L = 4, 8, 64
    params = init_params(T.param_defs(cfg), device="cpu", seed=2)
    cache = init_params(T.cache_defs(cfg, B, L), device="cpu")
    wave = [(0, Request(0, np.arange(1, 22, dtype=np.int32))),
            (1, Request(1, np.arange(1, 7, dtype=np.int32)))]
    job = plan_packed_job(wave, max_slots=B, chunk=C, sub_batch=0)
    d = job.dispatches[0]
    assert d.prefix_span > 0 and d.segments >= 3
    arrays = [torch.from_numpy(a) for a in (
        d.tokens, d.seg_slot, d.seg_pos, d.seg_ids, d.valid, d.row_slot,
        d.prefix_len)]
    with CostCounter() as c:
        T.prefill_chunk_packed(cfg, params, arrays[0], cache, *arrays[1:],
                               prefix_span=d.prefix_span)
    R = d.tokens.shape[0]
    assert c.flops_dot == costs.prefill_flops(
        cfg, R * C, R * C * (d.prefix_span + C))
