"""A run end to end on the CPU, past the look for a card: a cell, a traffic
mix, a configuration and a metric added as files are found and reported;
a sound run is correct; with the timed path broken underneath, each fault
a served cell can have makes ``correct`` false; and the control (the
reference in float8, in the program's place) fails the limit that sound
runs meet."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(Path(__file__).parent)]

import perfbench_tiny  # noqa: E402
from perfbench import control, harness  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    torch.set_num_threads(2)
    return perfbench_tiny.build(tmp_path_factory.mktemp("perfbench"))


def _run(root, seed=SEED):
    return harness.run_cell(root, perfbench_tiny.CELL, seed, 2.0, False,
                            time.perf_counter(), device="cpu")


def test_added_cell_and_metric_are_found_and_the_run_is_correct(tiny):
    out = _run(tiny)
    assert set(out["metrics"]) >= {perfbench_tiny.METRIC, "output_tok_s",
                                   "ttft_p90_ms", "setup_s"}
    assert out["metrics"][perfbench_tiny.METRIC]["value"] > 0
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["checks"]["tokens_compared"]["value"] >= 20


def _skip_decode_kv_write(monkeypatch):
    """A step that returns its state unchanged: decode writes no K/V."""
    monkeypatch.setattr(A, "update_kv_cache",
                        lambda k, v, *a, **kw: (k, v))


def _skip_prefill_kv_write(monkeypatch):
    """Prefill leaves the cache as it was."""
    monkeypatch.setattr(A, "write_kv_packed",
                        lambda k, v, *a, **kw: (k, v))


def _half_batch(monkeypatch):
    """The decode computes the first half of the slots; the second half
    takes the first half's logits."""
    step = T.decode_step

    def half(cfg, params, tokens, cache, cur_len):
        logits, cache = step(cfg, params, tokens, cache, cur_len)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), cache
    monkeypatch.setattr(T, "decode_step", half)


def _altered_token(monkeypatch):
    """A token altered where it is produced: each round, the next slot's
    in turn."""
    sample = T.decode_and_sample
    rounds = [0]

    def altered(cfg, *a, **kw):
        fetch, cache, toks, lens, gen, draw = sample(cfg, *a, **kw)
        i = rounds[0] % toks.shape[0]
        rounds[0] += 1
        toks = toks.clone()
        toks[i] = (toks[i] + 1) % cfg.vocab_size
        fetch = fetch.clone()
        fetch[0, i] = toks[i]
        return fetch, cache, toks, lens, gen, draw
    monkeypatch.setattr(T, "decode_and_sample", altered)


@pytest.mark.parametrize("fault", [_skip_decode_kv_write,
                                   _skip_prefill_kv_write, _half_batch,
                                   _altered_token],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(tiny)
    assert not out["correct"], out["checks"]


def test_the_control_fails_the_limit_sound_runs_meet(tiny):
    rows = control.readings(tiny, perfbench_tiny.CELL, [SEED], {SEED}, 2.0,
                            device="cpu")
    limit = perfbench_tiny.WORKLOAD["check"]["max_logit_gap"]
    assert rows[0]["program_max_gap"] <= limit < rows[0]["control_max_gap"]
