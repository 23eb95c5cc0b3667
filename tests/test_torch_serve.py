"""Port parity: the port's ``ServeEngine`` against the reference engine on
the CPU, at llama3.2-1b ``.reduced()`` with float32 weights and
``dtype="float32"``.

Greedy tokens, dispatch counts, host syncs, the PAS log and the recorded
trace must be identical (exact: the argmax of logits that agree within
1e-4 picks the same token on these seeds, and every counter is host
bookkeeping)."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.models import transformer as RT
from repro.models.params import init_params as jax_init
from repro.sched import choose_superstep as jax_choose_superstep
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.trace import TraceRecorder
from repro.verify import lint_trace
from repro_torch.configs import get_arch
from repro_torch.models.params import from_jax_tree
from repro_torch.sched import choose_superstep
from repro_torch.serve import AdmissionRejected, ServeConfig, ServeEngine

KEY = jax.random.PRNGKey(0)


def _cfgs(**kw):
    ref = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                              dtype="float32", **kw)
    port = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="float32", **kw)
    return ref, port


@pytest.fixture(scope="module")
def params():
    ref, _ = _cfgs()
    p = jax.tree.map(lambda a: a.astype(jnp.float32),
                     jax_init(RT.param_defs(ref), KEY))
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


def _engine(cfg, params, mode="batched", chunk=8, slots=3, max_len=64,
            **kw):
    return ServeEngine(cfg, params,
                       ServeConfig(max_slots=slots, max_len=max_len,
                                   prefill_mode=mode, prefill_chunk=chunk,
                                   **kw), device="cpu")


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, p).astype(np.int32)
            for p in lens]


def test_batched_matches_sequential_mixed_lengths(params):
    """Port of test_serve_prefill.py's test: both prefill paths give the
    same greedy tokens on a mixed-length batch."""
    _, cfg = _cfgs()
    _, tp = params
    prompts = _prompts(cfg, (5, 17, 1, 30, 9, 2), 0)
    results = {}
    for mode in ("sequential", "batched"):
        eng = _engine(cfg, tp, mode)
        for p in prompts:
            eng.add_request(p, max_new_tokens=6)
        results[mode] = eng.run_until_done()
    assert results["sequential"] == results["batched"]


def test_prefill_dispatch_counts(params):
    """ceil(S/chunk) prefill dispatches batched vs B*(S-1) sequential."""
    _, cfg = _cfgs()
    _, tp = params
    S, chunk, B = 33, 8, 3
    engines = {}
    for mode in ("sequential", "batched"):
        eng = _engine(cfg, tp, mode)
        for p in _prompts(cfg, (S,) * B, 1):
            eng.add_request(p, max_new_tokens=2)
        eng.run_until_done()
        engines[mode] = eng
    assert engines["batched"].dispatch_counts["prefill"] == -(-(S - 1) // chunk)
    assert engines["sequential"].dispatch_counts["prefill"] == B * (S - 1)


def test_decode_is_single_dispatch_single_sync(params):
    _, cfg = _cfgs()
    _, tp = params
    eng = _engine(cfg, tp)
    for p in _prompts(cfg, (4, 11, 2), 7):
        eng.add_request(p, max_new_tokens=5)
    eng.run_until_done()
    gen_steps = sum(e["phase"] == "generation" for e in eng.pas_log)
    assert eng.dispatch_counts["decode"] == gen_steps
    assert eng.host_syncs == gen_steps


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("kv_update", ["onehot", "scatter"])
def test_engine_matches_reference_engine(params, mode, kv_update):
    """Same workload through both engines, traced: identical greedy
    tokens, counters, PAS log and trace events; the port's trace lints
    clean under repro.verify's protocol pass."""
    ref, cfg = _cfgs(kv_update=kv_update)
    p, tp = params
    scfg = dict(max_slots=3, max_len=48, prefill_chunk=8, prefill_mode=mode)
    rec_j, rec_t = TraceRecorder(), TraceRecorder()
    ej = JaxServeEngine(ref, p, JaxServeConfig(**scfg), recorder=rec_j)
    et = ServeEngine(cfg, tp, ServeConfig(**scfg), recorder=rec_t,
                     device="cpu")
    for pr in _prompts(ref, (5, 17, 1, 30, 9), 3):
        ej.add_request(pr, max_new_tokens=5)
        et.add_request(pr, max_new_tokens=5)
    assert et.run_until_done() == ej.run_until_done()
    assert et.dispatch_counts == ej.dispatch_counts
    assert et.host_syncs == ej.host_syncs
    assert et.async_fetches == ej.async_fetches
    assert et.pas_log == ej.pas_log
    tj, tt = rec_j.to_trace(), rec_t.to_trace()
    assert tt.events == tj.events
    assert tt.summary == tj.summary
    assert lint_trace(tt) == []


def test_temperature_sampling_is_deterministic(params):
    """The engine's temperature path: same seed, same tokens, one sync per
    decode step, termination on budget."""
    _, cfg = _cfgs()
    _, tp = params
    outs = []
    for _ in range(2):
        eng = _engine(cfg, tp, slots=2, temperature=0.8, seed=9)
        eng.add_request(_prompts(cfg, (6,), 8)[0], max_new_tokens=4)
        outs.append(eng.run_until_done())
        assert eng.host_syncs == eng.dispatch_counts["decode"]
    assert outs[0] == outs[1]
    assert all(len(v) == 4 for v in outs[0].values())


def _outcome(fn):
    """("ok", result) or (the exception's type name, None)."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001  (compared across packages)
        return type(e).__name__, None


@pytest.mark.parametrize("change", [
    dict(family="encdec", encoder_layers=2, encoder_seq=16),
    dict(family="encdec"), dict(family="vlm"),
    dict(family="vlm", num_patches=4),
])
def test_model_configs_build_or_raise_as_the_reference(params, change):
    """The encdec and vlm families on llama3.2-1b's reduced weights, with
    and without their own fields set: both engines build (an encdec cache
    holds zero cross keys and values over ``encoder_seq`` frames) and
    serve, or raise, alike. A vlm engine takes no patches and serves the
    dense weights to the reference's tokens; an encdec decode step reads
    the cross-attention weights these dense trees lack, in both
    packages."""
    ref, cfg = _cfgs(**change)
    p, tp = params
    prompts = _prompts(cfg, (5, 1, 9), 4)

    def serve(make):
        eng = make()
        for pr in prompts:
            eng.add_request(pr, max_new_tokens=3)
        return eng.run_until_done(), dict(eng.dispatch_counts)

    scfg = dict(max_slots=3, max_len=32, prefill_chunk=8)
    want = _outcome(lambda: serve(lambda: JaxServeEngine(
        ref, p, JaxServeConfig(**scfg))))
    got = _outcome(lambda: serve(lambda: ServeEngine(
        cfg, tp, ServeConfig(**scfg), device="cpu")))
    assert got == want
    assert got[0] == ("ok" if cfg.family == "vlm" else "KeyError")
    eng = _engine(cfg, tp)
    if cfg.family == "encdec":
        assert eng.cache["pos0"]["ck"].shape[3] == cfg.encoder_seq
        assert eng.effective_prefill_mode == "sequential"


def test_snapshot_restore_raises_and_queue_cap_rejects(params):
    _, cfg = _cfgs()
    _, tp = params
    eng = _engine(cfg, tp, queue_cap=1)
    # restores are ported: a prefix outside (0, len(prompt) - 1] raises
    # the reference's ValueError, and nothing is queued
    with pytest.raises(ValueError, match="outside"):
        eng.add_request([1, 2, 3], restore={"prefix_len": 3})
    assert eng.queue == []
    eng.add_request([1, 2, 3])
    with pytest.raises(AdmissionRejected):
        eng.add_request([4, 5])
    assert eng.admission_rejects == 1 and len(eng.queue) == 1


@pytest.mark.parametrize("queued,cap", [(0, 4), (1, 4), (0, 1), (0, 64)])
def test_choose_superstep_matches_reference(queued, cap):
    def req(plen, gen, budget):
        return SimpleNamespace(prompt=np.zeros(plen), generated=[0] * gen,
                               max_new_tokens=budget)
    slots = [req(5, 1, 8), None, req(30, 20, 40), req(3, 0, 2)]
    eng = SimpleNamespace(scfg=SimpleNamespace(superstep=cap, max_len=48),
                          queue=[object()] * queued, slot_req=slots,
                          slot_ready=[True, False, True, False])
    assert choose_superstep(eng) == jax_choose_superstep(eng)
