"""Port parity for the scheduling policies, on the CPU: ``repro_torch``'s
``serial``, ``interleaved`` and ``pim_aware`` policies, fused steps,
supersteps, its cost model's machines and its arrival processes against
the reference's, at llama3.2-1b ``.reduced()`` in float32 with weights
carried from the JAX tree by ``from_jax_tree``.

Every comparison is exact: greedy tokens (the argmax of logits that agree
within 1e-4 picks the same token on these seeds), dispatch counts, host
syncs, the policies' step counts and decision logs and the recorded trace
are host bookkeeping. The slice gate serves the dispatch guard's workload
(``benchmarks/dispatch_guard.py``) on the port and holds it to the
recorded baseline."""
import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.core import cost_model as jax_cm
from repro.core.pas import route_fc_tpu as jax_route
from repro.models import transformer as RT
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.trace import TraceRecorder
from repro.trace import arrivals as jax_arrivals
from repro.verify import lint_trace
from repro_torch.configs import get_arch
from repro_torch.core import cost_model as cm
from repro_torch.core.pas import route_fc_tpu
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree, init_params
from repro_torch.sched import (InterleavedScheduler, PimAwareScheduler,
                               SerialScheduler, make_scheduler)
from repro_torch.serve import AdmissionRejected, ServeConfig, ServeEngine
from repro_torch.trace import arrivals

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "benchmarks" / "data"
POLICIES = ("serial", "interleaved", "pim_aware")
FULL_DIMS = (2048, 8192)          # llama3.2-1b (pim_aware mapping dims)


def _cfgs(**kw):
    ref = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                              dtype="float32", **kw)
    port = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="float32", **kw)
    return ref, port


def _np_leaf(pd, rng):
    """A float32 leaf drawn as the reference's ``_materialize`` draws it."""
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """float32 weights from a numpy seed, the same in every process (the
    reference's ``init_params`` folds ``hash()`` of each leaf's path into
    its key, which Python randomizes per process; int8 rounding ties make
    greedy parity a property of the weights)."""
    ref, _ = _cfgs()
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(
        RT.param_defs(ref), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def workload():
    """``tests/test_sched.py``'s open-loop workload: mixed prompt lengths
    arriving while others decode."""
    ref, _ = _cfgs()
    return dict(rate=0.5, horizon=24, vocab=ref.vocab_size,
                prompt_len=(2, 40), max_new=(3, 8), seed=1)


# --------------------------------------------------------------------------- #
# the cost model's machines and the FC route
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["IANUS_HW", "TPU_V5E"])
def test_machines_match_the_reference_field_for_field(name):
    """Every field the port's model has (those its time functions read)
    equals the reference machine's."""
    got, ref = getattr(cm, name), getattr(jax_cm, name)
    for field in dataclasses.fields(got):
        assert getattr(got, field.name) == getattr(ref, field.name), field.name


@pytest.mark.parametrize("name", ["IANUS_HW", "TPU_V5E"])
@pytest.mark.parametrize("d_in,d_out", [(2048, 8192), (64, 128),
                                        (1280, 5120), (4096, 14336)])
def test_route_fc_matches_the_reference(name, d_in, d_out):
    """Algorithm 1's GEMM/GEMV decision at every token count up to 2
    passes of the matrix engine (the DRAM-timing GEMV model on the IANUS
    machine, the bandwidth one on the TPU)."""
    hw, jhw = getattr(cm, name), getattr(jax_cm, name)
    got = [route_fc_tpu(n, d_in, d_out, hw) for n in range(1, 257)]
    want = [jax_route(n, d_in, d_out, jhw) for n in range(1, 257)]
    assert got == want
    if name == "IANUS_HW" and (d_in, d_out) == FULL_DIMS:
        assert {"gemm", "gemv"} <= set(got)      # the crossover is in range


def test_scheduler_factory():
    assert isinstance(make_scheduler("serial"), SerialScheduler)
    assert isinstance(make_scheduler("interleaved"), InterleavedScheduler)
    pim = make_scheduler("pim_aware", map_dims=FULL_DIMS, max_jobs=2,
                         decode_floor=3)
    assert isinstance(pim, PimAwareScheduler)
    assert (pim.hw, pim.max_jobs, pim.decode_floor) == (cm.IANUS_HW, 2, 3)
    with pytest.raises(ValueError):
        make_scheduler("nope")


def test_recurrent_stacks_degrade_to_serial():
    """Stacks without chunked prefill serve the interleaving policies as
    ``serial``, as the reference's engine does."""
    cfg = dataclasses.replace(get_arch("rwkv6-7b").reduced(),
                              dtype="float32")
    eng = ServeEngine(cfg, init_params(T.param_defs(cfg), device="cpu"),
                      ServeConfig(max_slots=2, max_len=32,
                                  policy="interleaved", fuse=True,
                                  superstep=4), device="cpu")
    assert eng.effective_policy == "serial"
    assert isinstance(eng.scheduler, SerialScheduler)


# --------------------------------------------------------------------------- #
# arrivals and the open-loop driver
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind", ["poisson", "bursty", "poisson_lengths"])
def test_arrivals_match_the_reference(kind, seed):
    kw = dict(vocab=256, prompt_len=(2, 40), max_new=(3, 10), seed=seed)
    if kind == "poisson_lengths":
        kw["lengths"] = (arrivals.lengths_from_file(DATA / "chat_lengths.json"),
                         jax_arrivals.lengths_from_file(
                             DATA / "chat_lengths.json"))
    fn = "bursty_arrivals" if kind == "bursty" else "poisson_arrivals"

    def events(mod, i):
        args = {k: (v[i] if k == "lengths" else v) for k, v in kw.items()}
        return [(e.step, e.prompt.tolist(), e.max_new)
                for e in getattr(mod, fn)(0.5, 48, **args)]
    got, want = events(arrivals, 0), events(jax_arrivals, 1)
    assert got == want and len(got) > 10


def test_drive_retries_on_the_ports_admission_rejected(params, workload):
    """A bounded queue bounces arrivals; ``drive`` re-injects them and
    serves every request, exactly as the reference's driver does with its
    engine."""
    ref, cfg = _cfgs()
    p, tp = params
    evs = jax_arrivals.bursty_arrivals(0.5, 24, vocab=ref.vocab_size,
                                       prompt_len=(2, 20), max_new=(2, 5),
                                       seed=3)
    scfg = dict(max_slots=2, max_len=64, prefill_chunk=8, queue_cap=1,
                policy="interleaved")
    ej = JaxServeEngine(ref, p, JaxServeConfig(**scfg))
    et = ServeEngine(cfg, tp, ServeConfig(**scfg), device="cpu")
    want = jax_arrivals.drive(ej, evs, return_stats=True)
    got = arrivals.drive(et, evs, return_stats=True)
    assert got == want
    assert got[1]["rejected"] > 0 and et.admission_rejects > 0
    assert len(got[0]) == len(evs)
    with pytest.raises(AdmissionRejected):
        et.add_request([1, 2, 3])
        et.add_request([1, 2, 3])


# --------------------------------------------------------------------------- #
# the engine under every policy and knob against the reference engine
# --------------------------------------------------------------------------- #
KNOBS = {
    "plain": ({}, {}),
    "fuse": ({}, dict(fuse=True)),
    "superstep4": ({}, dict(superstep=4)),
    "pack": ({}, dict(pack=True)),
    "jobs2": ({}, dict(max_prefill_jobs=2)),
    "floor2": ({}, dict(decode_floor=2)),
    "int8": (dict(kv_dtype="int8"), dict(fuse=True, superstep=4)),
    "scatter": (dict(kv_update="scatter"), dict(fuse=True, superstep=4)),
    "pack_fuse_superstep": ({}, dict(pack=True, fuse=True, superstep=4,
                                     max_prefill_jobs=2)),
}


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_reference_engine(params, workload, policy, knob):
    """The open-loop workload through both engines, traced: identical
    greedy tokens, dispatch counts, host syncs, step kinds, deferrals,
    superstep rounds, pim_aware decisions and trace events; the port's
    trace lints clean."""
    cfg_kw, scfg_kw = KNOBS[knob]
    ref, cfg = _cfgs(**cfg_kw)
    p, tp = params
    evs = jax_arrivals.poisson_arrivals(
        workload["rate"], workload["horizon"], vocab=workload["vocab"],
        prompt_len=workload["prompt_len"], max_new=workload["max_new"],
        seed=workload["seed"])
    scfg = dict(max_slots=4, max_len=64, prefill_chunk=8, policy=policy,
                map_dims=FULL_DIMS, **scfg_kw)
    rec_j, rec_t = TraceRecorder(), TraceRecorder()
    ej = JaxServeEngine(ref, p, JaxServeConfig(**scfg), recorder=rec_j)
    et = ServeEngine(cfg, tp, ServeConfig(**scfg), recorder=rec_t,
                     device="cpu")
    want = jax_arrivals.drive(ej, evs)
    got = arrivals.drive(et, evs)
    assert got == want and len(got) == len(evs)
    assert et.dispatch_counts == ej.dispatch_counts
    assert et.host_syncs == ej.host_syncs
    assert et.async_fetches == ej.async_fetches
    assert et.scheduler.stats == ej.scheduler.stats
    assert et.decode_deferrals == ej.decode_deferrals
    assert et.superstep_tokens == ej.superstep_tokens
    assert et.pas_log == ej.pas_log
    assert getattr(et.scheduler, "decision_log", None) == \
        getattr(ej.scheduler, "decision_log", None)
    tj, tt = rec_j.to_trace(), rec_t.to_trace()
    assert tt.events == tj.events
    assert tt.summary == tj.summary
    assert lint_trace(tt) == []
    # one host sync per decode, superstep and fused dispatch
    assert et.host_syncs == et.dispatch_counts["decode"] \
        + et.dispatch_counts["fused"]
    stats = et.scheduler.stats
    if scfg_kw.get("fuse") and policy != "serial":
        assert stats["fused"] > 0
    if scfg_kw.get("superstep", 1) > 1:
        assert stats["superstep"] > 0 and et.superstep_tokens > 0
    if policy == "pim_aware":
        assert {d["overlap"] for d in et.scheduler.decision_log} == \
            {True, False}


# --------------------------------------------------------------------------- #
# the slice gate: the dispatch guard's workload on the port
# --------------------------------------------------------------------------- #
def _dispatch_guard():
    spec = importlib.util.spec_from_file_location(
        "dispatch_guard", ROOT / "benchmarks" / "dispatch_guard.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_reproduces_the_dispatch_baseline():
    """``benchmarks/dispatch_guard.py``'s WORKLOAD and SERVE (interleaved +
    pack + fuse + superstep 4) served on the port through its own
    ``poisson_arrivals``/``drive``: the recorded baseline exactly (the
    workload terminates by budget only, so the schedule does not depend
    on the weights)."""
    guard = _dispatch_guard()
    base = json.loads((DATA / "dispatch_baseline.json").read_text())
    wl, serve = guard.WORKLOAD, guard.SERVE
    assert base["workload"]["serve"]["policy"] == serve["policy"]
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    eng = ServeEngine(cfg, init_params(T.param_defs(cfg), device="cpu"),
                      ServeConfig(**serve), device="cpu")
    evs = arrivals.poisson_arrivals(
        wl["rate"], wl["horizon"], vocab=cfg.vocab_size,
        prompt_len=wl["prompt_len"], max_new=wl["max_new"], seed=wl["seed"])
    results = arrivals.drive(eng, evs)
    assert len(results) == base["requests"] == 15
    assert sum(len(v) for v in results.values()) == base["tokens"] == 106
    assert eng.dispatch_counts == base["dispatch_counts"] == \
        {"prefill": 1, "decode": 9, "fused": 14}
    assert sum(eng.dispatch_counts.values()) == base["total_dispatches"]
    assert eng.host_syncs == base["host_syncs"] == 23


def test_launcher_serves_every_knob():
    results = launch_serve.main([
        "--smoke", "--device", "cpu", "--requests", "6", "--max-new", "5",
        "--prompt-len", "19", "--prefill-chunk", "8", "--policy",
        "interleaved", "--pack", "--fuse", "--superstep", "4",
        "--prefill-jobs", "2", "--decode-floor", "2"])
    assert len(results) == 6 and all(len(v) == 5 for v in results.values())
