"""Port parity for trace lowering and replay, on the CPU: ``repro_torch``'s
``trace.lower``, ``trace.replay``, the stats CLI's ``--replay`` and the
fleet launcher's, against the reference's.

A small open-loop workload (the reference's ``test_trace.py`` one) is
served by both engines on the same float32 weights, drawn from a numpy
seed; the port's trace must be the reference's, and everything the port
derives from it (lowered steps, mapping decisions, replays on IANUS and
NPU-MEM, baselines, the divergence report) must be what the reference
derives from its own. The committed ``benchmarks/data`` traces (fused
groups, supersteps, fleets, chaos) lower and replay as the reference's
do. Every time here is a simulated machine's, not a measurement."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.trace as ref_trace
from repro.configs import get_arch as ref_arch
from repro.core import NPU_MEM_HW as REF_NPU_MEM_HW
from repro.launch import stats as ref_stats
from repro.models import transformer as RT
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.sim import SimConfig as RefSimConfig
from repro.sim import Simulator as RefSimulator
from repro.sim import merge_results as ref_merge
from repro_torch.configs import get_arch
from repro_torch.core import NPU_MEM_HW, command_from_dict, command_to_dict
from repro_torch.launch import fleet as launch_fleet
from repro_torch.launch import stats
from repro_torch.models.params import from_jax_tree
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.sim import SimConfig, Simulator, merge_results
from repro_torch.trace import (Trace, TraceRecorder, TraceReplayer,
                               baseline_comparison, divergence_report, drive,
                               group_dispatch_spans, group_overlapped,
                               poisson_arrivals, trace_to_commands)

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "benchmarks" / "data"
SCFG = dict(max_slots=3, max_len=64, prefill_chunk=8, eos_token=7)
COMMITTED = sorted(p.name for p in DATA.glob("*.jsonl"))


def _np_leaf(pd, rng):
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def served():
    """``test_trace.py``'s workload through both engines, recorded: the
    port's (config, engine, trace) and the reference's."""
    ref_cfg = dataclasses.replace(ref_arch("llama3.2-1b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(
        RT.param_defs(ref_cfg), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])
    evs = poisson_arrivals(0.6, 12, vocab=cfg.vocab_size,
                           prompt_len=(2, 20), max_new=(2, 6), seed=1)
    rec, ref_rec = TraceRecorder(), ref_trace.TraceRecorder()
    eng = ServeEngine(cfg, from_jax_tree(jax.tree.map(np.asarray, p)),
                      ServeConfig(**SCFG), recorder=rec, device="cpu")
    ref_eng = RefServeEngine(ref_cfg, p, RefServeConfig(**SCFG),
                             recorder=ref_rec)
    results = drive(eng, evs)
    assert results == ref_trace.drive(ref_eng, evs)
    return cfg, eng, rec.to_trace(), ref_rec.to_trace()


def _steps(lowered):
    return [ls.to_dict() for ls in lowered]


def _replay(trace, *, hw=None, cfg=None, **kw):
    """The port's and the reference's replay of one trace (the reference's
    trace object where given a pair)."""
    port, ref = trace
    pkw = dict(cfg=get_arch(cfg) if cfg else None)
    rkw = dict(cfg=ref_arch(cfg) if cfg else None)
    if hw is not None:
        pkw["hw"], rkw["hw"] = NPU_MEM_HW, REF_NPU_MEM_HW
    sim = Simulator(SimConfig(trace=True, issue_overhead=0.1e-6,
                              **({"hw": NPU_MEM_HW} if hw else {})))
    rsim = RefSimulator(RefSimConfig(trace=True, issue_overhead=0.1e-6,
                                     **({"hw": REF_NPU_MEM_HW} if hw
                                        else {})))
    got = TraceReplayer(sim).replay(trace_to_commands(port, **pkw), **kw)
    want = ref_trace.TraceReplayer(rsim).replay(
        ref_trace.trace_to_commands(ref, **rkw), **kw)
    return got, want


# --------------------------------------------------------------------------- #
# the served trace and its lowering
# --------------------------------------------------------------------------- #
def test_the_ports_trace_is_the_references(served):
    _cfg, _eng, tr, ref = served
    assert tr.header == ref.header
    assert tr.events == ref.events and tr.summary == ref.summary
    assert tr.dumps() == ref.dumps()


@pytest.mark.parametrize("cfg,hw", [(None, None), ("llama3.2-1b", None),
                                    ("llama3.2-1b", "npu-mem")],
                         ids=["header-dims", "full-dims", "full-npu-mem"])
def test_lowering_matches_the_reference(served, cfg, hw):
    _cfg, _eng, tr, ref = served
    pkw = dict(cfg=get_arch(cfg) if cfg else None)
    rkw = dict(cfg=ref_arch(cfg) if cfg else None)
    if hw:
        pkw["hw"], rkw["hw"] = NPU_MEM_HW, REF_NPU_MEM_HW
    got = trace_to_commands(tr, **pkw)
    want = ref_trace.trace_to_commands(ref, **rkw)
    assert _steps(got) == _steps(want)
    assert divergence_report(got) == ref_trace.divergence_report(want)
    assert [[ls.step for ls in g] for g in group_overlapped(got)] \
        == [[ls.step for ls in g] for g in ref_trace.group_overlapped(want)]
    assert [[ls.step for ls in g] for g in group_dispatch_spans(got)] \
        == [[ls.step for ls in g]
            for g in ref_trace.group_dispatch_spans(want)]


def test_lowering_is_deterministic_and_serializable(served):
    _cfg, _eng, tr, _ref = served
    a = trace_to_commands(tr)
    b = trace_to_commands(Trace.loads(tr.dumps()))
    assert _steps(a) == _steps(b)
    for c in a[0].commands + a[-1].commands:
        assert command_from_dict(command_to_dict(c)) == c
    json.dumps(a[0].to_dict())


def test_lowered_stream_covers_every_served_step(served):
    _cfg, eng, tr, _ref = served
    lowered = trace_to_commands(tr)
    assert len(lowered) == len(tr.schedulable) == \
        eng.dispatch_counts["prefill"] + eng.dispatch_counts["decode"]
    for ls, ev in zip(lowered, tr.schedulable):
        assert ls.commands and ls.step == ev["step"]
        assert ls.phase == ("summarization" if ev["type"] == "prefill"
                            else "generation")


# --------------------------------------------------------------------------- #
# replay
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg,hw,kw", [
    (None, None, {}), ("llama3.2-1b", None, {}),
    ("llama3.2-1b", "npu-mem", {}),
    (None, None, dict(cross_step=True)),
    (None, None, dict(cross_step=True, window=4))],
    ids=["header-dims", "ianus", "npu-mem", "cross-step", "window-4"])
def test_replay_matches_the_reference(served, cfg, hw, kw):
    _cfg, _eng, tr, ref = served
    got, want = _replay((tr, ref), hw=hw, cfg=cfg, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.result.trace == want.result.trace
    assert got.exposed_tags == want.exposed_tags


def test_replay_breakdown_structure(served):
    _cfg, _eng, tr, _ref = served
    lowered = trace_to_commands(tr)
    rep = TraceReplayer().replay(lowered)
    assert rep.makespan == pytest.approx(
        rep.phase_time["summarization"] + rep.phase_time["generation"])
    assert rep.result.n_commands == sum(len(ls.commands) for ls in lowered)
    for tag in ("ffn", "self_attn", "norm_res"):
        assert rep.exposed_tags.get(tag, 0.0) > 0.0
    for row in rep.divergence:
        assert 0.0 <= row["agreement"] <= 1.0 and row["agree"] <= row["n"]
    json.dumps(rep.to_dict())


def test_full_dims_beat_npu_mem_and_baselines_match(served):
    """At paper-scale dims the PIM win shows (the smoke dims sit below
    every crossover); the A100 / DFX comparison equals the reference's."""
    _cfg, _eng, tr, ref = served
    rep, _ = _replay((tr, ref), cfg="llama3.2-1b")
    repn, _ = _replay((tr, ref), cfg="llama3.2-1b", hw="npu-mem")
    assert repn.makespan > rep.makespan * 1.2
    assert rep.result.group_utilization("PIM") > 0.2
    full = get_arch("llama3.2-1b")
    got = baseline_comparison(trace_to_commands(tr, cfg=full), full)
    assert got == ref_trace.baseline_comparison(
        ref_trace.trace_to_commands(ref, cfg=ref_arch("llama3.2-1b")),
        ref_arch("llama3.2-1b"))
    assert got["a100"]["total"] > 0 and got["dfx"]["total"] > 0


def test_merge_results_composes_sequentially(served):
    _cfg, _eng, tr, ref = served
    sim = Simulator(SimConfig(trace=True, issue_overhead=0.1e-6))
    rsim = RefSimulator(RefSimConfig(trace=True, issue_overhead=0.1e-6))
    parts = [sim.run(ls.commands) for ls in trace_to_commands(tr)[:4]]
    merged = merge_results(parts)
    want = ref_merge([rsim.run(ls.commands)
                      for ls in ref_trace.trace_to_commands(ref)[:4]])
    assert merged.to_dict() == want.to_dict()
    assert merged.makespan == pytest.approx(sum(p.makespan for p in parts))
    assert max(e for _s, e, *_ in merged.trace) <= merged.makespan + 1e-12


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_traces_lower_and_replay_as_the_reference(name):
    """The committed traces (the hazard guard's fused + superstep smoke
    trace, the chaos fleets' nodes) through both packages."""
    tr = Trace.load(DATA / name)
    ref = ref_trace.Trace.load(DATA / name)
    got, want = trace_to_commands(tr), ref_trace.trace_to_commands(ref)
    assert _steps(got) == _steps(want)
    rep = TraceReplayer().replay(got)
    assert rep.to_dict() == ref_trace.TraceReplayer().replay(want).to_dict()
    if name == "smoke_trace.jsonl":
        assert rep.overlap_stats["fused_groups"] > 0
        assert rep.superstep_stats["spans"] > 0


# --------------------------------------------------------------------------- #
# the engine, the stats CLI and the fleet launcher
# --------------------------------------------------------------------------- #
def test_has_ready_slots_agrees_with_the_reference():
    """Both engines stepped in lockstep on one workload: after every step
    ``has_ready_slots`` (and the ready set) agree."""
    ref_cfg = dataclasses.replace(ref_arch("llama3.2-1b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree_util.tree_flatten(
        RT.param_defs(ref_cfg), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])
    scfg = dict(max_slots=3, max_len=64, prefill_chunk=8,
                policy="interleaved")
    eng = ServeEngine(cfg, from_jax_tree(jax.tree.map(np.asarray, p)),
                      ServeConfig(**scfg), device="cpu")
    ref = RefServeEngine(ref_cfg, p, RefServeConfig(**scfg))
    assert eng.has_ready_slots() is ref.has_ready_slots() is False
    for n in (20, 5, 30, 3):
        prompt = rng.integers(0, cfg.vocab_size, n).astype(np.int32)
        eng.add_request(prompt, max_new_tokens=4)
        ref.add_request(prompt, max_new_tokens=4)
    seen = set()
    while eng.queue or any(r is not None for r in eng.slot_req):
        assert eng.step() == ref.step()
        assert eng.has_ready_slots() == ref.has_ready_slots()
        assert eng.ready_slot_ids() == ref.ready_slot_ids()
        seen.add(eng.has_ready_slots())
    assert seen == {True, False}


@pytest.mark.parametrize("traces", [["smoke_trace.jsonl"],
                                    ["chaos_snap_node0.jsonl",
                                     "chaos_snap_node1.jsonl",
                                     "chaos_snap_node2.jsonl"]],
                         ids=["engine", "fleet"])
def test_stats_cli_replay_matches_the_reference(traces, tmp_path):
    """``launch.stats <trace(s)> --replay``: the port's metrics report and
    timeline (simulator tracks included) equal the reference's."""
    paths = [str(DATA / t) for t in traces]
    out = {}
    for name, mod in (("port", stats), ("ref", ref_stats)):
        m, t = tmp_path / f"{name}.json", tmp_path / f"{name}_tl.json"
        assert mod.main(paths + ["--out", str(m), "--timeline", str(t),
                                 "--replay"]) == 0
        out[name] = (json.loads(m.read_text()), json.loads(t.read_text()))
    assert out["port"] == out["ref"]
    assert any(e.get("cat") == "sim" for e in out["port"][1]["traceEvents"])


def test_fleet_launcher_replays_each_node(tmp_path):
    """``launch.fleet --replay --device cpu``: each node's trace replays
    through the simulator; the fleet report's utilization is what the
    reference's replayer gives on the same saved node traces."""
    m, d = tmp_path / "m.json", tmp_path / "traces"
    assert launch_fleet.main(["--device", "cpu", "--replicas", "2",
                              "--horizon", "16", "--replay",
                              "--metrics-out", str(m),
                              "--traces-out", str(d)]) == 0
    util = json.loads(m.read_text())["fleet"]["utilization"]
    assert util is not None
    for node in (0, 1):
        ref = ref_trace.Trace.load(d / f"node{node}.jsonl")
        rep = ref_trace.TraceReplayer().replay(
            ref_trace.trace_to_commands(ref))
        assert util["per_node"][str(node)] == {
            "makespan": rep.makespan,
            "mu": rep.result.group_utilization("MU"),
            "pim": rep.result.group_utilization("PIM")}
