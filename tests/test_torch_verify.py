"""Port parity for ``repro_torch.verify``, on the CPU: the footprints, the
hazard analysis and the reference-DAG diff over PAS command DAGs, the
serving-protocol lint, the exactly-once and snapshot-provenance audits,
the host-sync lint and the ``launch.verify`` CLI, against the
reference's ``repro.verify``.

DAGs come from each package's own ``reference_commands``; traces are
served by the port's engine (float32 weights from a numpy seed), and the
reference's passes read them through its own ``Trace``. Findings compare
through ``Finding.to_dict``: the port's copy must report exactly what the
reference's reports, on clean traces, on the committed
``benchmarks/data`` traces and on mutated ones (a dropped dependency
edge, a decode into a slot mid-prefill, a gather before its scatter, a
split superstep, an unpaired fused step, a duplicate completion, a
restore with no durable snapshot). The one rule where the two differ, a
restored prefix that is no chunk multiple, has its own cases."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.verify as rv
from repro.configs import get_arch as ref_arch
from repro.core import pas as ref_pas
from repro.trace.lower import trace_to_commands as ref_lower
from repro.trace.schema import Trace as RefTrace
from repro.trace.schema import model_config_from_header as ref_header
from repro_torch.chaos import FaultPlan, serve_fleet_chaos
from repro_torch.configs import get_arch
from repro_torch.core.pas import (DMA, MU, PIM, Command, PASPolicy,
                                  command_to_dict, merge_streams)
from repro_torch.launch import verify as launch_verify
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.sched.packing import plan_packed_job
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.trace import (ArrivalEvent, Trace, TraceRecorder,
                               bursty_arrivals, drive, poisson_arrivals,
                               trace_to_commands)
from repro_torch.trace.schema import model_config_from_header
from repro_torch.verify import (analyze_commands, analyze_lowered, bank_set,
                                check_exactly_once,
                                check_snapshot_provenance,
                                command_footprints, diff_commands,
                                lint_host_syncs, lint_trace, load_allowlist,
                                reference_commands, verify_lowered_step)
from repro_torch.verify.footprints import Resource

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "benchmarks" / "data"
PORT = ROOT / "src" / "repro_torch"
LINTED = ("serve", "sched", "obs", "fleet", "chaos")
ALLOWED = {"serve/engine.py::ServeEngine._fetch_np",
           "serve/engine.py::ServeEngine.export_kv_snapshot",
           "chaos/snapshots.py::_jsonable"}
COMBOS = {
    "serial": dict(policy="serial"),
    "interleaved": dict(policy="interleaved"),
    "pim_aware": dict(policy="pim_aware"),
    "serial-knobs": dict(policy="serial", pack=True, fuse=True, superstep=4),
    "interleaved-knobs": dict(policy="interleaved", pack=True, fuse=True,
                              superstep=4),
    "pim_aware-knobs": dict(policy="pim_aware", pack=True, fuse=True,
                            superstep=4),
}
POLICIES = {"paper": (PASPolicy.paper(), ref_pas.PASPolicy.paper()),
            "7b": (PASPolicy(qk_sv_unit=PIM),
                   ref_pas.PASPolicy(qk_sv_unit="PIM")),
            "naive": (PASPolicy.naive(), ref_pas.PASPolicy.naive()),
            "no-adaptive": (PASPolicy(adaptive_fc=False),
                            ref_pas.PASPolicy(adaptive_fc=False))}


def found(findings):
    return [f.to_dict() for f in findings]


def classes(findings):
    return [(f.severity, f.klass) for f in findings]


def ref_of(trace):
    """The reference's ``Trace`` of a port trace (the same JSONL)."""
    return RefTrace.loads(trace.dumps())


def mutate(trace):
    return Trace.loads(trace.dumps())


@pytest.fixture(scope="module")
def cfgs():
    return (get_arch("llama3.2-1b").reduced(),
            ref_arch("llama3.2-1b").reduced())


def both(cfgs, phase, n, kv, policy="paper"):
    pol, rpol = POLICIES[policy]
    return (reference_commands(cfgs[0], phase, n, kv, pol),
            rv.reference_commands(cfgs[1], phase, n, kv, rpol))


def drop_dep(cmds, cmd_name, dep_name):
    idx = {c.name: i for i, c in enumerate(cmds)}
    ci, di = idx[cmd_name], idx[dep_name]
    out = list(cmds)
    assert di in out[ci].deps
    out[ci] = dataclasses.replace(
        out[ci], deps=tuple(d for d in out[ci].deps if d != di))
    return out


# --------------------------------------------------------------------------- #
# DAG level: reference_commands, hazards, the reference diff, footprints
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("phase,n,kv,policy", [
    ("summarization", 16, 16, "paper"), ("generation", 1, 24, "paper"),
    ("generation", 1, 24, "7b"), ("generation", 1, 24, "naive"),
    ("generation", 1, 24, "no-adaptive")],
    ids=["summar", "gen", "gen-7b", "naive", "no-adaptive"])
def test_clean_combos_match_the_reference(cfgs, phase, n, kv, policy):
    cmds, ref = both(cfgs, phase, n, kv, policy)
    assert [ref_pas.command_to_dict(c) for c in ref] == \
        [command_to_dict(c) for c in cmds]
    assert analyze_commands(cmds) == [] == rv.analyze_commands(ref)
    fps = [dataclasses.asdict(f) for f in command_footprints(cmds)]
    assert fps == [dataclasses.asdict(f) for f in rv.command_footprints(ref)]


@pytest.mark.parametrize("mode,issue", [("parallel", "shared"),
                                        ("parallel", "chained"),
                                        ("pipelined", "shared")])
def test_merged_streams_are_hazard_free(cfgs, mode, issue):
    streams = [reference_commands(cfgs[0], "generation", 1, 24 + 8 * i)
               for i in range(3)]
    merged = merge_streams(streams, mode=mode, issue_mode=issue)
    assert analyze_commands(merged) == []


@pytest.mark.parametrize("phase,policy,cmd,dep,klass", [
    ("summarization", "paper", "ffn1.0", "ffn1.w0", "raw"),
    ("generation", "7b", "qk.0", "kv_store", "pim_normal_unordered"),
    ("generation", "paper", "qk.c0", "kv_prefetch", "raw")])
def test_dropped_edges_give_the_references_findings(cfgs, phase, policy,
                                                    cmd, dep, klass):
    n, kv = (16, 16) if phase == "summarization" else (1, 24)
    cmds, ref = both(cfgs, phase, n, kv, policy)
    got = analyze_commands(drop_dep(cmds, cmd, dep))
    assert got and {f.klass for f in got} == {klass}
    assert found(got) == found(rv.analyze_commands(drop_dep(ref, cmd, dep)))
    f = got[0]
    assert f.severity == "error" and "<fork>" in f.witness


def test_the_diff_catches_every_dropped_edge(cfgs):
    cmds, ref = both(cfgs, "generation", 1, 24)
    n_edges = 0
    for i, c in enumerate(cmds):
        for d in c.deps:
            n_edges += 1
            mutated = list(cmds)
            mutated[i] = dataclasses.replace(
                c, deps=tuple(x for x in c.deps if x != d))
            rmut = list(ref)
            rmut[i] = dataclasses.replace(
                ref[i], deps=tuple(x for x in ref[i].deps if x != d))
            got = diff_commands(mutated, cmds)
            assert any(f.klass == "missing_dep" and f.commands[0] == i
                       and d in f.commands[1:] for f in got), (i, d)
            assert found(got) == found(rv.diff_commands(rmut, ref))
    assert n_edges > 100


def test_extra_edges_shape_and_structure_match_the_reference(cfgs):
    cmds, ref = both(cfgs, "generation", 1, 24)
    tail = len(cmds) - 1
    extra = list(cmds)
    extra[tail] = dataclasses.replace(extra[tail],
                                      deps=extra[tail].deps + (0,))
    rextra = list(ref)
    rextra[tail] = dataclasses.replace(rextra[tail],
                                       deps=rextra[tail].deps + (0,))
    assert classes(diff_commands(extra, cmds)) == [("warning", "extra_dep")]
    assert found(diff_commands(extra, cmds)) == \
        found(rv.diff_commands(rextra, ref))
    assert found(diff_commands(cmds[:-1], cmds)) == \
        found(rv.diff_commands(ref[:-1], ref))
    for deps, want in (((), (5,)), "dangling_dep"), (((1,), ()),
                                                       "forward_dep"):
        got = analyze_commands([Command("a", DMA, "dma_load", bytes=4,
                                        deps=deps[0]),
                                Command("b", MU, "fc", deps=deps[1])])
        assert [f.klass for f in got] == [want]
        assert found(got) == found(rv.analyze_commands(
            [ref_pas.Command("a", "DMA", "dma_load", bytes=4, deps=deps[0]),
             ref_pas.Command("b", "MU", "fc", deps=deps[1])]))


def test_bank_sets_match_the_reference():
    for space, key, lo, hi in (("kv", "#0", 0, 8192), ("kv", "#3", 4096,
                                                        70000),
                               ("kvbuf", "#0", 0, 0), ("wbuf", "w", 0, 64)):
        got = bank_set(Resource(space, key, lo, hi))
        assert got == rv.bank_set(rv.Resource(space, key, lo, hi))
    assert bank_set(Resource("kv", "#0", 0, 8192))
    assert bank_set(Resource("kvbuf", "#0")) == ()


# --------------------------------------------------------------------------- #
# the protocol lint over traces the port's engine records
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def params(cfgs):
    cfg = dataclasses.replace(cfgs[0], dtype="float32")
    return cfg, init_params(T.param_defs(cfg), device="cpu")


def serve_trace(params, arrivals=None, **serve_kw):
    cfg, p = params
    serve_kw.setdefault("max_slots", 4)
    serve_kw.setdefault("max_len", 64)
    serve_kw.setdefault("prefill_chunk", 8)
    serve_kw.setdefault("map_dims", (2048, 8192))
    rec = TraceRecorder()
    eng = ServeEngine(cfg, p, ServeConfig(**serve_kw), recorder=rec,
                      device="cpu")
    if arrivals is None:
        arrivals = poisson_arrivals(0.5, 24, vocab=cfg.vocab_size,
                                    prompt_len=(2, 20), max_new=(3, 8),
                                    seed=11)
    drive(eng, arrivals)
    return rec.to_trace()


@pytest.fixture(scope="module")
def traces(params):
    return {name: serve_trace(params, **kw) for name, kw in COMBOS.items()}


def lint_both(trace):
    got = lint_trace(trace)
    assert found(got) == found(rv.lint_trace(ref_of(trace)))
    return got


@pytest.mark.parametrize("name", list(COMBOS))
def test_served_traces_lint_clean_on_both(traces, name):
    assert lint_both(traces[name]) == []


@pytest.mark.parametrize("name", ["interleaved-knobs", "pim_aware-knobs"])
def test_lowered_served_traces_are_hazard_free_on_both(traces, name):
    tr = traces[name]
    lowered, ref = trace_to_commands(tr), ref_lower(ref_of(tr))
    assert found(analyze_lowered(lowered)) == \
        found(rv.analyze_lowered(ref)) == []
    cfg, rcfg = model_config_from_header(tr.header), ref_header(tr.header)
    for ls, rls in zip(lowered, ref):
        assert verify_lowered_step(ls, cfg) == []
        assert rv.verify_lowered_step(rls, rcfg) == []


def test_dropped_edge_in_a_lowered_step_matches_the_reference(traces):
    """A lowered fused/superstep trace with one dependency edge dropped:
    the span hazards and the reference diff report what the reference's
    report."""
    tr = traces["interleaved-knobs"]
    lowered, ref = trace_to_commands(tr), ref_lower(ref_of(tr))
    k = next(i for i, ls in enumerate(lowered)
             if any(c.name == "ffn1.0" for c in ls.commands))
    lowered[k] = dataclasses.replace(
        lowered[k], commands=drop_dep(lowered[k].commands, "ffn1.0",
                                      "ffn1.w0"))
    ref[k] = dataclasses.replace(
        ref[k], commands=drop_dep(ref[k].commands, "ffn1.0", "ffn1.w0"))
    got = analyze_lowered(lowered)
    assert got and found(got) == found(rv.analyze_lowered(ref))
    cfg = model_config_from_header(tr.header)
    diff = verify_lowered_step(lowered[k], cfg)
    assert any(f.klass == "missing_dep" for f in diff)
    assert found(diff) == found(rv.verify_lowered_step(
        ref[k], ref_header(tr.header)))


def _decode_events(trace):
    return [(i, e) for i, e in enumerate(trace.events)
            if e["type"] == "decode"]


def _mid_prefill_slot(trace, at):
    need, covered = {}, {}
    for e in trace.events[:at]:
        if e["type"] == "admit":
            for slot, _rid, plen in e["wave"]:
                need[slot], covered[slot] = plen, 0
        elif e["type"] == "prefill" and not e.get("packed"):
            for slot in e["slots"]:
                covered[slot] = covered.get(slot, 0) + e["chunk"]
    for slot, n in need.items():
        if covered.get(slot, 0) < n:
            return slot
    return None


@pytest.mark.parametrize("how", ["active-set", "cursor"])
def test_decode_into_a_mid_prefill_slot(traces, how):
    tr = mutate(traces["interleaved"])
    i, e, slot = next((i, e, s) for i, e in _decode_events(tr)
                      for s in [_mid_prefill_slot(tr, i)]
                      if s is not None and s not in e["slots"])
    if how == "active-set":
        e["slots"] = sorted(e["slots"] + [slot])
    else:
        e["slot_lens"][slot] = 5
    got = lint_both(tr)
    assert classes(got) == [("error", "decode_mid_prefill")]
    assert f"event#{i}" in got[0].location


def test_gather_before_scatter(params):
    arrivals = [ArrivalEvent(step=0,
                             prompt=np.arange(1, 26, dtype=np.int32),
                             max_new=3)]
    tr = serve_trace(params, arrivals=arrivals, max_slots=2,
                     policy="interleaved", pack=True)
    assert lint_both(tr) == []
    tr = mutate(tr)
    a, b = [i for i, e in enumerate(tr.events)
            if e["type"] == "prefill" and e.get("packed")][:2]
    tr.events[a], tr.events[b] = tr.events[b], tr.events[a]
    tr.events[a]["step"], tr.events[b]["step"] = \
        tr.events[b]["step"], tr.events[a]["step"]
    assert classes(lint_both(tr)) == [("error", "gather_before_scatter")]


@pytest.mark.parametrize("how", ["superstep", "fused", "accounting"])
def test_split_superstep_unpaired_fused_and_accounting(traces, how):
    tr = mutate(traces["serial" if how == "accounting"
                       else "interleaved-knobs"])
    if how == "superstep":
        by_sid = {}
        for i, e in _decode_events(tr):
            if e.get("superstep_id", -1) != -1:
                by_sid.setdefault(e["superstep_id"], []).append(i)
        span = next(v for v in by_sid.values() if len(v) >= 3)
        tr.events[span[1]]["superstep_id"] = 999
        want = "superstep_refetch"
    elif how == "fused":
        next(e for _, e in _decode_events(tr) if e.get("fused"))["fused"] = \
            False
        want = "fused_unpaired"
    else:
        tr.summary["dispatch_counts"]["decode"] += 1
        want = "dispatch_accounting"
    assert ("error", want) in classes(lint_both(tr))


# --------------------------------------------------------------------------- #
# committed traces and the fleet audits
# --------------------------------------------------------------------------- #
COMMITTED = sorted(p.name for p in DATA.glob("*.jsonl"))
FLEETS = {"chaos": [f"chaos_node{i}.jsonl" for i in range(3)],
          "chaos_snap": [f"chaos_snap_node{i}.jsonl" for i in range(3)]}


@pytest.mark.parametrize("name", COMMITTED)
def test_committed_traces_give_the_references_findings(name):
    tr, ref = Trace.load(DATA / name), RefTrace.load(DATA / name)
    got = lint_trace(tr)
    lowered = trace_to_commands(tr)
    got += analyze_lowered(lowered)
    cfg = model_config_from_header(tr.header)
    for ls in lowered:
        got += verify_lowered_step(ls, cfg)
    want = rv.lint_trace(ref)
    rlowered = ref_lower(ref)
    want += rv.analyze_lowered(rlowered)
    for ls in rlowered:
        want += rv.verify_lowered_step(ls, ref_header(ref.header))
    assert found(got) == found(want) == []


def _fleet(name):
    return ([Trace.load(DATA / f) for f in FLEETS[name]],
            [RefTrace.load(DATA / f) for f in FLEETS[name]])


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_audits_give_the_references_findings(name):
    trs, refs = _fleet(name)
    for port_fn, ref_fn in ((check_exactly_once, rv.check_exactly_once),
                            (check_snapshot_provenance,
                             rv.check_snapshot_provenance)):
        assert found(port_fn(trs)) == found(ref_fn(refs)) == []


def test_a_duplicate_completion(tmp_path):
    """A gid completed on one node completes again on another."""
    trs, _ = _fleet("chaos")
    done = next(e for e in trs[0].events if e["type"] == "complete")
    dup = dict(done, step=trs[1].events[-1]["step"])
    trs[1].events.append(dup)
    refs = [ref_of(t) for t in trs]
    got = check_exactly_once(trs)
    assert got and found(got) == found(rv.check_exactly_once(refs))


def test_a_restore_with_no_durable_snapshot():
    """Every snapshot event of a restored gid dropped from the fleet's
    traces: the restore has no provenance."""
    trs, _ = _fleet("chaos_snap")
    restore = next(e for t in trs for e in t.events
                   if e["type"] == "restore")
    for t in trs:
        t.events = [e for e in t.events if not (
            e["type"] == "snapshot" and e["gid"] == restore["gid"])]
    got = check_snapshot_provenance(trs)
    assert got and found(got) == found(
        rv.check_snapshot_provenance([ref_of(t) for t in trs]))


# --------------------------------------------------------------------------- #
# the one rule the port's lint changes: a restored prefix off the chunk grid
# --------------------------------------------------------------------------- #
class _Req:
    """A request as the packing planner reads it."""

    def __init__(self, plen, start):
        self.prompt = np.zeros(plen, np.int32)
        self.prefill_start = start


@pytest.fixture(scope="module")
def restored_fleet(params):
    """A fleet at a serving shape (chunk 128, prompts of 64-700) whose
    node 1 crashes after the second snapshot interval, so that survivors
    restore prefixes that are no multiple of the chunk."""
    cfg, p = params
    scfg = ServeConfig(max_slots=8, max_len=1024, prefill_chunk=128,
                       policy="interleaved", pack=True, fuse=True,
                       superstep=4)
    arr = bursty_arrivals(1.0, 24, vocab=cfg.vocab_size, burst=6, idle=6,
                          prompt_len=(64, 700), max_new=(16, 32), seed=3)
    res = serve_fleet_chaos(cfg, p, scfg, arr,
                            FaultPlan.from_spec("node_crash,node=1,step=18"),
                            replicas=3, routing="least_loaded",
                            snapshot_interval=8, snapshot_mirror=True,
                            device="cpu")
    assert res.recoveries and not res.failed
    return list(res.traces.values())


def test_unaligned_restores_read_only_what_was_scattered(restored_fleet):
    """The port's lint gives the reference's findings, finding for
    finding: both flag the packed dispatches after an unaligned restore,
    comparing the padded prefix span. The plan re-derived from each admit
    shows that those gathers read, unmasked, no more than the restored
    plus scattered rows: the reference's known false alarm, which the
    port keeps so that both lints agree on every trace."""
    flagged = 0
    for tr in restored_fleet:
        ref = rv.lint_trace(ref_of(tr))
        flagged += len(ref)
        assert {f.klass for f in ref} <= {"gather_before_scatter"}
        assert [(f.severity, f.klass, f.message, f.location)
                for f in lint_trace(tr)] == \
            [(f.severity, f.klass, f.message, f.location) for f in ref]
        serve = tr.header["serve"]
        for i, e in enumerate(tr.events):
            if e["type"] != "admit" or not e.get("restores"):
                continue
            restored = {s: p for s, _r, p in e["restores"]}
            plan = plan_packed_job(
                [(s, _Req(p, restored.get(s, 0))) for s, _r, p in e["wave"]],
                max_slots=serve["max_slots"], chunk=serve["prefill_chunk"],
                sub_batch=0)
            if plan is None:
                continue
            scattered = sum(restored.values())
            for d in plan.dispatches:
                scattered += d.n_valid
                assert int(d.prefix_len.max(initial=0)) <= scattered
                assert d.prefix_span >= d.prefix_len.max(initial=0)
    assert flagged > 0


def test_a_restore_short_of_the_gather_is_still_caught(restored_fleet):
    """Each restoring admit rewritten to restore one chunk less than it
    did: the dispatch that follows now gathers rows that were neither
    restored nor scattered, and the port's lint reports it."""
    hits = 0
    for tr in restored_fleet:
        chunk = tr.header["serve"]["prefill_chunk"]
        for i, e in enumerate(tr.events):
            if e["type"] != "admit" or not e.get("restores") or any(
                    p < chunk for _s, _r, p in e["restores"]):
                continue
            bad = mutate(tr)
            bad.events[i]["restores"] = [[s, r, p - chunk]
                                         for s, r, p in e["restores"]]
            got = [f for f in lint_trace(bad)
                   if f.klass == "gather_before_scatter"]
            assert got, f"event#{i}"
            hits += 1
    assert hits > 0


# --------------------------------------------------------------------------- #
# the host-sync lint, the CLI and the hazard guard's baseline
# --------------------------------------------------------------------------- #
def test_the_ports_sources_lint_clean_with_exactly_three_entries():
    allow = load_allowlist(PORT / "verify" / "sync_allowlist.txt")
    assert set(allow) == ALLOWED and len(allow) == 3
    dirs = [str(PORT / d) for d in LINTED]
    assert lint_host_syncs(dirs, allow, root=str(PORT)) == []
    bare = lint_host_syncs(dirs, root=str(PORT))
    quals = {f"{f.location.split(':')[0]}::"
             f"{f.message.split(' in ')[1].split(' ')[0]}" for f in bare}
    assert quals == ALLOWED


def test_planted_syncs_are_flagged(tmp_path):
    """A scratch copy of the port's ``serve/`` with a stray ``.item()``,
    ``.cpu()``, ``.tolist()`` and ``.synchronize()``: each is a finding."""
    shutil.copytree(PORT / "serve", tmp_path / "serve")
    allow = load_allowlist(PORT / "verify" / "sync_allowlist.txt")
    assert lint_host_syncs([str(tmp_path / "serve")], allow,
                           root=str(tmp_path)) == []
    (tmp_path / "serve" / "stray.py").write_text(
        "import torch\n"
        "def a(t):\n    return t.item()\n"
        "def b(t):\n    return t.cpu()\n"
        "def c(t):\n    return t.tolist()\n"
        "def d():\n    torch.cuda.synchronize()\n")
    got = lint_host_syncs([str(tmp_path / "serve")], allow,
                          root=str(tmp_path))
    assert classes(got) == [("error", "host_sync")] * 4
    assert [f.location for f in got] == [f"serve/stray.py:{n}"
                                         for n in (3, 5, 7, 9)]
    assert all(f"in {q}" in f.message for f, q in zip(got, "abcd"))


def test_the_cli_exits_zero_on_the_committed_traces():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.verify", "--traces",
         "benchmarks/data"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "total: 0 finding(s)" in out.stdout


def test_the_cli_gate(traces, tmp_path):
    tdir = tmp_path / "traces"
    tdir.mkdir()
    traces["interleaved-knobs"].save(str(tdir / "clean.jsonl"))
    out = tmp_path / "findings.json"
    argv = ["--traces", str(tdir), "--src", str(PORT), "--out", str(out)]
    assert launch_verify.main(argv) == 0
    assert json.loads(out.read_text()) == []
    bad = mutate(traces["serial"])
    bad.summary["dispatch_counts"]["decode"] += 1
    bad.save(str(tdir / "bad.jsonl"))
    assert launch_verify.main(argv) == 1
    assert any(f["class"] == "dispatch_accounting"
               for f in json.loads(out.read_text()))


def test_the_port_reproduces_the_verify_baseline():
    """``benchmarks/hazard_guard.py``'s passes, with the port's modules,
    over the dispatch guard's workload served by the port and over the
    port's sources: the committed baseline's counts (none)."""
    base = json.loads((DATA / "verify_baseline.json").read_text())
    wl, serve = base["workload"]["workload"], base["workload"]["serve"]
    cfg = get_arch("llama3.2-1b").reduced()
    rec = TraceRecorder()
    eng = ServeEngine(cfg, init_params(T.param_defs(cfg), device="cpu"),
                      ServeConfig(**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in serve.items()}),
                      recorder=rec, device="cpu")
    drive(eng, poisson_arrivals(
        wl["rate"], wl["horizon"], vocab=cfg.vocab_size,
        prompt_len=tuple(wl["prompt_len"]), max_new=tuple(wl["max_new"]),
        seed=wl["seed"]))
    trace = rec.to_trace()
    findings = list(lint_trace(trace))
    lowered = trace_to_commands(trace)
    findings += analyze_lowered(lowered)
    hcfg = model_config_from_header(trace.header)
    for ls in lowered:
        findings += verify_lowered_step(ls, hcfg)
    findings += lint_host_syncs(
        [str(PORT / d) for d in LINTED],
        load_allowlist(PORT / "verify" / "sync_allowlist.txt"),
        root=str(PORT))
    counts = {}
    for f in findings:
        counts[f"{f.severity}:{f.klass}"] = \
            counts.get(f"{f.severity}:{f.klass}", 0) + 1
    assert counts == base["finding_counts"] == {}
    assert len(findings) == base["total_findings"] == 0
    assert eng.dispatch_counts["fused"] > 0 and lowered
