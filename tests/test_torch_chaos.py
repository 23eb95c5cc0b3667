"""Port parity for chaos serving and KV snapshots, on the CPU:
``repro_torch.chaos``'s fault plans, fleet health, ``SnapshotStore`` and
``serve_fleet_chaos``, and the engine's degraded mode, halt, KV export and
import, against the reference's, at llama3.2-1b ``.reduced()``.

Plans, health and routing are host bookkeeping and compare exactly. The
engine cases serve float32 weights drawn from a numpy seed and carried
into the port by ``from_jax_tree``: greedy tokens, traces and recovery
records equal the reference's; exported KV rows, computed on each side,
agree within the stated tolerance, and rows moved from one engine to
another are bit for bit. The chaos baseline (``benchmarks/
chaos_guard.py``'s workload and committed plan) ends by budget only: the
port reproduces it on its own bf16 init, where a KV row is 256 bytes."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.chaos import FaultEvent as RefFaultEvent
from repro.chaos import FaultPlan as RefFaultPlan
from repro.chaos import FleetHealth as RefHealth
from repro.chaos import serve_fleet_chaos as ref_serve_fleet_chaos
from repro.configs import get_arch as jax_arch
from repro.models import transformer as RT
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.trace.arrivals import bursty_arrivals as ref_bursty
from repro.trace.schema import Trace as RefTrace
from repro.verify import (check_exactly_once, check_snapshot_provenance,
                          lint_trace)
from repro_torch import verify
from repro_torch.checkpoint import atomic_save_arrays, load_arrays
from repro_torch.chaos import (FAULT_KINDS, FaultEvent, FaultPlan,
                               FleetHealth, SnapshotStore,
                               serve_fleet_chaos)
from repro_torch.configs import get_arch
from repro_torch.fleet import FleetMetrics, serve_fleet
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree, init_params
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.trace import Trace
from repro_torch.trace.arrivals import bursty_arrivals

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "benchmarks" / "data"
FULL_DIMS = (2048, 8192)
SCFG = dict(max_slots=4, max_len=64, prefill_chunk=8, policy="pim_aware",
            pack=True, fuse=True, superstep=4, map_dims=FULL_DIMS)
# one decode round a step, chunked prefill
ONE = dict(max_slots=4, max_len=64, prefill_chunk=8)
# crash node 1 mid-superstep with snapshots due every 4 ticks, beside a
# degraded window (the reference's snapshot tests' plan)
SNAP_PLAN = dict(events=[("node_crash", 1, 9, None),
                         ("pim_degraded", 0, 4, 20)])


def _plans():
    return tuple(P(events=[E(k, n, s, until=u)
                           for k, n, s, u in SNAP_PLAN["events"]])
                 for P, E in ((FaultPlan, FaultEvent),
                              (RefFaultPlan, RefFaultEvent)))


def _np_leaf(pd, rng):
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


def _cfgs(**kw):
    return (dataclasses.replace(jax_arch("llama3.2-1b").reduced(), **kw),
            dataclasses.replace(get_arch("llama3.2-1b").reduced(), **kw))


@pytest.fixture(scope="module")
def weights():
    """float32 weights from a numpy seed: the reference's tree and the
    port's copy of it."""
    ref_cfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(
        RT.param_defs(ref_cfg), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


def _bf16_bits(a) -> np.ndarray:
    """A bf16 row as its 16-bit patterns (the port's host form)."""
    a = np.asarray(a)
    return a if a.dtype == np.uint16 else a.view(np.uint16)


def _as_f32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        return (_bf16_bits(a).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


# --------------------------------------------------------------------------- #
# fault plans and fleet health
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [
    "node_crash,node=1,step=12;pim_degraded,node=0,step=8,until=20;"
    "slow_node,node=2,step=5,until=9,factor=3;"
    "queue_reject,node=0,step=30,until=34,cap=2",
    "pim_degraded,node=0,step=6,until=24;node_crash,node=1,step=10"])
def test_fault_plan_spec_and_json_match_the_reference(spec, tmp_path):
    plan, ref = FaultPlan.from_spec(spec), RefFaultPlan.from_spec(spec)
    assert plan.to_dict() == ref.to_dict()
    assert plan.horizon == ref.horizon
    plan.save(tmp_path / "p.json")
    assert RefFaultPlan.load(tmp_path / "p.json").to_dict() == ref.to_dict()
    assert FaultPlan.load(DATA / "chaos_plan.json").to_dict() \
        == RefFaultPlan.load(DATA / "chaos_plan.json").to_dict()
    with pytest.raises(ValueError):
        FaultEvent("node_crash", 0, 5, until=9)
    with pytest.raises(ValueError):
        FaultPlan(events=[FaultEvent("node_crash", 0, 1)]).validate(1)


@pytest.mark.parametrize("seed", [0, 11, 12, 99])
def test_generated_plans_match_the_reference(seed):
    assert FaultPlan.generate(seed, 3, 48).to_dict() \
        == RefFaultPlan.generate(seed, 3, 48).to_dict()


@pytest.mark.parametrize("pim,energy", [(0.9, 1e6), (0.6, 1e3), (0.1, 0.0)])
def test_cost_model_plans_match_the_reference(pim, energy):
    sim = {"makespan": 1000.0, "utilization": {"PIM": pim, "MU": 0.5},
           "energy": {"mu_flops": energy, "vu_elems": energy / 10,
                      "dram_bytes": energy, "pim_bytes": energy}}
    for seed in (5, 6):
        assert FaultPlan.from_cost_model(sim, seed, replicas=3,
                                         horizon=32).to_dict() \
            == RefFaultPlan.from_cost_model(sim, seed, replicas=3,
                                            horizon=32).to_dict()


def test_fleet_health_matches_the_reference():
    """Every event of a mixed plan, begun and ended in the chaos driver's
    order: the router's and the driver's view of each node agree."""
    spec = ("slow_node,node=2,step=2,until=9,factor=3;"
            "pim_degraded,node=0,step=3,until=12;"
            "queue_reject,node=1,step=4,until=6,cap=2;"
            "node_crash,node=1,step=7")
    plan, ref_plan = FaultPlan.from_spec(spec), RefFaultPlan.from_spec(spec)
    h, rh = FleetHealth(3), RefHealth(3)

    def view(x):
        return [(x.alive(n), x.penalty(n), x.step_cost(n), x.reject_cap(n),
                 x.crash_tick(n)) for n in range(3)]
    for t in range(14):
        for ev, rev in zip(plan.events, ref_plan.events):
            if ev.until == t:
                h.end(ev)
                rh.end(rev)
            if ev.step == t:
                h.begin(ev)
                rh.begin(rev)
        assert view(h) == view(rh), t
    assert set(FAULT_KINDS) >= {e.kind for e in plan.events}


# --------------------------------------------------------------------------- #
# SnapshotStore
# --------------------------------------------------------------------------- #
def _entry(gid, base, plen, val):
    rows = np.full((2, 3, plen - base, 4), val, np.uint16)
    return {"gid": gid, "rid": gid, "slot": 0, "base": base,
            "prefix_len": plen, "cache": {"pos0/k": rows},
            "bytes": int(rows.nbytes), "plen": plen, "generated": [],
            "max_new": 4, "last_tok": 0, "lens": plen, "rng": [0]}


def test_store_merges_deltas_in_memory():
    st = SnapshotStore()
    st.put(0, [_entry(7, 0, 5, 1)], tick=4)
    st.put(0, [_entry(7, 5, 9, 2)], tick=8)
    assert st.since(0) == {7: 9}
    merged = st.lookup(7)["cache"]["pos0/k"]
    assert merged.shape[2] == 9 and merged.dtype == np.uint16
    assert (merged[:, :, :5] == 1).all() and (merged[:, :, 5:] == 2).all()
    with pytest.raises(AssertionError):
        st.put(0, [_entry(7, 7, 12, 3)], tick=12)   # a gap in the chain
    st.drop_node(0)
    assert st.lookup(7) is None and st.stats["dropped"] == 1


def test_store_mirrored_records_survive_their_owner():
    st = SnapshotStore()
    st.put(0, [_entry(2, 0, 4, 1)], tick=4, mirror_node=1)
    st.drop_node(0, alive=lambda n: n != 0)
    assert st.lookup(2) is not None
    st.put(0, [_entry(3, 0, 4, 1)], tick=8, mirror_node=1)
    st.drop_node(1, alive=lambda n: n == 2)          # the mirror goes first
    st.drop_node(0, alive=lambda n: n == 2)
    assert st.lookup(3) is None


def test_store_on_disk_round_trips_bf16_bits(tmp_path):
    """A disk-backed store publishes every merge atomically; after its
    owner's crash the record reloads from disk with every bf16 bit pattern
    (NaN and infinity patterns, negative zero) intact."""
    bits = np.arange(0, 65536, 7, dtype=np.uint16)[:2 * 3 * 4 * 4]
    rows = bits.reshape(2, 3, 4, 4)
    st = SnapshotStore(root=str(tmp_path))
    e = _entry(4, 0, 4, 0)
    e["cache"] = {"pos0/k": rows, "pos0/k_scale": np.linspace(
        -1, 1, 24, dtype=np.float32).reshape(2, 3, 4)}
    st.put(0, [e], tick=4)
    tail = _entry(4, 4, 6, 0xFF80)                   # bf16 -inf
    tail["cache"]["pos0/k_scale"] = np.zeros((2, 3, 2), np.float32)
    st.put(0, [tail], tick=8)
    assert st.stats["disk_writes"] == 2
    st.drop_node(0)
    assert st.records[4]["cache"] is None
    got = st.lookup(4)["cache"]
    assert st.stats["disk_loads"] == 1
    assert got["pos0/k"].dtype == np.uint16
    np.testing.assert_array_equal(got["pos0/k"][:, :, :4], rows)
    assert (got["pos0/k"][:, :, 4:] == 0xFF80).all()
    flat, meta = load_arrays(st.records[4]["path"])
    assert meta["prefix_len"] == 6 and set(flat) == set(got)
    st.drop(4)
    assert st.lookup(4) is None and not list(tmp_path.iterdir())


def test_atomic_save_never_exposes_a_torn_write(tmp_path):
    final = str(tmp_path / "rec")
    atomic_save_arrays(final, {"a": np.arange(6, dtype=np.int8)},
                       metadata={"v": 1})
    (tmp_path / "rec.tmp").mkdir()                    # a crashed save
    flat, meta = load_arrays(final)
    assert meta == {"v": 1} and flat["a"].tolist() == list(range(6))
    atomic_save_arrays(final, {"a": np.ones(2, np.float32)})
    assert load_arrays(final)[0]["a"].dtype == np.float32
    assert not (tmp_path / "rec.tmp").exists()


# --------------------------------------------------------------------------- #
# the engine's export and import against the reference engine's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_kv_export_and_import_match_the_reference(weights, kv_dtype):
    """The same request, three steps into each engine: the exported rows
    (bf16 as 16-bit patterns, or int8 K/V with their float32 scales),
    their bytes and counters match the reference's, the rows within
    3e-2 + 2e-2 |want| (int8: one quantization step); the reference's rows
    restored into the port (``add_request(restore=...)``) come back out
    bit for bit."""
    ref_cfg, cfg = _cfgs(kv_dtype=kv_dtype)
    ref_params, params = weights
    if kv_dtype == "bfloat16":
        # bf16 weights: with float32 ones the reference's cache leaves
        # come back from the model promoted to float32
        ref_params = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                                  ref_params)
        params = from_jax_tree(jax.tree.map(np.asarray, ref_params))
    prompt = np.random.default_rng(9).integers(0, cfg.vocab_size, 12)
    ref = RefServeEngine(ref_cfg, ref_params, RefServeConfig(**ONE))
    eng = ServeEngine(cfg, params, ServeConfig(**ONE), device="cpu")
    for e in (ref, eng):
        assert e.snapshot_supported
        e.add_request(prompt, 30, gid=0)
        for _ in range(3):
            e.step()
    want, = ref.export_kv_snapshot()
    got, = eng.export_kv_snapshot()
    assert eng.export_kv_snapshot(since={0: got["prefix_len"]}) == []
    for k in ("gid", "rid", "slot", "base", "prefix_len", "bytes", "plen",
              "generated", "max_new", "last_tok", "lens"):
        assert got[k] == want[k], k
    assert eng.snapshot_stats == ref.snapshot_stats
    assert eng.export_transfers == 1
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k, w in want["cache"].items():
        g = got["cache"][k]
        assert g.shape == w.shape and g.nbytes == w.nbytes, k
        if kv_dtype == "int8" and g.dtype == np.int8:
            assert np.abs(g.astype(int) - np.asarray(w, int)).max() <= 1
        else:
            # bf16 weights and cache: each package's bf16 matmuls round
            # on their own, two layers deep (the float32 int8 scales
            # agree far closer)
            np.testing.assert_allclose(_as_f32(g), _as_f32(w), rtol=2e-2,
                                       atol=3e-2, err_msg=k)
    # the reference's rows through the port: restored, then exported
    other = ServeEngine(cfg, params, ServeConfig(**ONE), device="cpu")
    full = np.concatenate([prompt, want["generated"]]).astype(np.int32)
    other.add_request(full, 5, gid=3, restore={
        "prefix_len": want["prefix_len"], "bytes": want["bytes"],
        "snapshot_step": 4, "cache": {k: _bf16_bits(v) if v.dtype.itemsize
                                      == 2 else np.asarray(v)
                                      for k, v in want["cache"].items()}})
    other.step()
    back, = other.export_kv_snapshot()
    P = want["prefix_len"]
    assert back["prefix_len"] == P + 1
    for k, w in want["cache"].items():
        w = np.asarray(w)
        np.testing.assert_array_equal(
            back["cache"][k][:, :, :P],
            _bf16_bits(w) if w.dtype.itemsize == 2 else w, err_msg=k)
    assert other.snapshot_stats["restores"] == 1
    assert other.snapshot_stats["restored_tokens"] == P


def test_restore_on_an_rwkv_engine_raises_the_references_error():
    cfg = get_arch("rwkv6-7b").reduced()
    eng = ServeEngine(cfg, init_params(T.param_defs(cfg), device="cpu"),
                      ServeConfig(max_slots=2, max_len=32), device="cpu")
    assert not eng.snapshot_supported
    assert eng.export_kv_snapshot() == []
    with pytest.raises(ValueError, match="batched attention prefill"):
        eng.add_request([1, 2, 3], 2, restore={"prefix_len": 1,
                                               "cache": {}})


def test_halted_engine_refuses_and_degraded_records_the_matrix_engine():
    cfg = get_arch("llama3.2-1b").reduced()
    eng = ServeEngine(cfg, init_params(T.param_defs(cfg), device="cpu"),
                      ServeConfig(**SCFG), device="cpu")
    eng.set_degraded(True)
    eng.add_request(np.arange(20) % cfg.vocab_size, 4, gid=0)
    eng.add_request(np.arange(3), 4, gid=1)
    eng.step()
    assert all(e["ffn_route"] == "gemm" and not e["gemv_path"]
               for e in eng.pas_log)
    assert eng.load_stats() == {"queued": 0, "busy": 2, "ready":
                                sum(eng.slot_ready), "free": 2}
    state = eng.export_recovery_state()
    assert [d["rid"] for d in state] == [0, 1]
    assert all(d["resident"] for d in state)
    with pytest.raises(ValueError, match="outside"):
        eng.add_request([1, 2, 3], 2, restore={"prefix_len": 3})
    eng.halt()
    with pytest.raises(RuntimeError):
        eng.step()
    with pytest.raises(RuntimeError):
        eng.add_request([1, 2], 2)


# --------------------------------------------------------------------------- #
# serve_fleet_chaos against the reference's
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def chaos_pair(weights, tmp_path_factory):
    """One bursty stream through 3 replicas of each package under the
    crash + degraded plan with mirrored snapshots every 4 ticks, and the
    port's run streamed to disk."""
    ref_params, params = weights
    ref_cfg, cfg = _cfgs(dtype="float32")
    kw = dict(vocab=cfg.vocab_size, burst=6, idle=6, prompt_len=(2, 40),
              max_new=(3, 8), seed=3)
    plan, ref_plan = _plans()
    d = tmp_path_factory.mktemp("stream")
    snap = dict(replicas=3, routing="least_loaded", snapshot_interval=4,
                snapshot_mirror=True)
    port = serve_fleet_chaos(cfg, params, ServeConfig(**SCFG),
                             bursty_arrivals(1.0, 24, **kw), plan,
                             stream_dir=str(d), device="cpu", **snap)
    ref = ref_serve_fleet_chaos(ref_cfg, ref_params, RefServeConfig(**SCFG),
                                ref_bursty(1.0, 24, **kw), ref_plan, **snap)
    free = serve_fleet(cfg, params, ServeConfig(**SCFG),
                       bursty_arrivals(1.0, 24, **kw), replicas=3,
                       routing="least_loaded", device="cpu")
    return port, ref, free, d


def test_chaos_tokens_and_recoveries_match_the_reference(chaos_pair):
    port, ref, free, _ = chaos_pair
    assert port.tokens_by_gid() == ref.tokens_by_gid() \
        == free.tokens_by_gid()
    assert port.recoveries == ref.recoveries
    assert port.recoveries and any(r["restored_tokens"]
                                   for r in port.recoveries)
    assert port.assignments == ref.assignments
    assert port.snapshots == ref.snapshots
    assert not port.failed and not port.rejected


@pytest.mark.parametrize("node", [0, 1, 2])
def test_chaos_traces_equal_the_reference_and_lint_clean(chaos_pair, node):
    """Each node's trace, snapshot and restore events included, equals the
    reference node's byte for byte; the streamed JSONL loads to it."""
    port, ref, _, d = chaos_pair
    got = port.traces[node]
    assert got.dumps() == ref.traces[node].dumps()
    assert Trace.load(d / f"node{node}.jsonl").events == got.events
    if node != 1:                       # node 1 crashed mid-serve
        assert lint_trace(RefTrace.loads(got.dumps())) == []
        assert verify.lint_trace(got) == []


@pytest.mark.parametrize("policy,pack,fuse,superstep", [
    ("serial", True, False, 1),
    ("interleaved", True, True, 4),
    ("pim_aware", False, True, 4),     # the unpacked suffix re-prefill
    ("pim_aware", True, True, 4),
])
def test_snapshot_restores_keep_every_token(weights, policy, pack, fuse,
                                            superstep):
    """The reference's restore matrix on the port: under each policy,
    packed or not, the snapshot run restores at least one prefix (taken
    before the crash) and every arrival keeps its fault-free tokens."""
    _, params = weights
    _, cfg = _cfgs(dtype="float32")
    scfg = ServeConfig(**dict(SCFG, policy=policy, pack=pack, fuse=fuse,
                              superstep=superstep))
    arrivals = bursty_arrivals(1.0, 24, vocab=cfg.vocab_size, burst=6,
                               idle=6, prompt_len=(2, 40), max_new=(3, 8),
                               seed=3)
    kw = dict(replicas=3, routing="least_loaded", device="cpu")
    want = serve_fleet(cfg, params, scfg, arrivals, **kw).tokens_by_gid()
    res = serve_fleet_chaos(cfg, params, scfg, arrivals, _plans()[0],
                            snapshot_interval=4, snapshot_mirror=True, **kw)
    assert res.tokens_by_gid() == want
    restored = [r for r in res.recoveries if r["restored_tokens"]]
    assert restored and all(r["snapshot_step"] < r["crash_step"]
                            for r in restored)


def test_port_traces_pass_exactly_once_and_snapshot_provenance(chaos_pair):
    port = chaos_pair[0]
    traces = [RefTrace.loads(t.dumps()) for t in port.traces.values()]
    assert check_exactly_once(traces) == []
    assert check_snapshot_provenance(traces) == []
    own = list(port.traces.values())
    assert verify.check_exactly_once(own) == []
    assert verify.check_snapshot_provenance(own) == []
    assert any(e["type"] == "restore" for t in traces for e in t.events)


def test_degraded_window_serializes_pim_aware(chaos_pair):
    """During node 0's degraded window the pim_aware gate routes both
    phases to the matrix engine and never overlaps."""
    eng = chaos_pair[0].engines[0]
    log = eng.scheduler.decision_log
    inside = [d for d in log if d["degraded"]]
    assert inside and all(not d["overlap"] and d["prefill_route"] == "gemm"
                          for d in inside)
    assert all(4 <= d["step"] < 20 for d in inside)


# --------------------------------------------------------------------------- #
# the guarded chaos workload
# --------------------------------------------------------------------------- #
def test_port_reproduces_the_chaos_baseline(tmp_path):
    """``chaos_guard.py``'s three runs on the port (fault-free, the
    committed plan, the plan with mirrored snapshots every 4 ticks) and
    a fourth disk-backed: the guarded counts equal the baseline; both
    chaos runs give the fault-free tokens, goodput 1.0 and clean
    exactly-once / provenance audits; saved + paid re-prefill equals the
    from-zero cost; the disk-backed run restores from disk alike."""
    base = json.loads((DATA / "chaos_baseline.json").read_text())
    w = base["workload"]
    cfg = get_arch("llama3.2-1b").reduced()
    params = init_params(T.param_defs(cfg), device="cpu", seed=0)
    scfg = ServeConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in w["serve"].items()})
    wl = w["workload"]
    arrivals = bursty_arrivals(wl["rate"], wl["horizon"],
                               vocab=cfg.vocab_size, burst=wl["burst"],
                               idle=wl["idle"],
                               prompt_len=tuple(wl["prompt_len"]),
                               max_new=tuple(wl["max_new"]), seed=wl["seed"])
    plan = FaultPlan.from_dict(w["plan"])
    kw = dict(replicas=w["replicas"], routing=w["routing"], device="cpu")
    free = serve_fleet(cfg, params, scfg, arrivals, **kw)
    chaos = serve_fleet_chaos(cfg, params, scfg, arrivals, plan, **kw)
    snap = serve_fleet_chaos(cfg, params, scfg, arrivals, plan,
                             **w["snapshot"], **kw)
    disk = serve_fleet_chaos(cfg, params, scfg, arrivals, plan,
                             snapshot_interval=4,
                             snapshot_dir=str(tmp_path), **kw)
    c = FleetMetrics.from_traces(chaos.traces).chaos_summary()
    sc = FleetMetrics.from_traces(snap.traces).chaos_summary()
    assert {k: c[k] for k in base["chaos"]} == base["chaos"]
    assert json.loads(json.dumps(c["mttr_ticks"])) == base["mttr_ticks"]
    assert c["faults"] == base["faults"]
    assert len(chaos.recoveries) == base["recoveries"]
    assert sorted(chaos.failed) == base["failed"]
    assert sorted(chaos.rejected) == base["rejected"]
    assert {**{k: sc["snapshots"][k] for k in
               ("events", "bytes", "rows", "restores", "saved_tokens",
                "paid_tokens")},
            "reprefill_tokens": sc["reprefill_tokens"],
            "recoveries": len(snap.recoveries)} == base["snapshots"]
    assert sc["snapshots"]["bytes"] == sc["snapshots"]["rows"] * 256
    assert sc["snapshots"]["saved_tokens"] + sc["reprefill_tokens"] \
        == c["reprefill_tokens"]
    want = free.tokens_by_gid()
    for run in (chaos, snap, disk):
        assert run.tokens_by_gid() == want
        assert not run.failed and not run.rejected
        traces = [RefTrace.loads(t.dumps()) for t in run.traces.values()]
        assert check_exactly_once(traces) == []
        assert check_snapshot_provenance(traces) == []
        own = list(run.traces.values())
        assert verify.check_exactly_once(own) == []
        assert verify.check_snapshot_provenance(own) == []
    assert disk.snapshots["disk_loads"] >= 1
    assert [r["restored_tokens"] for r in disk.recoveries] \
        == [r["restored_tokens"] for r in snap.recoveries]
    exports = sum(e.export_transfers for e in snap.engines.values())
    assert 0 < exports <= sc["snapshots"]["events"]
    assert sum(e.snapshot_stats["export_syncs"]
               for e in snap.engines.values()) \
        == 2 * sc["snapshots"]["events"]
