"""Port parity for serving observability, on the CPU: ``repro_torch``'s
trace schema, ``TraceRecorder``, ``obs.MetricsHub`` and timeline, and the
launcher's ``--metrics-out`` / ``--timeline-out``, against the
reference's, at llama3.2-1b ``.reduced()``.

Everything compared here is host bookkeeping, so every comparison is
exact: event streams byte for byte, metric summaries key for key. No
reference engine runs here: the port's engine serves on its own seeded
weights, and what is compared is what the two packages make of its
events. The latency baseline (``benchmarks/latency_guard.py``'s workload)
ends by budget only, so its tick latencies do not depend on the
weights."""
import json
from pathlib import Path

import pytest

from repro.obs import MetricsHub as RefHub
from repro.obs import engine_events as ref_engine_events
from repro.trace import TraceRecorder as RefRecorder
from repro.trace import schema as ref_schema
from repro.trace.schema import Trace as RefTrace
from repro.verify import lint_trace
from repro_torch import verify
from repro_torch.configs import get_arch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.stats import check_coverage
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params
from repro_torch.obs import (Gauge, Histogram, MetricsHub, dispatch_slices,
                             engine_events)
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.trace import (SCHEMA_VERSION, Trace, TraceRecorder, drive,
                               poisson_arrivals)
from repro_torch.trace import schema

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "benchmarks" / "data"
POLICIES = ("serial", "interleaved", "pim_aware")
FULL_DIMS = (2048, 8192)
KNOBS = dict(pack=True, fuse=True, superstep=4)


def _cfg():
    return get_arch("llama3.2-1b").reduced()


@pytest.fixture(scope="module")
def params():
    return init_params(T.param_defs(_cfg()), device="cpu", seed=0)


@pytest.fixture(scope="module")
def arrivals():
    return poisson_arrivals(0.5, 24, vocab=_cfg().vocab_size,
                            prompt_len=(2, 40), max_new=(3, 8), seed=1)


def _serve(params, arrivals, policy, recorder=None, **kw):
    eng = ServeEngine(_cfg(), params, ServeConfig(
        max_slots=4, max_len=64, prefill_chunk=8, policy=policy,
        map_dims=FULL_DIMS, **kw), recorder=recorder, device="cpu")
    results = drive(eng, arrivals)
    return eng, results


@pytest.fixture(scope="module")
def served(params, arrivals):
    """Per policy (with pack, fuse and superstep 4): the port's engine
    recorded by the port's recorder (a live hub on its sinks) and, in a
    second serve of the same workload, by the reference's recorder."""
    out = {}
    for policy in POLICIES:
        hub = MetricsHub()
        rec = TraceRecorder(sinks=[hub])
        eng, results = _serve(params, arrivals, policy, rec, **KNOBS)
        ref_rec = RefRecorder()
        _serve(params, arrivals, policy, ref_rec, **KNOBS)
        out[policy] = dict(eng=eng, results=results, hub=hub,
                           trace=rec.to_trace(), ref=ref_rec.to_trace())
    return out


# --------------------------------------------------------------------------- #
# schema and recorder
# --------------------------------------------------------------------------- #
def test_schema_constants_match_the_reference():
    assert SCHEMA_VERSION == ref_schema.SCHEMA_VERSION
    assert schema.SUPPORTED_VERSIONS == ref_schema.SUPPORTED_VERSIONS
    for name in ("_REQUIRED", "_REQUIRED_V2", "_REQUIRED_V3",
                 "_REQUIRED_V4", "_REQUIRED_V5", "_REQUIRED_V6",
                 "_REQUIRED_V7", "_REQUIRED_V8", "_MODEL_KEYS",
                 "_ROUTE_KEYS", "_V1_DEFAULTS"):
        assert getattr(schema, name) == getattr(ref_schema, name), name


@pytest.mark.parametrize("name", sorted(
    p.name for p in DATA.glob("*.jsonl")))
def test_committed_traces_load_as_the_reference_loads_them(name):
    """Every committed trace (v1-v8 semantics, upgraded in place) loads,
    validates and serializes to the reference's bytes."""
    text = (DATA / name).read_text()
    got, want = Trace.loads(text), RefTrace.loads(text)
    assert got.dumps() == want.dumps()
    assert got.validate().version == want.version


@pytest.mark.parametrize("policy", POLICIES)
def test_recorders_write_identical_streams(served, policy):
    """The port's recorder and the reference's, each bound to the port's
    engine on the same workload, write the same JSONL byte for byte
    (header, every event, the summary with its snapshot counters), and
    the reference's protocol lint and the port's find nothing in it."""
    s = served[policy]
    assert s["trace"].dumps() == s["ref"].dumps()
    assert s["trace"].summary["host_syncs"] == s["eng"].host_syncs
    assert lint_trace(RefTrace.loads(s["trace"].dumps())) == []
    assert verify.lint_trace(s["trace"]) == []


@pytest.mark.parametrize("policy", POLICIES)
def test_metrics_summary_equals_the_reference(served, policy):
    """The port's hub (live, on the recorder's sinks) and the reference's
    (offline, on the same JSONL) give the same summary and report."""
    s = served[policy]
    ref = RefHub().ingest(RefTrace.loads(s["trace"].dumps()))
    assert s["hub"].summary() == ref.summary()
    assert json.dumps(s["hub"].to_dict()) == json.dumps(ref.to_dict())
    offline = MetricsHub().ingest(Trace.loads(s["trace"].dumps()))
    assert offline.summary() == s["hub"].summary()


@pytest.mark.parametrize("policy", POLICIES)
def test_metrics_add_no_dispatch_and_no_sync(params, arrivals, served,
                                             policy):
    """A hub on the recorder changes nothing the engine does."""
    eng, results = _serve(params, arrivals, policy, **KNOBS)
    s = served[policy]
    assert results == s["results"]
    assert eng.dispatch_counts == s["eng"].dispatch_counts
    assert eng.host_syncs == s["eng"].host_syncs


def test_histogram_and_gauge_match_the_reference(rng):
    from repro.obs import Gauge as RefGauge
    from repro.obs import Histogram as RefHistogram
    xs = rng.standard_normal(101) * 7
    h, rh = Histogram("x"), RefHistogram("x")
    g, rg = Gauge("g"), RefGauge("g")
    for i, x in enumerate(xs):
        h.observe(float(x))
        rh.observe(float(x))
        g.set(i // 3, float(x))
        rg.set(i // 3, float(x))
    assert h.summary() == rh.summary()
    assert g.to_dict() == rg.to_dict()


# --------------------------------------------------------------------------- #
# the guarded latency workload
# --------------------------------------------------------------------------- #
def test_port_reproduces_the_latency_baseline():
    """``latency_guard.py``'s workload on the port: request and token
    counts, p50/p99 TTFT and TPOT, queue wait and the dispatch counts
    equal the committed baseline exactly."""
    base = json.loads((DATA / "latency_baseline.json").read_text())
    w = base["workload"]
    cfg = get_arch("llama3.2-1b").reduced()
    params = init_params(T.param_defs(cfg), device="cpu", seed=0)
    serve = {k: tuple(v) if isinstance(v, list) else v
             for k, v in w["serve"].items()}
    hub = MetricsHub()
    rec = TraceRecorder(sinks=[hub])
    eng = ServeEngine(cfg, params, ServeConfig(**serve), recorder=rec,
                      device="cpu")
    drive(eng, poisson_arrivals(w["rate"], w["horizon"],
                                vocab=cfg.vocab_size,
                                prompt_len=tuple(w["prompt_len"]),
                                max_new=tuple(w["max_new"]),
                                seed=w["seed"]))
    rec.to_trace()
    s = hub.summary()
    assert s["requests"]["arrived"] == base["requests"]
    assert s["requests"]["tokens_generated"] == base["tokens"]
    assert {k: s[k.split(".")[0]][k.split(".")[1]]
            for k in base["latency"]} == base["latency"]
    assert {m: s[m] for m in base["summary"]} == base["summary"]
    assert eng.dispatch_counts == base["engine_counts"]


# --------------------------------------------------------------------------- #
# timeline
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", POLICIES)
def test_timeline_covers_every_dispatch(served, policy):
    """The port's timeline equals the reference's on the same trace, and
    ``check_coverage`` finds one dispatch slice a dispatch and one resolve
    slice a host sync; without the dispatch slices it complains."""
    trace = served[policy]["trace"]
    events = engine_events(trace)
    ref = ref_engine_events(RefTrace.loads(trace.dumps()))
    assert json.dumps(events) == json.dumps(ref)
    assert check_coverage(trace, events) == []
    assert len(dispatch_slices(events)) \
        == sum(trace.summary["dispatch_counts"].values())
    broken = [e for e in events
              if not (e["ph"] == "X" and e.get("cat") == "dispatch")]
    problems = check_coverage(trace, broken)
    assert problems and "dispatch slices" in problems[0]


def test_launcher_writes_metrics_and_timeline(tmp_path, capsys):
    """``launch.serve --metrics-out --timeline-out --device cpu``."""
    metrics, timeline = tmp_path / "m.json", tmp_path / "t.json"
    results = launch_serve.main([
        "--smoke", "--device", "cpu", "--requests", "5", "--max-new", "4",
        "--policy", "interleaved", "--pack", "--fuse", "--superstep", "4",
        "--metrics-out", str(metrics), "--timeline-out", str(timeline)])
    report = json.loads(metrics.read_text())
    assert report["summary"]["requests"]["arrived"] == len(results) == 5
    assert report["summary"]["requests"]["tokens_generated"] == 20
    assert report["summary"]["ttft_ticks"]["count"] == 5
    events = json.loads(timeline.read_text())["traceEvents"]
    assert len(dispatch_slices(events)) \
        == report["summary"]["dispatch_mix"]["total"]
    out = capsys.readouterr().out
    assert "[serve] SLO: ttft p50/p99" in out
