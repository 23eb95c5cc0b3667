"""Port parity for fleet serving, on the CPU: ``repro_torch.fleet``'s
routers, ``serve_fleet``, ``FleetMetrics``, the fleet timeline and the
fleet launcher against the reference's, at llama3.2-1b ``.reduced()``.

The token comparison serves the same float32 weights (drawn from a numpy
seed, carried into the port by ``from_jax_tree``) through both packages'
fleets: greedy tokens from logits that agree within 1e-4 are equal on
this seed, and routing, assignments and the metrics are host bookkeeping,
so every comparison is exact. The fleet baseline
(``benchmarks/fleet_replay.py``'s workload) ends by budget only: the port
reproduces it on its own bf16 init."""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.chaos import FaultEvent as RefFaultEvent
from repro.chaos import FleetHealth as RefHealth
from repro.configs import get_arch as jax_arch
from repro.fleet import FleetMetrics as RefFleetMetrics
from repro.fleet import make_router as ref_router
from repro.fleet import serve_fleet as ref_serve_fleet
from repro.models import transformer as RT
from repro.obs import fleet_events as ref_fleet_events
from repro.serve import ServeConfig as RefServeConfig
from repro.trace.arrivals import bursty_arrivals as ref_bursty
from repro.trace.schema import Trace as RefTrace
from repro.verify import lint_trace
from repro_torch import verify
from repro_torch.chaos import FaultEvent, FleetHealth
from repro_torch.configs import get_arch
from repro_torch.fleet import (ROUTING_POLICIES, FleetMetrics, make_router,
                               serve_fleet)
from repro_torch.launch import fleet as launch_fleet
from repro_torch.launch.stats import check_coverage
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree, init_params
from repro_torch.obs import fleet_events, fleet_node_pids
from repro_torch.serve import ServeConfig
from repro_torch.trace import Trace
from repro_torch.trace.arrivals import bursty_arrivals

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "benchmarks" / "data"
SERVE = dict(max_slots=4, max_len=64, prefill_chunk=8, policy="interleaved",
             pack=True, fuse=True, superstep=4, map_dims=(2048, 8192))


class _Load:
    """An engine as a router sees it: its ``load_stats``."""

    def __init__(self, queued, busy):
        self._st = {"queued": queued, "busy": busy, "ready": 0,
                    "free": 4 - busy}

    def load_stats(self):
        return dict(self._st)


def _np_leaf(pd, rng):
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """The float32 config on both sides and one set of numpy-seeded
    weights: the reference's tree and the port's copy of it."""
    ref_cfg = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(
        RT.param_defs(ref_cfg), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])
    return ref_cfg, p, cfg, from_jax_tree(jax.tree.map(np.asarray, p))


@pytest.fixture(scope="module")
def fleets(pair):
    """The same bursty stream through a 2-replica fleet of each package,
    least_loaded routing."""
    ref_cfg, ref_params, cfg, params = pair
    kw = dict(vocab=cfg.vocab_size, burst=6, idle=6, prompt_len=(2, 40),
              max_new=(3, 8), seed=3)
    ref = ref_serve_fleet(ref_cfg, ref_params, RefServeConfig(**SERVE),
                          ref_bursty(1.0, 24, **kw), replicas=2,
                          routing="least_loaded")
    port = serve_fleet(cfg, params, ServeConfig(**SERVE),
                       bursty_arrivals(1.0, 24, **kw), replicas=2,
                       routing="least_loaded", device="cpu")
    return ref, port


# --------------------------------------------------------------------------- #
# routers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ROUTING_POLICIES)
@pytest.mark.parametrize("faults", ["none", "crash", "degraded"])
def test_router_decisions_match_the_reference(policy, faults):
    """Over 60 arrivals with shifting loads, every decision equals the
    reference router's, with no health object or under a crash or a
    degraded window."""
    rng = np.random.default_rng(4)
    port, ref = make_router(policy, 3), ref_router(policy, 3)
    health = ref_health = None
    if faults != "none":
        health, ref_health = FleetHealth(3), RefHealth(3)
        kind = dict(crash=("node_crash", None),
                    degraded=("pim_degraded", 9))[faults]
        health.begin(FaultEvent(kind[0], 1, 0, until=kind[1]))
        ref_health.begin(RefFaultEvent(kind[0], 1, 0, until=kind[1]))
    got, want = [], []
    for _ in range(60):
        prompt = rng.integers(0, 97, int(rng.integers(1, 20)), np.int32)
        loads = [_Load(*map(int, rng.integers(0, 4, 2))) for _ in range(3)]
        got.append(port.route(prompt, loads, health=health))
        want.append(ref.route(prompt, loads, health=ref_health))
    assert got == want
    if faults == "crash":
        assert 1 not in got


# --------------------------------------------------------------------------- #
# the fleet against the reference's
# --------------------------------------------------------------------------- #
def test_tokens_and_routing_match_the_reference(fleets):
    ref, port = fleets
    assert port.assignments == ref.assignments
    assert port.tokens_by_gid() == ref.tokens_by_gid()
    assert port.served == ref.served
    for n in port.engines:
        assert port.engines[n].dispatch_counts \
            == ref.engines[n].dispatch_counts
        assert port.engines[n].host_syncs == ref.engines[n].host_syncs


@pytest.mark.parametrize("node", [0, 1])
def test_node_traces_equal_the_reference_and_lint_clean(fleets, node):
    """Each node's trace (schema v6 header with its node id and the
    fleet) equals the reference node's, and the reference's protocol lint
    and the port's find nothing in it."""
    ref, port = fleets
    got = port.traces[node]
    assert got.header["node_id"] == node
    assert got.header["fleet"] == {"replicas": 2, "routing": "least_loaded"}
    assert got.dumps() == ref.traces[node].dumps()
    assert lint_trace(RefTrace.loads(got.dumps())) == []
    assert verify.lint_trace(got) == []


def test_fleet_metrics_equal_the_reference(fleets):
    """Live merged hubs, and the offline path from the traces, give the
    reference's fleet summary."""
    ref, port = fleets
    fm = FleetMetrics()
    for n, hub in port.hubs.items():
        fm.add(n, hub)
    want = RefFleetMetrics.from_traces(
        {n: RefTrace.loads(t.dumps()) for n, t in port.traces.items()})
    assert json.dumps(fm.summary()) == json.dumps(want.summary())
    assert json.dumps(FleetMetrics.from_traces(port.traces).to_dict()) \
        == json.dumps(want.to_dict())


def test_fleet_timeline_covers_every_node(fleets):
    ref, port = fleets
    events = fleet_events(port.traces)
    assert json.dumps(events) == json.dumps(ref_fleet_events(
        {n: RefTrace.loads(t.dumps()) for n, t in port.traces.items()}))
    for n, trace in port.traces.items():
        assert check_coverage(trace, events,
                              pid=fleet_node_pids(n)[0]) == []


# --------------------------------------------------------------------------- #
# the guarded fleet workload
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("routing", ROUTING_POLICIES)
def test_port_reproduces_the_fleet_baseline(routing):
    """``fleet_replay.py``'s bursty stream through 2 replicas: requests,
    tokens, TTFT / TPOT / queue-wait summaries and the imbalance equal the
    committed baseline under each routing policy."""
    base = json.loads((DATA / "fleet_baseline.json").read_text())
    w = base["workload"]
    cfg = get_arch("llama3.2-1b").reduced()
    params = init_params(T.param_defs(cfg), device="cpu", seed=0)
    serve = {k: tuple(v) if isinstance(v, list) else v
             for k, v in w["serve"].items()}
    arrivals = bursty_arrivals(w["rate"], w["horizon"], vocab=cfg.vocab_size,
                               burst=w["burst"], idle=w["idle"],
                               prompt_len=tuple(w["prompt_len"]),
                               max_new=tuple(w["max_new"]), seed=w["seed"])
    fleet = serve_fleet(cfg, params, ServeConfig(**serve), arrivals,
                        replicas=w["replicas"], routing=routing,
                        device="cpu")
    fm = FleetMetrics()
    for n, hub in fleet.hubs.items():
        fm.add(n, hub)
    s = json.loads(json.dumps(fm.summary()))
    want = base["policies"][routing]
    assert s["requests"]["arrived"] == want["requests"]
    assert s["requests"]["tokens_generated"] == want["tokens"]
    for key in ("ttft_ticks", "tpot_ticks", "queue_wait_ticks",
                "imbalance"):
        assert s[key] == want[key], key


def test_fleet_launcher_runs_on_the_cpu(tmp_path, capsys):
    """``launch.fleet --device cpu`` with metrics, timeline and per-node
    traces; its timeline passes the coverage check (exit code 0)."""
    metrics, timeline = tmp_path / "m.json", tmp_path / "t.json"
    rc = launch_fleet.main([
        "--device", "cpu", "--replicas", "2", "--routing", "round_robin",
        "--horizon", "12", "--metrics-out", str(metrics),
        "--timeline-out", str(timeline), "--traces-out",
        str(tmp_path / "traces")])
    assert rc == 0
    report = json.loads(metrics.read_text())
    assert report["fleet"]["replicas"] == 2
    assert report["fleet"]["requests"]["arrived"] \
        == report["fleet"]["ttft_ticks"]["count"] > 0
    assert json.loads(timeline.read_text())["traceEvents"]
    for n in range(2):
        tr = RefTrace.load(tmp_path / "traces" / f"node{n}.jsonl")
        assert lint_trace(tr) == []
        assert verify.lint_trace(
            Trace.load(tmp_path / "traces" / f"node{n}.jsonl")) == []
    assert launch_fleet.main(["--device", "cpu", "--routing", "nope"]) == 1
    assert "COVERAGE FAIL" not in capsys.readouterr().out
