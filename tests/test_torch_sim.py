"""Port parity for the IANUS simulator side, on the CPU: ``repro_torch``'s
``core`` (the cost model, PAS, the unified memory system), ``sim`` (the
engine, the paper models' command graphs, the A100 / DFX baselines,
multi-device scaling) and ``FaultPlan.from_cost_model`` on the port's own
``SimResult``, each against the reference's on the same inputs.

Everything here is pure Python: results compare exactly (commands and
decisions through their dict forms, simulator results through
``to_dict``). The properties of the reference's ``test_pas.py``,
``test_sim.py`` and ``test_unified_memory.py`` are held on the port too,
over inputs drawn from a numpy seed instead of hypothesis."""
import dataclasses

import numpy as np
import pytest

import repro.core as ref_core
import repro.sim as ref_sim
import repro.trace as ref_trace
import repro.verify as ref_verify
from repro.chaos import FaultPlan as RefFaultPlan
from repro.configs import paper_models as ref_pm
from repro.core import cost_model as ref_cm
from repro.core import pas as ref_pas
from repro.core import unified_memory as ref_um
from repro.sim import baselines as ref_baselines
from repro.sim import graphs as ref_graphs
from repro.sim import scaling as ref_scaling
import repro_torch.core as core
import repro_torch.sim as sim_pkg
import repro_torch.trace as trace_pkg
import repro_torch.verify as verify_pkg
from repro_torch.chaos import FaultPlan
from repro_torch.configs import paper_models as pm
from repro_torch.core import (DMA, IANUS_HW, MU, NPU_MEM_HW, PIM, TPU_V5E,
                              VU, Command, FCConfig, PASPolicy)
from repro_torch.core import cost_model as cm
from repro_torch.core import pas
from repro_torch.core import unified_memory as um
from repro_torch.sim import SimConfig, Simulator, baselines, graphs, scaling

MACHINES = ("IANUS_HW", "NPU_MEM_HW", "TPU_V5E")
PAPER = ("GPT2_M", "GPT2_L", "GPT2_XL", "GPT2_2p5B")


def _draws(n, seed, lo=64, hi=8192):
    """``n`` (tokens, d_in, d_out) triples, dims multiples of 64."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 1025)),
             int(rng.integers(lo, hi + 1)) // 64 * 64,
             int(rng.integers(lo, hi + 1)) // 64 * 64) for _ in range(n)]


def _cmds(c):
    """Commands of either package as dicts."""
    return [pas.command_to_dict(x) if isinstance(x, Command)
            else ref_pas.command_to_dict(x) for x in c]


def _same(a, b) -> bool:
    """Equal, NaN included (NPU-MEM's PIM has no throughput)."""
    return repr(a) == repr(b)


def _sims(**kw):
    kw.setdefault("issue_overhead", 0.1e-6)
    hw = kw.pop("hw", "IANUS_HW")
    return (Simulator(SimConfig(hw=getattr(cm, hw), **kw)),
            ref_sim.Simulator(ref_sim.SimConfig(hw=getattr(ref_cm, hw),
                                                **kw)))


# --------------------------------------------------------------------------- #
# exports
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("port,ref", [
    (core, ref_core), (sim_pkg, ref_sim), (trace_pkg, ref_trace),
    (verify_pkg, ref_verify)], ids=["core", "sim", "trace", "verify"])
def test_packages_export_the_references_names(port, ref):
    assert set(port.__all__) == set(ref.__all__)
    for name in port.__all__:
        assert hasattr(port, name), name


# --------------------------------------------------------------------------- #
# the cost model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", MACHINES)
def test_machines_and_constants_match_the_reference(name):
    got, want = getattr(cm, name), getattr(ref_cm, name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (cm.TPU_ICI_BW, cm.TPU_HBM_GB) == (ref_cm.TPU_ICI_BW,
                                              ref_cm.TPU_HBM_GB)
    for cores, chips in ((1, 1), (2, 4), (8, 2), (4, 16)):
        assert dataclasses.asdict(got.scaled(cores=cores, pim_chips=chips)) \
            == dataclasses.asdict(want.scaled(cores=cores, pim_chips=chips))


@pytest.mark.parametrize("name", MACHINES)
def test_time_functions_match_the_reference(name):
    hw, rhw = getattr(cm, name), getattr(ref_cm, name)
    for n, d_in, d_out in _draws(40, 1):
        fc, rfc = FCConfig(d_in, d_out), ref_cm.FCConfig(d_in, d_out)
        for fn in ("dma_weight_time", "pipelined_mu_time", "pim_fc_time",
                   "mu_fc_time"):
            args = (hw, n, fc) if fn != "dma_weight_time" else (hw, fc)
            rargs = (rhw, n, rfc) if fn != "dma_weight_time" else (rhw, rfc)
            assert getattr(cm, fn)(*args) == getattr(ref_cm, fn)(*rargs), fn
        assert cm.pim_gemv_time(hw, fc) == ref_cm.pim_gemv_time(rhw, rfc)
        assert cm.pim_row_efficiency(hw, d_in) \
            == ref_cm.pim_row_efficiency(rhw, d_in)
        assert cm.vu_time(hw, n, d_out, 2.0) == ref_cm.vu_time(rhw, n, d_out,
                                                                2.0)
        assert cm.attention_gemv_efficiency(hw, d_in // 64) \
            == ref_cm.attention_gemv_efficiency(rhw, d_in // 64)
        r = cm.roofline(n * 1e9, d_in * 1e6, d_out * 1e3, 4, hw)
        rr = ref_cm.roofline(n * 1e9, d_in * 1e6, d_out * 1e3, 4, rhw)
        assert dataclasses.astuple(r) == dataclasses.astuple(rr)
        assert (r.dominant, r.bound_s) == (rr.dominant, rr.bound_s)


def test_pim_time_linear_and_mu_plateau():
    """Algorithm 1 line 12: PIM time is n x one GEMV; the matrix engine
    takes 128 tokens a pass (the Fig. 12 plateau)."""
    for n, d_in, d_out in _draws(30, 2):
        fc = FCConfig(d_in, d_out)
        t1 = cm.pim_fc_time(IANUS_HW, 1, fc)
        assert abs(cm.pim_fc_time(IANUS_HW, n, fc) - n * t1) \
            < 1e-12 * max(1.0, n)
        t = {k: cm.mu_fc_time(IANUS_HW, k, fc) for k in (1, 4, 16, 128, 129)}
        assert t[1] == t[4] == t[16] == t[128] < t[129]
        t2 = cm.pim_gemv_time(IANUS_HW, FCConfig(d_in, 2 * d_out))
        assert t2 >= cm.pim_gemv_time(IANUS_HW, fc)


# --------------------------------------------------------------------------- #
# PAS: Algorithm 1, MHA mapping, stream composition, serialization
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["IANUS_HW", "NPU_MEM_HW"])
def test_adaptive_map_matches_the_reference(name):
    hw, rhw = getattr(cm, name), getattr(ref_cm, name)
    for n, d_in, d_out in _draws(40, 3):
        cmds = [Command("fc", MU, "fc", n_tokens=n, fc=FCConfig(d_in, d_out))]
        rcmds = [ref_pas.Command("fc", ref_pas.MU, "fc", n_tokens=n,
                                 fc=ref_cm.FCConfig(d_in, d_out))]
        out, dec = pas.adaptive_map(cmds, n, hw)
        rout, rdec = ref_pas.adaptive_map(rcmds, n, rhw)
        assert _cmds(out) == _cmds(rout)
        assert [pas.decision_to_dict(d) for d in dec] \
            == [ref_pas.decision_to_dict(d) for d in rdec]
        d = dec[0]
        assert d.chosen == (PIM if d.pim_time < d.mu_time else MU)
        assert out[0].unit == d.chosen
        if name == "NPU_MEM_HW":
            assert out[0].unit == MU


def test_adaptive_voids_the_weight_load_and_folds_the_gelu():
    fc = FCConfig(1024, 4096)
    cmds = [Command("ffn1.w0", DMA, "dma_load", bytes=fc.weight_elems * 2),
            Command("ffn1.0", MU, "fc", n_tokens=1, fc=fc, deps=(0,)),
            Command("act_gelu", VU, "vec", n_tokens=1, dim=4096, deps=(1,))]
    out, decisions = pas.adaptive_map(cmds, 1, IANUS_HW)
    assert decisions[0].chosen == PIM and out[1].unit == PIM
    assert out[0].bytes == 0 and out[0].kind == "noop_load"
    assert out[2].unit == PIM and out[2].fused_act
    rfc = ref_cm.FCConfig(1024, 4096)
    rout, _ = ref_pas.adaptive_map(
        [ref_pas.Command("ffn1.w0", "DMA", "dma_load",
                         bytes=rfc.weight_elems * 2),
         ref_pas.Command("ffn1.0", "MU", "fc", n_tokens=1, fc=rfc, deps=(0,)),
         ref_pas.Command("act_gelu", "VU", "vec", n_tokens=1, dim=4096,
                         deps=(1,))], 1, ref_cm.IANUS_HW)
    assert _cmds(out) == _cmds(rout)


def test_vu_prefetch_credit_lowers_the_mu_estimate():
    fc = FCConfig(2048, 2048)
    base = [Command("fc.0", MU, "fc", n_tokens=16, fc=fc)]
    with_vu = [Command("ln", VU, "vec", n_tokens=16, dim=1 << 22,
                       vu_passes=2.0), base[0]]
    _, d0 = pas.adaptive_map(base, 16, IANUS_HW)
    _, d1 = pas.adaptive_map(with_vu, 16, IANUS_HW)
    assert d1[0].mu_time <= d0[0].mu_time
    assert pas.estimate_fc_mu_time(IANUS_HW, 16, fc, 1e-6) \
        == ref_pas.estimate_fc_mu_time(ref_cm.IANUS_HW, 16,
                                       ref_cm.FCConfig(2048, 2048), 1e-6)


@pytest.mark.parametrize("head_dim,kv_len", [(64, 512), (128, 96),
                                             (64, 4096), (256, 32)])
def test_qk_sv_decision_matches_the_reference(head_dim, kv_len):
    got = pas.decide_qk_sv_unit(IANUS_HW, head_dim, kv_len, 24)
    assert got == ref_pas.decide_qk_sv_unit(ref_cm.IANUS_HW, head_dim,
                                            kv_len, 24)
    if (head_dim, kv_len) == (64, 512):       # paper Fig. 7c, §5.3
        assert got["unit"] == MU and got["pim_efficiency"] == 0.0625


def test_routes_and_policies_match_the_reference():
    assert cm.pim_row_efficiency(IANUS_HW, 1280) == pytest.approx(0.625)
    assert pas.route_fc_tpu(512, 4096, 16384) == "gemm"
    assert pas.route_fc_tpu(1, 2048, 8192) == "gemv"
    for n, d_in, d_out in _draws(40, 4):
        assert pas.route_fc_tpu(n, d_in, d_out, TPU_V5E) \
            == ref_pas.route_fc_tpu(n, d_in, d_out, ref_cm.TPU_V5E)
    for pol, ref in ((PASPolicy.paper(), ref_pas.PASPolicy.paper()),
                     (PASPolicy.naive(), ref_pas.PASPolicy.naive()),
                     (PASPolicy(), ref_pas.PASPolicy())):
        assert dataclasses.asdict(pol) == dataclasses.asdict(ref)


def _stage(mod_graphs, mod_pm, cfg_name, n, kv, stage, policy):
    return mod_graphs.build_stage(getattr(mod_pm, cfg_name), n, kv, stage,
                                  policy)


@pytest.mark.parametrize("cfg_name", PAPER)
@pytest.mark.parametrize("stage,n,kv", [("summarization", 128, 128),
                                        ("generation", 1, 192),
                                        ("generation", 1, 513)])
def test_stage_graphs_match_the_reference(cfg_name, stage, n, kv):
    for pol, rpol in ((PASPolicy.paper(), ref_pas.PASPolicy.paper()),
                      (PASPolicy.naive(), ref_pas.PASPolicy.naive())):
        got = _stage(graphs, pm, cfg_name, n, kv, stage, pol)
        want = _stage(ref_graphs, ref_pm, cfg_name, n, kv, stage, rpol)
        assert _cmds(got) == _cmds(want)


@pytest.mark.parametrize("mode,issue", [("parallel", "shared"),
                                        ("parallel", "chained"),
                                        ("pipelined", "shared")])
def test_merge_streams_matches_the_reference(mode, issue):
    streams = [graphs.build_stage(pm.GPT2_M, 1, kv, "generation",
                                  PASPolicy.paper()) for kv in (64, 96, 128)]
    rstreams = [ref_graphs.build_stage(ref_pm.GPT2_M, 1, kv, "generation",
                                       ref_pas.PASPolicy.paper())
                for kv in (64, 96, 128)]
    got = pas.merge_streams(streams, mode=mode, issue_mode=issue)
    assert _cmds(got) == _cmds(ref_pas.merge_streams(rstreams, mode=mode,
                                                     issue_mode=issue))
    lowered, dec = pas.lower_commands(streams[0], 1)
    rlowered, rdec = ref_pas.lower_commands(rstreams[0], 1)
    assert _cmds(lowered) == _cmds(rlowered)
    assert [pas.decision_to_dict(d) for d in dec] \
        == [ref_pas.decision_to_dict(d) for d in rdec]
    assert pas.lower_commands(streams[0], 1, adaptive=False)[1] == []


def test_serializers_round_trip_and_match_the_reference():
    cmds = graphs.build_stage(pm.GPT2_L, 4, 64, "summarization",
                              PASPolicy.paper())
    ds = [pas.command_to_dict(c) for c in cmds]
    assert pas.commands_from_dicts(ds) == cmds
    assert [ref_pas.command_to_dict(c)
            for c in ref_pas.commands_from_dicts(ds)] == ds
    d = pas.MappingDecision(3, "ffn1.0", 1e-5, 2e-5, MU)
    assert pas.decision_from_dict(pas.decision_to_dict(d)) == d
    bad = dict(ds[1], deps=[5])
    with pytest.raises(ValueError, match="dep"):
        pas.command_from_dict(bad, index=1)
    with pytest.raises(ValueError, match="unknown execution unit"):
        Command("x", "GPU", "fc")
    with pytest.raises(ValueError, match="unknown unit"):
        Command("x", MU, "fc").retarget("NPU2")


# --------------------------------------------------------------------------- #
# the unified memory system
# --------------------------------------------------------------------------- #
def test_address_map_matches_the_reference():
    amap, ramap = um.AddressMap(), ref_um.AddressMap()
    assert dataclasses.asdict(amap) == dataclasses.asdict(ramap)
    rng = np.random.default_rng(5)
    for _ in range(300):
        row = int(rng.integers(amap.n_rows))
        ch = int(rng.integers(amap.n_channels))
        bank = int(rng.integers(amap.n_banks))
        col = int(rng.integers(amap.row_bytes))
        addr = amap.encode(row, ch, bank, col)
        assert addr == ramap.encode(row, ch, bank, col)
        assert amap.decode(addr) == (row, ch, bank, col)
        assert 0 <= addr < amap.capacity_bytes
        a = int(rng.integers(amap.capacity_bytes))
        assert amap.encode(*amap.decode(a)) == a
        assert amap.decode(a) == ramap.decode(a)


def test_weight_tiler_matches_the_reference():
    """Fig. 4: every weight row of a tile lands on one DRAM row across
    distinct (channel, bank) pairs; distinct elements, distinct addresses;
    GPT-2 L's d 1280 activates twice M's rows."""
    tiler, rtiler = um.WeightTiler(um.AddressMap()), \
        ref_um.WeightTiler(ref_um.AddressMap())
    rng = np.random.default_rng(6)
    for _ in range(25):
        w_rows, w_cols = (int(x) for x in rng.integers(1, 4097, 2))
        assert tiler.tile_grid(w_rows, w_cols) \
            == rtiler.tile_grid(w_rows, w_cols)
        assert tiler.rows_activated(w_rows, w_cols) \
            == rtiler.rows_activated(w_rows, w_cols)
        c = int(rng.integers(min(tiler.tile.cols, w_cols)))
        seen, rows = set(), set()
        for r in range(min(tiler.tile.rows, w_rows)):
            addr = tiler.element_address(w_rows, w_cols, r, c)
            assert addr == rtiler.element_address(w_rows, w_cols, r, c)
            row, ch, bank, _ = tiler.amap.decode(addr)
            assert (ch, bank) not in seen
            seen.add((ch, bank))
            rows.add(row)
        assert len(rows) == 1
        pts = {(int(rng.integers(w_rows)), int(rng.integers(w_cols)))
               for _ in range(32)}
        assert len({tiler.element_address(w_rows, w_cols, r, c)
                    for r, c in pts}) == len(pts)
    assert tiler.rows_activated(1024, 1280) \
        == 2 * tiler.rows_activated(1024, 1024)


@pytest.mark.parametrize("cfg_name", PAPER)
def test_memory_plans_match_the_reference(cfg_name):
    cfg, rcfg = getattr(pm, cfg_name), getattr(ref_pm, cfg_name)
    cap = 8 << 30
    assert um.shared_fraction(cfg) == ref_um.shared_fraction(rcfg)
    u, p = um.unified_plan(cfg, cap), um.partitioned_plan(cfg, cap)
    assert dataclasses.asdict(u) == dataclasses.asdict(
        ref_um.unified_plan(rcfg, cap))
    assert dataclasses.asdict(p) == dataclasses.asdict(
        ref_um.partitioned_plan(rcfg, cap))
    assert (u.pim_throughput_factor, p.pim_throughput_factor) == (1.0, 0.5)
    if cfg_name == "GPT2_XL":
        assert 0.85 <= um.shared_fraction(cfg) <= 0.97    # paper: ~91 %
    if cfg_name == "GPT2_2p5B":
        assert p.transfer_bytes_per_step > 0              # Fig. 13
    else:
        assert u.fits and p.footprint > 1.7 * u.footprint \
            * um.shared_fraction(cfg)


# --------------------------------------------------------------------------- #
# the simulator
# --------------------------------------------------------------------------- #
def _dag(rng, mods):
    """A random command DAG of 3-25 commands, built in both packages."""
    out = {m: [] for m in mods}
    n = int(rng.integers(3, 26))
    for i in range(n):
        unit = ("MU", "VU", "PIM", "DMA")[int(rng.integers(4))]
        k = int(rng.integers(0, 4)) if i else 0
        deps = tuple(sorted({int(x) for x in rng.integers(0, i, k)})) \
            if i else ()
        core_ = int(rng.integers(4))
        if unit in ("MU", "PIM"):
            kw = dict(kind="fc", n_tokens=int(rng.integers(1, 9)))
            sizes = (256, 256)
        elif unit == "VU":
            kw, sizes = dict(kind="vec", n_tokens=1,
                             dim=int(rng.integers(64, 4097))), None
        else:
            kw, sizes = dict(kind="dma_load",
                             bytes=int(rng.integers(0, 1 << 20))), None
        for m, (C, F) in mods.items():
            fc = F(*sizes) if sizes else None
            out[m].append(C(f"c{i}", unit, deps=deps, core=core_, fc=fc,
                            **kw))
    return out


def _dags(n, seed):
    rng = np.random.default_rng(seed)
    mods = {"port": (Command, FCConfig),
            "ref": (ref_pas.Command, ref_cm.FCConfig)}
    return [_dag(rng, mods) for _ in range(n)]


@pytest.mark.parametrize("kw", [dict(), dict(scheduled=False),
                                dict(unified=False), dict(hw="NPU_MEM_HW")],
                         ids=["pas", "naive", "partitioned", "npu-mem"])
def test_simulator_matches_the_reference_on_random_dags(kw):
    s, rs = _sims(trace=True, **kw)
    for d in _dags(30, 7):
        got, want = s.run(d["port"]), rs.run(d["ref"])
        assert _same(got.to_dict(), want.to_dict())
        assert _same(got.trace, want.trace)
        assert _same(got.exposed_tag_time(), want.exposed_tag_time())


def test_simulator_invariants():
    """Dependencies respected, makespan between the longest command and
    the serial sum, no PIM burst overlapping an off-chip DMA under unified
    memory, naive never faster than PAS."""
    s, _ = _sims(trace=True)
    naive, _ = _sims(scheduled=False)
    for d in _dags(30, 8):
        cmds = d["port"]
        res = s.run(cmds)
        span = {name: (a, b) for a, b, _u, name, _t in res.trace}
        for i, c in enumerate(cmds):
            for j in c.deps:
                assert span[f"c{i}"][0] >= span[f"c{j}"][1] - 1e-12
        serial = sum(s.duration(c) for c in cmds)
        assert max(s.duration(c) for c in cmds) - 1e-12 <= res.makespan \
            <= serial + 1e-9
        pim = [(a, b) for a, b, u, _n, _t in res.trace if u == "PIM" and b > a]
        dma = [(a, b) for a, b, u, _n, _t in res.trace
               if u.startswith("DMA") and b > a]
        for ps, pe in pim:
            for ds, de in dma:
                assert de <= ps + 1e-12 or ds >= pe - 1e-12
        assert naive.run(cmds).makespan >= res.makespan - 1e-9


def test_partitioned_memory_overlaps_but_halves_pim():
    cmds = [Command("pim", PIM, "fc", n_tokens=1, fc=FCConfig(4096, 4096)),
            Command("dma", DMA, "dma_load", bytes=1 << 24)]
    uni, _ = _sims(unified=True, trace=True)
    part, _ = _sims(unified=False, trace=True)
    u, p = uni.run(cmds), part.run(cmds)
    (ps, pe, *_), (ds, de, *_) = p.trace
    assert max(ps, ds) < min(pe, de)
    assert p.unit_busy["PIM"] > 1.9 * u.unit_busy["PIM"]


def test_merge_results_and_streams_match_the_reference():
    s, rs = _sims(trace=True)
    ds = _dags(4, 9)
    parts = [s.run(d["port"]) for d in ds]
    rparts = [rs.run(d["ref"]) for d in ds]
    merged = sim_pkg.merge_results(parts)
    want = ref_sim.merge_results(rparts)
    assert merged.to_dict() == want.to_dict() and merged.trace == want.trace
    assert merged.makespan == pytest.approx(sum(p.makespan for p in parts))
    got = s.run_streams([d["port"] for d in ds])
    assert got.to_dict() == rs.run_streams([d["ref"] for d in ds]).to_dict()


@pytest.mark.parametrize("cfg_name", PAPER)
def test_paper_anchors_match_the_reference(cfg_name):
    """Generation steps of each paper model on IANUS (PAS and naive) and
    NPU-MEM, and gpt2-m's end-to-end latency, equal the reference's;
    gpt2-xl's step and its NPU-MEM ratio sit at the paper's 3.8 ms and
    4.0x."""
    cfg, rcfg = getattr(pm, cfg_name), getattr(ref_pm, cfg_name)
    for kw in (dict(), dict(hw="NPU_MEM_HW"), dict(scheduled=False)):
        s, rs = _sims(**kw)
        pol, rpol = (PASPolicy.naive(), ref_pas.PASPolicy.naive()) \
            if kw.get("scheduled") is False else \
            (PASPolicy.paper(), ref_pas.PASPolicy.paper())
        got = graphs.generation_step_latency(s, cfg, 192, pol)
        want = ref_graphs.generation_step_latency(rs, rcfg, 192, rpol)
        assert got.to_dict() == want.to_dict()
        if cfg_name == "GPT2_M":        # fig08-fig15 cover the rest
            e2e = graphs.e2e_latency(s, cfg, 128, 8, pol)
            assert e2e == ref_graphs.e2e_latency(rs, rcfg, 128, 8, rpol)
            assert e2e["total"] == pytest.approx(
                e2e["summarization"] + e2e["generation"], rel=1e-9)
    if cfg_name == "GPT2_XL":
        s, _ = _sims()
        n, _ = _sims(hw="NPU_MEM_HW")
        r = graphs.generation_step_latency(s, cfg, 192, PASPolicy.paper())
        rn = graphs.generation_step_latency(n, cfg, 192, PASPolicy.paper())
        assert 3.2 <= r.makespan * 1e3 <= 4.8
        assert 3.3 <= rn.makespan / r.makespan <= 4.7


@pytest.mark.parametrize("cfg_name", PAPER)
def test_baselines_and_scaling_match_the_reference(cfg_name):
    cfg, rcfg = getattr(pm, cfg_name), getattr(ref_pm, cfg_name)
    for n_in, n_out in ((128, 1), (256, 64), (512, 512)):
        assert baselines.A100.e2e(cfg, n_in, n_out) \
            == ref_baselines.A100.e2e(rcfg, n_in, n_out)
        assert baselines.DFX.e2e(cfg, n_in, n_out) \
            == ref_baselines.DFX.e2e(rcfg, n_in, n_out)
    for n_dev in (1, 2, 4):
        assert scaling.multi_device_e2e(cfg, 128, 8, n_dev) \
            == ref_scaling.multi_device_e2e(rcfg, 128, 8, n_dev)
    assert dataclasses.asdict(scaling.device_slice(IANUS_HW, 4)) \
        == dataclasses.asdict(ref_scaling.device_slice(ref_cm.IANUS_HW, 4))


# --------------------------------------------------------------------------- #
# fault plans from the port's own simulator
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("hw", ["IANUS_HW", "NPU_MEM_HW"])
def test_fault_plan_from_the_ports_sim_result(hw):
    """``FaultPlan.from_cost_model`` on the port's ``SimResult`` (and its
    ``to_dict()``) gives the reference's plan from the reference's."""
    s, rs = _sims(hw=hw)
    got = graphs.generation_step_latency(s, pm.GPT2_XL, 192,
                                         PASPolicy.paper())
    want = ref_graphs.generation_step_latency(rs, ref_pm.GPT2_XL, 192,
                                              ref_pas.PASPolicy.paper())
    for seed in (0, 5):
        for kw in (dict(), dict(pim_refresh_threshold=0.1,
                                thermal_threshold=1e-3)):
            plan = FaultPlan.from_cost_model(got, seed, replicas=3,
                                             horizon=32, **kw).to_dict()
            assert plan == RefFaultPlan.from_cost_model(
                want, seed, replicas=3, horizon=32, **kw).to_dict()
            assert plan == FaultPlan.from_cost_model(
                got.to_dict(), seed, replicas=3, horizon=32, **kw).to_dict()
