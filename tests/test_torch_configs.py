"""Port parity for the configuration registry and the families it adds, on
the CPU: every ``dense`` and ``moe`` configuration of the reference (the
assigned ones and the paper's GPT-2, BERT and GPT models) field for field,
and the engine of each distinct ``.reduced()`` stack against the reference
engine in float32.

``.reduced()`` makes gpt2-m/l/xl/2.5b and the BERTs the same stack but for
the name, so the engine runs one of them (gpt2-xl: layernorm with bias,
tanh-gelu non-gated MLP, tied embeddings, MHA) beside olmo-1b
(non-parametric layernorm, tied), granite-20b (layernorm, gelu, MQA),
phi3-medium-14b (GQA, SwiGLU) and the two MoE stacks, qwen3-moe-30b-a3b
and kimi-k2-1t-a32b (4 experts, top-2, every layer). Weights are drawn
from a numpy seed, so that they are the same in every process, with the
layernorms' zero-initialized biases drawn too, so that they count.

Greedy tokens, dispatch counts, host syncs and trace events are exact
(the argmax of logits that agree within 1e-4 picks the same token on
these seeds); logits and the MoE aux loss agree within 1e-4 (f32: the
frameworks sum in another order). A MoE chunk routes all its B x C tokens
as one group, idle rows included, so a prompt's tokens depend on its
wave-mates in both packages (ROADMAP §3)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_arch
from repro.models import moe as JM
from repro.models import transformer as RT
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import ServeEngine as JaxServeEngine
from repro.trace import TraceRecorder
from repro.trace import arrivals as jax_arrivals
from repro.verify import lint_trace
from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.steps import step_fn_for
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.trace import arrivals

TOL = dict(rtol=1e-4, atol=1e-4)
SERVED = ("dense", "moe")
# the distinct stacks that .reduced() gives
DISTINCT = ("olmo-1b", "granite-20b", "phi3-medium-14b", "gpt2-xl",
            "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
MOE = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
# leaves the reference initializes to zero, drawn here so that they count
DRAWN = {"bias": 0.1}


def _cfgs(name, **kw):
    ref = dataclasses.replace(jax_arch(name).reduced(), dtype="float32", **kw)
    port = dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                               **kw)
    return ref, port


def _np_leaf(name, pd, rng):
    if name in DRAWN:
        return (rng.standard_normal(pd.shape) * DRAWN[name]
                ).astype(np.float32)
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


_PARAMS = {}


def _params(name):
    """float32 weights of ``name``'s reduced stack from a numpy seed, as a
    JAX tree and the port's tree (cached: each is drawn once a process)."""
    if name not in _PARAMS:
        ref, _ = _cfgs(name)
        rng = np.random.default_rng(0)
        leaves, treedef = jax.tree_util.tree_flatten_with_path(
            RT.param_defs(ref), is_leaf=lambda x: hasattr(x, "fan_in"))
        p = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(_np_leaf(getattr(path[-1], "key", None), pd, rng))
            for path, pd in leaves])
        _PARAMS[name] = p, from_jax_tree(jax.tree.map(np.asarray, p))
    return _PARAMS[name]


# --------------------------------------------------------------------------- #
# the registry
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(
    n for n, c in JAX_ARCHS.items() if c.family in SERVED))
def test_config_equals_the_reference_field_for_field(name):
    assert dataclasses.asdict(get_arch(name)) == \
        dataclasses.asdict(jax_arch(name))


def test_registry_holds_every_served_family_of_the_reference():
    """Every reference arch of the families the port serves, and no
    other; the paper's 11 models among them."""
    from repro.configs import paper_models as jax_paper
    from repro_torch.configs import paper_models
    want = {n for n, c in JAX_ARCHS.items()
            if c.family in SERVED + ("ssm", "hybrid")}
    assert set(ARCHS) == want
    for group in ("PAPER_GPT2", "PAPER_BERT", "PAPER_LARGE", "PAPER_MODELS"):
        assert getattr(paper_models, group).keys() == \
            getattr(jax_paper, group).keys()
    assert len(paper_models.PAPER_MODELS) == 11


# --------------------------------------------------------------------------- #
# the model: MoE through the prefill paths
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("B,C", [(4, 8), (3, 5)])
def test_moe_groups_a_prefill_chunk_as_the_reference(B, C):
    """A prefill chunk's MoE: one group of B x C tokens, the reference's
    ``_num_groups(B, None)`` and ``capacity``; output and aux loss equal
    the reference's on the chunk."""
    ref, cfg = _cfgs("qwen3-moe-30b-a3b")
    G = JM._num_groups(B, None)
    k, E, cf = cfg.experts_per_token, cfg.num_experts, cfg.capacity_factor
    assert G == 1
    assert M.capacity(B * C, k, E, cf) == JM.capacity(B // G * C, k, E, cf)
    p, tp = _params("qwen3-moe-30b-a3b")
    x = (np.random.default_rng(B).standard_normal((B, C, cfg.d_model))
         ).astype(np.float32)
    pj = jax.tree.map(lambda a: a[0], p["blocks"]["pos0"]["ffn"])
    pt = {n: v[0] for n, v in tp["blocks"]["pos0"]["ffn"].items()}
    want, want_aux = JM.apply_moe(ref, pj, jnp.asarray(x))
    got, got_aux = M.apply_moe(cfg, pt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


@pytest.mark.parametrize("name", MOE)
def test_prefill_step_matches_reference(name):
    """The full-sequence prefill step (``launch/steps.py``) of a MoE stack:
    last-position logits and the aux loss of ``forward_full``."""
    ref, cfg = _cfgs(name)
    p, tp = _params(name)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
    want, want_aux = RT.forward_full(ref, p, jnp.asarray(tokens))
    got = step_fn_for(cfg, "prefill", device="cpu")(tp, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, -1], **TOL)
    _, got_aux = T.forward_full(cfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)


# --------------------------------------------------------------------------- #
# the engine against the reference engine
# --------------------------------------------------------------------------- #
def _serve(engine_cls, scfg_cls, cfg, p, prompts, scfg, max_new, **kw):
    rec = TraceRecorder()
    eng = engine_cls(cfg, p, scfg_cls(**scfg), recorder=rec, **kw)
    for pr in prompts:
        eng.add_request(pr, max_new_tokens=max_new)
    return eng.run_until_done(), eng, rec.to_trace()


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
@pytest.mark.parametrize("name", DISTINCT)
def test_engine_matches_reference_engine(name, pack):
    """The same prompts through both engines, traced: batched (or packed)
    prefill and the decode; greedy tokens, counters, prefill stats, PAS log
    and trace events are identical, and the port's trace lints clean."""
    ref, cfg = _cfgs(name)
    p, tp = _params(name)
    scfg = dict(max_slots=3, max_len=48, prefill_chunk=8, pack=pack)
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 12, 1, 9, 3)]
    tj, ej, trj = _serve(JaxServeEngine, JaxServeConfig, ref, p, prompts,
                         scfg, 4)
    tt, et, trt = _serve(ServeEngine, ServeConfig, cfg, tp, prompts, scfg, 4,
                         device="cpu")
    assert et.effective_prefill_mode == "batched"
    assert tt == tj
    assert et.dispatch_counts == ej.dispatch_counts
    assert et.host_syncs == ej.host_syncs
    assert et.prefill_stats == ej.prefill_stats
    assert et.pas_log == ej.pas_log
    assert trt.events == trj.events
    assert trt.summary == trj.summary
    assert lint_trace(trt) == []


def test_moe_wave_mates_change_each_others_tokens():
    """Each batched-prefill chunk routes all its rows as one group, with
    capacity ceil(B C k cf / E) an expert: a wave-mate's tokens (and the
    idle rows' filler) compete for the experts' slots. Prompt A served
    beside B gives other tokens than A alone, in both packages, and the
    port matches the reference in both cases (4 slots, prompts of 13 and
    6 tokens, a capacity factor of 0.5 so that experts overflow in the
    chunk: at the config's 1.25 the reduced stack's experts drop tokens
    too rarely to turn a greedy token)."""
    ref, cfg = _cfgs("qwen3-moe-30b-a3b", capacity_factor=0.5)
    p, tp = _params("qwen3-moe-30b-a3b")
    rng = np.random.default_rng(2)
    lens = rng.integers(3, 16, 2)                   # 13 and 6 tokens
    a, b = (rng.integers(1, cfg.vocab_size, n).astype(np.int32)
            for n in lens)
    scfg = dict(max_slots=4, max_len=32, prefill_chunk=8)
    out = {"jax": {}, "torch": {}}
    for case, prompts in (("alone", [a]), ("beside", [a, b])):
        tj, ej, _ = _serve(JaxServeEngine, JaxServeConfig, ref, p, prompts,
                           scfg, 6)
        tt, et, _ = _serve(ServeEngine, ServeConfig, cfg, tp, prompts, scfg,
                           6, device="cpu")
        assert tt == tj
        assert et.dispatch_counts == ej.dispatch_counts
        out["jax"][case], out["torch"][case] = tj, tt
    for pkg in out.values():
        assert pkg["alone"][0] != pkg["beside"][0]


@pytest.mark.parametrize("pack", [False, True], ids=["unpacked", "packed"])
def test_moe_fused_steps_and_supersteps_match_reference(pack):
    """Requests arriving while others decode, under ``interleaved`` with
    fused steps and supersteps of 4 through the MoE stack: the same tokens,
    dispatches, host syncs, step kinds and trace events as the reference
    engine; fused steps and supersteps both ran."""
    ref, cfg = _cfgs("qwen3-moe-30b-a3b")
    p, tp = _params("qwen3-moe-30b-a3b")
    evs = jax_arrivals.poisson_arrivals(0.5, 24, vocab=cfg.vocab_size,
                                        prompt_len=(2, 40), max_new=(3, 8),
                                        seed=1)
    scfg = dict(max_slots=4, max_len=64, prefill_chunk=8,
                policy="interleaved", fuse=True, superstep=4, pack=pack)
    rec_j, rec_t = TraceRecorder(), TraceRecorder()
    ej = JaxServeEngine(ref, p, JaxServeConfig(**scfg), recorder=rec_j)
    et = ServeEngine(cfg, tp, ServeConfig(**scfg), recorder=rec_t,
                     device="cpu")
    want = jax_arrivals.drive(ej, evs)
    got = arrivals.drive(et, evs)
    assert got == want and len(got) == len(evs)
    assert et.dispatch_counts == ej.dispatch_counts
    assert et.host_syncs == ej.host_syncs
    assert et.scheduler.stats == ej.scheduler.stats
    assert et.superstep_tokens == ej.superstep_tokens
    tj, tt = rec_j.to_trace(), rec_t.to_trace()
    assert tt.events == tj.events
    assert lint_trace(tt) == []
    assert et.scheduler.stats["fused"] > 0
    assert et.scheduler.stats["superstep"] > 0
