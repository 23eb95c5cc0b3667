"""Port parity for decode supersteps and fused overlapped steps, on the CPU,
and the port's own invariants of temperature sampling.

Model level, at llama3.2-1b ``.reduced()`` in float32 (weights from a
numpy seed, carried to both frameworks; caches random, from a seed):
``decode_superstep`` (k 1/2/4, a lane dying mid-span at the max_len-1
cap, a parked lane) and ``fused_step`` with an unpacked or a packed chunk
(two ready slots decoding while two parked slots prefill) give the reference's
fetches exactly and caches within 1e-4 (f32: the frameworks sum in
another order). int8 cells agree within one quantum: both packages
dequantize the cache to bf16 before attention, so the second layer's
quantizer input differs by bf16 roundings of f32 noise, and a cell near a
rounding tie goes the other way.

Temperature sampling cannot follow ``jax.random``'s stream, so it is held
to the port's own invariants: the draw counter stands still on a round
with no live lane, and fused == unfused and superstep 4 == 1 give the same
tokens past early termination at EOS and at the cap."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as RT
from repro.sched import plan_packed_job as jax_plan
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.trace import drive, poisson_arrivals

TOL = dict(rtol=1e-4, atol=1e-4)
KV = [("bf16", "onehot"), ("bf16", "scatter"), ("int8", "onehot")]


def _cfgs(kv_dtype="bf16", kv_update="onehot"):
    kw = dict(dtype="float32", kv_dtype=kv_dtype, kv_update=kv_update)
    return (dataclasses.replace(jax_arch("llama3.2-1b").reduced(), **kw),
            dataclasses.replace(get_arch("llama3.2-1b").reduced(), **kw))


def _np_leaf(pd, rng):
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    """float32 weights from a numpy seed (the same in every process)."""
    ref, _ = _cfgs()
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(
        RT.param_defs(ref), is_leaf=lambda x: hasattr(x, "fan_in"))
    p = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


def _cache_pair(ref, B, L, seed):
    """A random stacked cache of standard normal K/V (quantized per
    position as the model quantizes, for the int8 cache) for both
    frameworks."""
    shape = (ref.num_layers, B, ref.num_kv_heads, L, ref.head_dim)
    rng = np.random.default_rng(seed)
    c = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("k", "v")}
    if ref.kv_dtype == "int8":
        for k in ("k", "v"):
            scale = np.abs(c[k]).max(-1) / np.float32(127)
            c[k] = np.round(c[k] / scale[..., None]).astype(np.int8)
            c[f"{k}_scale"] = scale
    return ({"pos0": {k: jnp.asarray(v) for k, v in c.items()}},
            {"pos0": {k: from_jax_tree(v) for k, v in c.items()}})


def _assert_cache(got, want):
    for key in want["pos0"]:
        g, w = got["pos0"][key].numpy(), np.asarray(want["pos0"][key])
        if g.dtype == np.int8:
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= 1, key
        else:
            np.testing.assert_allclose(g, w, err_msg=key, **TOL)


def _state(arrays):
    """The decode state (last_tok, lens, active, gen_count, max_new) in
    both frameworks."""
    return ([jnp.asarray(a) for a in arrays],
            [from_jax_tree(np.asarray(a)) for a in arrays])


# --------------------------------------------------------------------------- #
# model level against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("kv_dtype,kv_update", KV)
def test_decode_superstep_matches_reference(params, k, kv_dtype, kv_update):
    """Lane 0 reaches the max_len-1 cap at round 2 and freezes, lane 1
    runs on its budget, lane 2 is parked mid-prefill (inactive, cursor at
    max_len-1)."""
    ref, port = _cfgs(kv_dtype, kv_update)
    p, tp = params
    B, L = 3, 16
    cache_j, cache_t = _cache_pair(ref, B, L, seed=1)
    (sj, st) = _state([np.array([3, 7, 0], np.int32),
                       np.array([L - 3, 4, L - 1], np.int32),
                       np.array([True, True, False]),
                       np.zeros(B, np.int32), np.full(B, 8, np.int32)])
    fj, cache_j, *rest_j = RT.decode_superstep(
        ref, p, cache_j, *sj, jax.random.PRNGKey(0), k=k, temperature=0.0,
        eos_token=None, max_len=L)
    ft, cache_t, *rest_t = T.decode_superstep(
        port, tp, cache_t, *st, None, k=k, temperature=0.0, eos_token=None,
        max_len=L)
    assert ft.dtype == torch.int32 and tuple(ft.shape) == (k, 3, B)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    for got, want in zip(rest_t[:3], rest_j[:3]):   # toks, lens, gen_count
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_cache(cache_t, cache_j)
    if k >= 2:
        assert ft[1, 1, 0] == 1 and ft[1, 2, 0] == L - 1   # capped at round 2


def _prefill_chunk_inputs(B, C, offset, rows, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, C)).astype(np.int32)
    valid = np.zeros((B, C), bool)
    for r, n in rows.items():
        valid[r, :n] = True
    return tokens, valid


@pytest.mark.parametrize("kv_dtype,kv_update", KV)
def test_fused_step_matches_reference(params, kv_dtype, kv_update):
    """Slots 0 and 1 decode while slots 2 and 3, parked at max_len-1,
    prefill a chunk at offset 8: the reference's fused step, and the
    port's own unfused pair (decode, then the chunk) bit for bit."""
    ref, port = _cfgs(kv_dtype, kv_update)
    p, tp = params
    B, L, C, off = 4, 32, 8, 8
    cache_j, cache_t = _cache_pair(ref, B, L, seed=2)
    _, cache_u = _cache_pair(ref, B, L, seed=2)
    tokens, valid = _prefill_chunk_inputs(B, C, off, {2: 8, 3: 5}, seed=3)
    sj, st = _state([np.array([5, 9, 0, 0], np.int32),
                     np.array([10, 20, L - 1, L - 1], np.int32),
                     np.array([True, True, False, False]),
                     np.zeros(B, np.int32), np.full(B, 6, np.int32)])
    fj, cache_j, *_ = RT.fused_step(
        ref, p, cache_j, jnp.asarray(tokens), jnp.asarray(valid), *sj,
        jax.random.PRNGKey(0), offset=off, temperature=0.0, eos_token=None,
        max_len=L)
    ft, cache_t, *_ = T.fused_step(
        port, tp, cache_t, lambda c: T.prefill_chunk(
            port, tp, from_jax_tree(tokens), c, from_jax_tree(valid),
            offset=off), *st, None, temperature=0.0, eos_token=None,
        max_len=L)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    _assert_cache(cache_t, cache_j)
    fu, cache_u, *_ = T.decode_and_sample(
        port, tp, cache_u, *st, None, temperature=0.0, eos_token=None,
        max_len=L)
    cache_u = T.prefill_chunk(port, tp, from_jax_tree(tokens), cache_u,
                              from_jax_tree(valid), offset=off)
    assert torch.equal(fu, ft)
    for key, leaf in cache_t["pos0"].items():
        assert torch.equal(leaf, cache_u["pos0"][key]), key


@pytest.mark.parametrize("kv_dtype,kv_update", KV)
def test_fused_step_packed_matches_reference(params, kv_dtype, kv_update):
    """A packed dispatch (the last of a wave of prompts in slots 2 and 3,
    with its prefix span) riding the decode of slots 0 and 1."""
    from types import SimpleNamespace
    ref, port = _cfgs(kv_dtype, kv_update)
    p, tp = params
    B, L, C = 4, 48, 8
    rng = np.random.default_rng(4)
    wave = [(s, SimpleNamespace(rid=s, prompt=rng.integers(0, 256, n)))
            for s, n in ((2, 21), (3, 6))]
    d = jax_plan(wave, max_slots=B, chunk=C, sub_batch=0).dispatches[-1]
    layout = [d.tokens, d.seg_slot, d.seg_pos, d.seg_ids, d.valid,
              d.row_slot, d.prefix_len]
    cache_j, cache_t = _cache_pair(ref, B, L, seed=5)
    sj, st = _state([np.array([5, 9, 0, 0], np.int32),
                     np.array([10, 30, L - 1, L - 1], np.int32),
                     np.array([True, True, False, False]),
                     np.zeros(B, np.int32), np.full(B, 6, np.int32)])
    fj, cache_j, *_ = RT.fused_step_packed(
        ref, p, cache_j, *[jnp.asarray(a) for a in layout], *sj,
        jax.random.PRNGKey(0), prefix_span=d.prefix_span, temperature=0.0,
        eos_token=None, max_len=L)
    tl = [from_jax_tree(np.asarray(a)) for a in layout]
    ft, cache_t, *_ = T.fused_step(
        port, tp, cache_t, lambda c: T.prefill_chunk_packed(
            port, tp, tl[0], c, *tl[1:], prefix_span=d.prefix_span),
        *st, None, temperature=0.0, eos_token=None, max_len=L)
    assert d.prefix_span > 0
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    _assert_cache(cache_t, cache_j)


# --------------------------------------------------------------------------- #
# temperature sampling: the port's own invariants
# --------------------------------------------------------------------------- #
def test_dead_rounds_leave_the_draw_counter(params):
    """The only live lane reaches the cap at round 1 of k=4: the counter
    advances once, as one single step's does, and round 1 samples the
    single step's token."""
    _, port = _cfgs()
    _, tp = params
    B, L = 2, 16
    out = {}
    for k in (1, 4):
        _, cache = _cache_pair(_cfgs()[0], B, L, seed=6)
        _, st = _state([np.array([3, 0], np.int32),
                        np.array([L - 2, 0], np.int32),
                        np.array([True, False]), np.zeros(B, np.int32),
                        np.full(B, 8, np.int32)])
        draw = torch.tensor(5, dtype=torch.int64)
        fetch, *_, draw_k = T.decode_superstep(
            port, tp, cache, *st, draw, k=k, temperature=0.7,
            eos_token=None, max_len=L, seed=11)
        out[k] = (fetch, int(draw_k))
    assert out[1][1] == out[4][1] == 6
    assert torch.equal(out[4][0][0], out[1][0][0])
    assert out[4][0][0, 1, 0] == 1                 # done at round 1


def test_gumbel_noise_is_a_function_of_seed_draw_and_cell():
    a = T.gumbel_noise(3, torch.tensor(7), (4, 256), "cpu")
    assert torch.equal(a, T.gumbel_noise(3, torch.tensor(7), (4, 256), "cpu"))
    for other in (T.gumbel_noise(4, torch.tensor(7), (4, 256), "cpu"),
                  T.gumbel_noise(3, torch.tensor(8), (4, 256), "cpu")):
        assert (a != other).float().mean() > 0.99
    assert torch.isfinite(a).all()
    # Gumbel(0, 1): mean 0.5772, standard deviation 1.2825
    assert abs(float(a.mean()) - 0.5772) < 0.1
    assert abs(float(a.std()) - 1.2825) < 0.1


def _serve(port, tp, arrivals, **kw):
    eng = ServeEngine(port, tp, ServeConfig(
        **{**dict(max_slots=4, max_len=64, prefill_chunk=8,
                  map_dims=(2048, 8192), temperature=0.8, seed=5), **kw}),
        device="cpu")
    return eng, drive(eng, arrivals)


@pytest.fixture(scope="module")
def sampled(params):
    """A workload under temperature, every request queued at step 0, and
    an EOS token that some request samples partway through its budget.
    Queued at once, the requests are admitted at the same steps whatever
    the knobs (a superstep runs only when the queue is empty; arrivals
    during one would wait for its end), so each request's draws are the
    same."""
    _, port = _cfgs()
    _, tp = params
    arrivals = poisson_arrivals(0.5, 24, vocab=port.vocab_size,
                                prompt_len=(2, 40), max_new=(6, 12), seed=2)
    for ev in arrivals:
        ev.step = 0
    _, free = _serve(port, tp, arrivals)
    eos = next(toks[2] for toks in free.values() if len(toks) > 4)
    return port, tp, arrivals, eos


@pytest.mark.parametrize("policy,pack,kw", [
    ("serial", False, dict(superstep=4)),
    ("interleaved", False, dict(fuse=True)),
    ("interleaved", True, dict(fuse=True, superstep=4)),
    ("pim_aware", False, dict(fuse=True, superstep=4)),
])
def test_temperature_tokens_invariant_past_eos(sampled, policy, pack, kw):
    """With an EOS that ends a request early, fused steps and supersteps
    sample the tokens of the same policy's unfused single steps (packing
    changes which step arms a slot, so both sides share it)."""
    port, tp, arrivals, eos = sampled
    _, base = _serve(port, tp, arrivals, policy=policy, pack=pack,
                     eos_token=eos)
    eng, got = _serve(port, tp, arrivals, policy=policy, pack=pack,
                      eos_token=eos, **kw)
    assert got == base
    assert any(v[-1] == eos and len(v) < 6 for v in got.values())
    if kw.get("fuse") and policy != "pim_aware":
        assert eng.dispatch_counts["fused"] > 0
    if kw.get("superstep"):
        assert eng.scheduler.stats["superstep"] > 0


def test_superstep_invariant_past_the_cap(params):
    """The reference's test on the port: a lane ends at the max_len-1 cap
    at round 2 of a k=4 superstep, leaving two dead rounds; a request
    admitted later samples the same tokens under superstep 1 and 4."""
    _, port = _cfgs()
    _, tp = params
    rng = np.random.default_rng(9)
    first = rng.integers(0, port.vocab_size, 6).astype(np.int32)
    second = rng.integers(0, port.vocab_size, 3).astype(np.int32)
    res = {}
    for k in (1, 4):
        eng = ServeEngine(port, tp, ServeConfig(
            max_slots=4, max_len=8, prefill_chunk=8, superstep=k,
            temperature=0.8), device="cpu")
        eng.add_request(first, max_new_tokens=16)
        out = {}
        for _ in range(12):
            for rid, tok in eng.step():
                out.setdefault(rid, []).append(tok)
        rid2 = eng.add_request(second, max_new_tokens=3)
        out.update(eng.run_until_done(30))
        res[k] = (out, int(eng._draw))
        assert rid2 in out and len(out[rid2]) == 3
        assert eng.host_syncs == eng.dispatch_counts["decode"]
    assert res[1] == res[4]
