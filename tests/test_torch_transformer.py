"""Port parity: ``repro_torch.models.transformer`` against
``repro.models.transformer`` on the CPU: batched chunked prefill, then three
decode + sample + terminate steps, at llama3.2-1b ``.reduced()`` with
float32 weights and ``dtype="float32"``.

Logits agree within 1e-4 and caches within 1e-5 (f32: the frameworks sum
the products in another order); the (3, B) fetch is exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import transformer as RT
from repro.models.params import init_params as jax_init
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_tree

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


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _assert_cache(got, want):
    for pos in want:
        for key in want[pos]:
            np.testing.assert_allclose(got[pos][key].numpy(),
                                       np.asarray(want[pos][key]),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_update", ["onehot", "scatter"])
def test_prefill_then_decode_and_sample(params, kv_update):
    ref, port = _cfgs(kv_update=kv_update)
    p, tp = params
    B, L, C, max_new = 3, 48, 8, 4
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, ref.vocab_size, n).astype(np.int32)
               for n in (5, 17, 12)]
    S = max(len(pr) - 1 for pr in prompts)
    n_chunks = -(-S // C)
    tokens = np.zeros((B, n_chunks * C), np.int32)
    valid = np.zeros((B, n_chunks * C), bool)
    for b, pr in enumerate(prompts):
        tokens[b, :len(pr) - 1] = pr[:-1]
        valid[b, :len(pr) - 1] = True

    cache_j = jax_init(RT.cache_defs(ref, B, L), KEY)
    cache_t = from_jax_tree(jax.tree.map(np.asarray, cache_j))
    for c in range(n_chunks):
        sl = slice(c * C, (c + 1) * C)
        cache_j = RT.prefill_chunk(ref, p, jnp.asarray(tokens[:, sl]),
                                   cache_j, jnp.asarray(valid[:, sl]),
                                   offset=c * C)
        cache_t = T.prefill_chunk(port, tp, from_jax_tree(tokens[:, sl]),
                                  cache_t, from_jax_tree(valid[:, sl]),
                                  offset=c * C)
    _assert_cache(cache_t, cache_j)

    lens = np.array([len(pr) - 1 for pr in prompts], np.int32)
    last = np.array([pr[-1] for pr in prompts], np.int32)
    active = np.array([True, True, False])          # slot 2 stays frozen
    state_j = [jnp.asarray(a) for a in (last, lens, np.zeros(B, np.int32))]
    state_t = [from_jax_tree(a) for a in (last, lens, np.zeros(B, np.int32))]
    max_new_a = np.full(B, max_new, np.int32)
    rng_key = jax.random.PRNGKey(1)
    for _ in range(3):
        logits_j, _ = RT.decode_step(ref, p, state_j[0][:, None], cache_j,
                                     state_j[1])
        logits_t, _ = T.decode_step(port, tp, state_t[0][:, None],
                                    _clone(cache_t), state_t[1])
        np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                                   rtol=1e-4, atol=1e-4)
        fetch_j, cache_j, tok_j, lens_j, gen_j, rng_key = \
            RT.decode_and_sample(ref, p, cache_j, state_j[0], state_j[1],
                                 jnp.asarray(active), state_j[2],
                                 jnp.asarray(max_new_a), rng_key,
                                 temperature=0.0, eos_token=None, max_len=L)
        fetch_t, cache_t, tok_t, lens_t, gen_t, _ = T.decode_and_sample(
            port, tp, cache_t, state_t[0], state_t[1],
            from_jax_tree(active), state_t[2], from_jax_tree(max_new_a),
            None, temperature=0.0, eos_token=None, max_len=L)
        assert fetch_t.dtype == torch.int32 and tuple(fetch_t.shape) == (3, B)
        np.testing.assert_array_equal(fetch_t.numpy(), np.asarray(fetch_j))
        _assert_cache(cache_t, cache_j)
        state_j = [tok_j, lens_j, gen_j]
        state_t = [tok_t, lens_t, gen_t]
    assert int(state_t[0][2]) == last[2] and int(state_t[1][2]) == lens[2]


def test_done_rule_eos_budget_and_cache_end(params):
    """done = active & (eos | gen_count >= max_new | lens >= max_len - 1),
    exactly as the reference stacks it."""
    ref, port = _cfgs()
    p, tp = params
    B, L = 3, 16
    cache_j = jax_init(RT.cache_defs(ref, B, L), KEY)
    cache_t = from_jax_tree(jax.tree.map(np.asarray, cache_j))
    last = np.array([3, 4, 5], np.int32)
    lens = np.array([2, 14, 5], np.int32)      # slot 1 hits max_len - 1
    gen = np.array([0, 0, 2], np.int32)        # slot 2 spends its budget
    max_new = np.array([9, 9, 3], np.int32)
    active = np.ones(B, bool)
    logits_j, _ = RT.decode_step(ref, p, jnp.asarray(last)[:, None], cache_j,
                                 jnp.asarray(lens))
    eos = int(np.argmax(np.asarray(logits_j)[0]))   # slot 0 emits eos
    args_j = [jnp.asarray(a) for a in (last, lens, active, gen, max_new)]
    args_t = [from_jax_tree(a) for a in (last, lens, active, gen, max_new)]
    fetch_j = RT.decode_and_sample(ref, p, cache_j, *args_j,
                                   jax.random.PRNGKey(0), temperature=0.0,
                                   eos_token=eos, max_len=L)[0]
    fetch_t = T.decode_and_sample(port, tp, cache_t, *args_t, None,
                                  temperature=0.0, eos_token=eos,
                                  max_len=L)[0]
    np.testing.assert_array_equal(fetch_t.numpy(), np.asarray(fetch_j))
    assert fetch_t[1].tolist()[0] == 1


def test_temperature_sampling_is_seeded(params):
    """Temperature sampling draws its noise from (seed, draw counter)
    only: the same seed gives the same tokens, and each step with a live
    lane advances the counter by one (the reference's jax.random stream
    cannot be matched, so this is the port's own invariant)."""
    _, port = _cfgs()
    _, tp = params
    B, L = 2, 16
    outs = []
    for _ in range(2):
        from repro_torch.models.params import init_params
        cache = init_params(T.cache_defs(port, B, L), device="cpu")
        draw = torch.zeros((), dtype=torch.int64)
        tok = torch.tensor([1, 2], dtype=torch.int32)
        lens = torch.tensor([0, 0], dtype=torch.int32)
        gen = torch.zeros(B, dtype=torch.int32)
        seq = []
        for _ in range(4):
            fetch, cache, tok, lens, gen, draw = T.decode_and_sample(
                port, tp, cache, tok, lens, torch.ones(B, dtype=torch.bool),
                gen, torch.full((B,), 9, dtype=torch.int32), draw,
                temperature=0.8, eos_token=None, max_len=L, seed=9)
            seq.append(fetch.numpy().copy())
        outs.append(np.stack(seq))
        assert int(draw) == 4
    np.testing.assert_array_equal(outs[0], outs[1])


def _defs(tree):
    """A ParamDef tree of either package as {path: (shape, axes, init,
    scale, dtype)}."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out["/".join(path)] = (tuple(t.shape), tuple(t.logical_axes),
                                   t.init, t.scale, t.dtype)
    walk(tree, ())
    return out


def test_encdec_and_vlm_trees_as_the_reference():
    """The encdec and vlm families on llama3.2-1b's reduced config build
    the reference's parameter and cache trees, leaf for leaf (an encdec
    tree adds ``norm_cross``/``cross`` to each decoder block, the
    ``encoder`` tree, here of 0 layers, and ``ck``/``cv`` over 1,500
    frames), and a forward without parameters raises in both packages."""
    for name in ("whisper-medium", "pixtral-12b"):
        fam = jax_arch(name).family
        ref = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                                  family=fam)
        cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                                  family=fam)
        assert _defs(T.param_defs(cfg)) == _defs(RT.param_defs(ref))
        assert _defs(T.cache_defs(cfg, 1, 8)) == \
            _defs(RT.cache_defs(ref, 1, 8))
        assert ("encoder/final_norm/scale" in _defs(T.param_defs(cfg))) \
            == (fam == "encdec")
        with pytest.raises(KeyError):
            RT.forward_full(ref, {}, jnp.zeros((1, 4), jnp.int32))
        with pytest.raises(KeyError):
            T.forward_full(cfg, {}, torch.zeros((1, 4), dtype=torch.long))