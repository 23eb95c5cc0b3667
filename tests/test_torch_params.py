"""Port parity: configs and parameter trees (repro_torch vs repro).

Weights come from the reference's ``init_params``; the port's tree is the
same tree carried across with ``from_jax_tree``."""
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
from repro_torch.models.params import from_jax_tree, init_params

KEY = jax.random.PRNGKey(0)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("reduced", [False, True])
def test_model_config_is_a_faithful_copy(reduced):
    ref, port = jax_arch("llama3.2-1b"), get_arch("llama3.2-1b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_counts() == ref.param_counts()


@pytest.mark.parametrize("reduced", [False, True])
def test_param_and_cache_defs_match_reference(reduced):
    ref, port = jax_arch("llama3.2-1b"), get_arch("llama3.2-1b")
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    for want_tree, got_tree in ((RT.param_defs(ref), T.param_defs(port)),
                                (RT.cache_defs(ref, 3, 64),
                                 T.cache_defs(port, 3, 64))):
        want, got = dict(_leaves(want_tree)), dict(_leaves(got_tree))
        assert sorted(want) == sorted(got)
        for path, pd in want.items():
            assert dataclasses.astuple(got[path]) == dataclasses.astuple(pd), \
                path


def test_bf16_tree_crosses_leaf_by_leaf():
    """The untouched reference tree (bf16 weights: ml_dtypes arrays that
    torch.from_numpy refuses) arrives with the same nesting, shapes,
    dtypes and bits."""
    cfg = jax_arch("llama3.2-1b").reduced()
    params = jax_init(RT.param_defs(cfg), KEY)
    port = from_jax_tree(jax.tree.map(np.asarray, params))
    want = dict(_leaves(params))
    got = dict(_leaves(port))
    assert sorted(want) == sorted(got)
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert t.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(a.astype(jnp.float32)))


def test_cache_tree_crosses_with_cfg_dtype():
    cfg = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    cache = jax_init(RT.cache_defs(cfg, 2, 16), KEY)
    port = from_jax_tree(jax.tree.map(np.asarray, cache))
    for path, t in _leaves(port):
        assert t.dtype == torch.float32 and tuple(t.shape) == (
            cfg.num_layers, 2, cfg.num_kv_heads, 16, cfg.head_dim), path


def test_torch_init_follows_param_defs():
    """The torch init keeps the reference's dtype behaviour (weights bf16
    whatever cfg.dtype says) and draws each leaf's natural scale."""
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              dtype="float32")
    defs = T.param_defs(cfg)
    a = init_params(defs, torch.Generator().manual_seed(5), device="cpu")
    b = init_params(defs, torch.Generator().manual_seed(5), device="cpu")
    d = dict(_leaves(defs))
    for path, t in _leaves(a):
        assert tuple(t.shape) == d[path].shape
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, dict(_leaves(b))[path])
    tok = a["embed"]["tok"].float()
    assert abs(tok.std().item() - 0.02) < 0.002          # small_normal
    wi = a["blocks"]["pos0"]["ffn"]["wi"].float()
    assert abs(wi.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert torch.equal(a["final_norm"]["scale"].float(),
                       torch.ones(cfg.d_model))
    cache = init_params(T.cache_defs(cfg, 2, 8), device="cpu")
    assert all(t.dtype == torch.float32 and not t.any()
               for _, t in _leaves(cache))


def test_init_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(T.param_defs(get_arch("llama3.2-1b").reduced()))
