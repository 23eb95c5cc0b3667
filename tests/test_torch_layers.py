"""Port parity: ``repro_torch.models.layers`` against ``repro.models.layers``
on the CPU, at llama3.2-1b ``.reduced()`` with float32 weights.

Tolerance 1e-5 (f32; the two frameworks sum products in another order)
unless a test states otherwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_arch
from repro.models import layers as JL
from repro.models.params import init_params as jax_init
from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models.params import from_jax_tree

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**kw):
    ref = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                              dtype="float32", **kw)
    port = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="float32", **kw)
    return ref, port


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32), tree)


def _port(tree):
    return from_jax_tree(jax.tree.map(np.asarray, tree))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "np_layernorm"])
def test_apply_norm(norm):
    ref, port = _cfgs(norm=norm)
    p = _f32(jax_init(JL.norm_defs(ref), KEY))
    if "scale" in p:   # make the affine visible (ones/zeros at init)
        p = {k: v + jnp.asarray(_x(v.shape, 1)) for k, v in p.items()}
    x = _x((2, 5, ref.d_model), scale=3.0) + 1.0
    want = JL.apply_norm(ref, p, jnp.asarray(x))
    got = L.apply_norm(port, _port(p), from_jax_tree(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope(theta):
    np.testing.assert_allclose(L.rope_frequencies(16, theta).numpy(),
                               np.asarray(JL.rope_frequencies(16, theta)),
                               rtol=1e-6)
    x = _x((2, 3, 7, 16))
    pos = np.random.default_rng(2).integers(0, 1000, (2, 1, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(from_jax_tree(x), from_jax_tree(pos), theta)
    # angles reach 1e3 rad: f32 sin/cos of the two libraries differ by a
    # few ulp of the angle
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp_and_its_gemv_form(act):
    """The prefill (GEMM) MLP at S=5 and the decode (GEMV) MLP at S=1 both
    equal the reference's ``apply_mlp`` (gated SwiGLU and plain GELU)."""
    ref, port = _cfgs(act=act)
    p = _f32(jax_init(JL.mlp_defs(ref), KEY))
    x = _x((3, 5, ref.d_model))
    want = JL.apply_mlp(ref, p, jnp.asarray(x))
    got = L.apply_mlp(port, _port(p), from_jax_tree(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want1 = JL.apply_mlp(ref, p, jnp.asarray(x[:, :1]))[:, 0]
    got1 = L.apply_mlp_gemv(port, _port(p), from_jax_tree(x[:, 0]))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), **TOL)


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_lm_logits(tie):
    ref, port = _cfgs(tie_embeddings=tie)
    p = _f32(jax_init(JL.embed_defs(ref), KEY))
    toks = np.random.default_rng(3).integers(0, ref.vocab_size, (2, 6)
                                             ).astype(np.int32)
    x_ref = JL.embed_tokens(p, jnp.asarray(toks), ref.d_model)
    x = L.embed_tokens(_port(p), from_jax_tree(toks))
    np.testing.assert_array_equal(x.numpy(), np.asarray(x_ref))
    want = JL.lm_logits(p, x_ref, tie)
    got = L.lm_logits(_port(p), x, tie)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mixed_dtypes_promote_as_jax_does():
    """bf16 activations against f32 weights compute in f32, as
    ``jnp.promote_types`` makes the reference's einsums do."""
    ref, port = _cfgs()
    p = _f32(jax_init(JL.mlp_defs(ref), KEY))
    x = jnp.asarray(_x((2, 3, ref.d_model))).astype(jnp.bfloat16)
    want = JL.apply_mlp(ref, p, x)
    got = L.apply_mlp(port, _port(p), from_jax_tree(x))
    assert str(want.dtype) == "float32" and str(got.dtype) == "torch.float32"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
