"""Port parity of the training path's two kernels' gradients on the CPU:
``ops.FlashAttentionFn`` (the plain forward with its log-sum-exp and the
plain recomputing backward) against ``jax.grad`` of the reference's
``flash_attention_fused``, its ``lse`` against ``return_lse``, and
``ops.NormFn`` against ``jax.grad`` of ``repro.models.layers.apply_norm``
in each mode.

Inputs from a numpy seed; float32; tolerance 1e-4 (the reference's own
for its custom VJP: the frameworks sum in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import layers as JL
from repro.models.attention import flash_attention_fused as jax_fused
from repro.models.attention import flash_attention_xla
from repro_torch.configs import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models.attention import flash_attention_fused

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _grads_port(fn, arrays, do):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return [g.numpy() for g in torch.autograd.grad(
        (out * torch.from_numpy(do)).sum(), ts)]


# the cases of tests/test_kernels.py::test_flash_custom_vjp_gradients, a
# GQA case with G 4 and a ragged S, the reduced llama's head dim, and the
# head dims above 64 that the card's backward takes (gpt2-2.5b's 96,
# kimi-k2's 112, jamba's 128, pixtral-12b's 160) at ragged sizes
FLASH_CASES = [(2, 4, 2, 64, 32, True), (1, 4, 4, 128, 32, False),
               (1, 8, 2, 37, 16, True), (2, 4, 2, 24, 16, False),
               (1, 4, 2, 40, 96, True), (1, 4, 1, 33, 112, False),
               (1, 2, 2, 64, 128, True), (1, 4, 2, 70, 160, True)]


@pytest.mark.parametrize("B,H,KH,S,D,causal", FLASH_CASES)
def test_flash_gradients_match_the_reference_custom_vjp(B, H, KH, S, D,
                                                        causal):
    q, k, v = _x((B, H, S, D), 0), _x((B, KH, S, D), 1), _x((B, KH, S, D), 2)
    do = _x((B, H, S, D), 3)
    want = jax.grad(lambda *a: jnp.sum(jax_fused(*a, causal, 32, 32) * do),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    got = _grads_port(lambda *t: flash_attention_fused(*t, causal, 32, 32),
                      (q, k, v), do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("B,H,KH,S,D,causal", FLASH_CASES)
def test_flash_lse_matches_the_reference(B, H, KH, S, D, causal):
    q, k, v = _x((B, H, S, D), 4), _x((B, KH, S, D), 5), _x((B, KH, S, D), 6)
    o_want, lse_want = flash_attention_xla(
        *map(jnp.asarray, (q, k, v)), causal=causal, chunk_q=16, chunk_kv=16,
        return_lse=True)
    o, lse = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_want), **TOL)
    # the reference's (B, KH, G, S) is the port's (B, H, S)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_want).reshape(B, H, S), **TOL)


def test_flash_backward_reads_lse_in_natural_log_units():
    """A log-sum-exp off by a factor of ln 2 (the bf16 kernel's log2
    scores) leaves the output alone and shows only in the gradients: the
    plain backward given lse / ln 2 must fail the bound."""
    B, H, KH, S, D = 1, 4, 2, 33, 16
    q, k, v = (torch.from_numpy(_x(s, i)) for i, s in
               enumerate(((B, H, S, D), (B, KH, S, D), (B, KH, S, D))))
    do = torch.from_numpy(_x((B, H, S, D), 9))
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    good = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    bad = ref.flash_attention_bwd_ref(q, k, v, o, lse / np.log(2.0), do)
    want = _grads_port(lambda *t: ref.flash_attention_ref(*t),
                       (q.numpy(), k.numpy(), v.numpy()), do.numpy())
    for g, b, w in zip(good, bad, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        assert np.abs(b.numpy() - w).max() > 1e-2


def test_flash_fn_keeps_the_serving_path_without_a_gradient():
    """No input requires a gradient: the dispatch layer's usual path, the
    same bits as before, and no autograd graph."""
    q, k, v = (torch.from_numpy(_x((1, 4, 9, 16), i)) for i in range(3))
    o = ops.flash_attention(q, k[:, :2], v[:, :2])
    assert o.grad_fn is None
    torch.testing.assert_close(o, ref.flash_attention_ref(q, k[:, :2],
                                                          v[:, :2]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "np_layernorm"])
def test_norm_gradients_match_the_reference(norm):
    cfg_j = dataclasses.replace(jax_arch("llama3.2-1b").reduced(), norm=norm,
                                dtype="float32")
    cfg_t = dataclasses.replace(get_arch("llama3.2-1b").reduced(), norm=norm,
                                dtype="float32")
    d = cfg_j.d_model
    x, dy = _x((2, 5, d), 0, 3.0) + 1.0, _x((2, 5, d), 1)
    p = {"scale": _x((d,), 2) + 1.0, "bias": _x((d,), 3)}
    p = {k: p[k] for k in {"rmsnorm": ("scale",), "np_layernorm": (),
                           "layernorm": ("scale", "bias")}[norm]}
    names = sorted(p)

    def jf(x, *leaves):
        return jnp.sum(JL.apply_norm(cfg_j, dict(zip(names, leaves)), x) * dy)
    want = jax.grad(jf, argnums=tuple(range(1 + len(names))))(
        jnp.asarray(x), *(jnp.asarray(p[n]) for n in names))
    got = _grads_port(
        lambda x, *leaves: L.apply_norm(cfg_t, dict(zip(names, leaves)), x),
        [x] + [p[n] for n in names], dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("mode", ["rmsnorm", "layernorm", "np_layernorm"])
def test_norm_bwd_ref_matches_autograd_of_the_plain_forward(mode):
    """The plain backward the CPU path runs is the gradient of the plain
    forward, in bf16 too (dx in x's dtype, the sums in f32 before the
    cast)."""
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(_x((7, 48), 0, 2.0)).to(dtype).requires_grad_()
        s = torch.from_numpy(_x((48,), 1)).to(dtype).requires_grad_()
        b = torch.from_numpy(_x((48,), 2)).to(dtype).requires_grad_()
        dy = torch.from_numpy(_x((7, 48), 3)).to(dtype)
        scale = None if mode == "np_layernorm" else s
        bias = b if mode == "layernorm" else None
        ins = [t for t in (x, scale, bias) if t is not None]
        want = torch.autograd.grad(
            (ref.norm_ref(x, scale, bias, mode=mode).float() * dy.float()
             ).sum(), ins)
        with torch.no_grad():
            dx, ds, db = ref.norm_bwd_ref(x, scale, bias, dy, mode=mode)
        got = [t for t in (dx, ds, db) if t is not None]
        tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       **tol)
