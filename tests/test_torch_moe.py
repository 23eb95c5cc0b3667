"""Port parity for ``repro_torch.models.moe`` against ``repro.models.moe``
on the CPU: capacity, top-k routing, the dispatch tables, the balance loss
and the whole MoE FFN, at jamba-v0.1-52b ``.reduced()`` (4 experts, top-2)
in float32.

Inputs are made with numpy from a seed and handed to both sides. Integer
results (capacities, expert indices, tables) must be equal; float results
agree within 1e-4 (f32: the frameworks sum in another order). One case
skews the router so that experts overflow and tokens are dropped, which
depends on the stable order of the dispatch sort.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.models import moe as JM
from repro_torch.configs import get_arch
from repro_torch.models import moe as M

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs():
    name = "jamba-v0.1-52b"
    return (dataclasses.replace(jax_arch(name).reduced(), dtype="float32"),
            dataclasses.replace(get_arch(name).reduced(), dtype="float32"))


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _moe_params(cfg, seed, skew=0.0):
    """f32 MoE leaves; ``skew`` adds to the router's first two columns so
    that most tokens pick experts 0 and 1."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    router = _x((d, E), seed, 0.3)
    router[:, :2] += skew
    return {"router": router, "wi": _x((E, d, f), seed + 1, d ** -0.5),
            "wg": _x((E, d, f), seed + 2, d ** -0.5),
            "wo": _x((E, f, d), seed + 3, f ** -0.5)}


@pytest.mark.parametrize("T,k,E,cf", [
    (16, 2, 4, 1.25), (8, 2, 16, 1.25), (4096, 2, 16, 1.25), (1, 1, 8, 1.0),
    (3, 2, 4, 2.0), (5, 2, 4, 0.1),
])
def test_capacity_matches_reference(T, k, E, cf):
    assert M.capacity(T, k, E, cf) == JM.capacity(T, k, E, cf)


@pytest.mark.parametrize("tied", [False, True])
def test_route_matches_reference(tied):
    """Top-k weights and indices; with tied logits the lower expert index
    comes first, as ``lax.top_k`` orders them. (``lax.top_k`` also ranks
    +0 above -0, which the port takes as equal: the tied logits here are
    rounded, with -0 made +0.)"""
    logits = _x((3, 7, 8), 1)
    if tied:
        logits = np.round(logits) + 0.0   # many equal logits per row
    want_w, want_i = JM.route(jnp.asarray(logits), 2)
    got_w, got_i = M.route(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)


def test_load_balance_loss_matches_reference():
    logits = _x((2, 9, 4), 2)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    _, idx = JM.route(jnp.asarray(logits), 2)
    want = JM.load_balance_loss(jnp.asarray(probs), idx, 4)
    got = M.load_balance_loss(torch.from_numpy(probs),
                              torch.from_numpy(np.array(idx)), 4)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("T,k,E,C", [(16, 2, 4, 10), (16, 2, 4, 3),
                                     (8, 2, 16, 2), (5, 1, 3, 5)])
def test_dispatch_tables_match_reference(T, k, E, C):
    """Exactly equal tables, with experts past their capacity (C 3 and
    C 2 drop tokens) and experts nobody picks."""
    idx = np.random.default_rng(T + C).integers(0, E, (T, k)).astype(
        np.int32)
    want = JM._dispatch_tables(jnp.asarray(idx), k, E, C)
    got = M._dispatch_tables(torch.from_numpy(idx), k, E, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("skew", [0.0, 4.0])
def test_apply_moe_matches_reference(skew):
    """The MoE FFN's output and aux loss; with the skewed router the
    capacity drops tokens, and the port drops the same ones."""
    ref, cfg = _cfgs()
    p = _moe_params(cfg, 3, skew)
    x = _x((2, 8, cfg.d_model), 4) + 0.5     # a positive mean: the skew
    want, want_aux = JM.apply_moe(ref, {k: jnp.asarray(v)
                                        for k, v in p.items()},
                                  jnp.asarray(x))
    got, got_aux = M.apply_moe(cfg, {k: torch.from_numpy(v)
                                     for k, v in p.items()},
                               torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), **TOL)
    # how many of the 2 x 16 assignments found a slot
    Tg, k, E = 16, cfg.experts_per_token, cfg.num_experts
    _, idx = M.route(torch.from_numpy(x.reshape(Tg, -1) @ p["router"]), k)
    _, _, valid = M._dispatch_tables(idx, k, E,
                                     M.capacity(Tg, k, E,
                                                cfg.capacity_factor))
    if skew:
        assert int(valid.sum()) < Tg * k


def test_apply_moe_keeps_the_input_dtype_flow():
    """bf16 activations against bf16 experts compute in bf16, as the
    reference's einsums do; the aux loss is f32."""
    _, cfg = _cfgs()
    p = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in _moe_params(cfg, 5).items()}
    y, aux = M.apply_moe(cfg, p, torch.from_numpy(
        _x((1, 3, cfg.d_model), 6)).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert y.shape == (1, 3, cfg.d_model) and bool(torch.isfinite(y).all())


def test_moe_defs_match_reference():
    ref, cfg = _cfgs()
    for fsdp in (False, True):
        want = JM.moe_defs(dataclasses.replace(ref, fsdp_params=fsdp), 3)
        got = M.moe_defs(dataclasses.replace(cfg, fsdp_params=fsdp), 3)
        assert {k: dataclasses.astuple(v) for k, v in got.items()} \
            == {k: dataclasses.astuple(v) for k, v in want.items()}


def test_expert_parallel_moe_is_not_ported():
    """The expert-parallel path is ported now (its multi-rank cases are in
    ``test_torch_multirank.py``): under a mesh of one rank ``apply_moe``
    routes as without one, ``moe_impl="ep"`` or not, and
    ``apply_moe_ep`` on that rank gives the same output and balance
    loss."""
    from repro_torch.launch.mesh import make_host_mesh
    _, cfg = _cfgs()
    cfg = dataclasses.replace(cfg, moe_impl="ep")
    p = {k: torch.from_numpy(v) for k, v in _moe_params(cfg, 3).items()}
    x = torch.from_numpy(_x((2, 5, cfg.d_model), 4))
    mesh = make_host_mesh()
    want_y, want_aux = M.apply_moe(cfg, p, x)
    for y, aux in (M.apply_moe(cfg, p, x, mesh=mesh),
                   M.apply_moe_ep(cfg, p, x, mesh)):
        np.testing.assert_allclose(y.numpy(), want_y.numpy(), **TOL)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
