"""Port parity of ``repro_torch.optim`` against ``repro.optim`` on the CPU:
AdamW, Adafactor and the schedules fed identical inputs (numpy seeds)
give outputs within 1e-6, including a stacked (L, d) leaf (decayed by
AdamW and factored by Adafactor, as the reference decides on the stacked
shape) and the rate 0 of a warmup's step 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adafactor as JAF
from repro.optim import adamw as JAW
from repro.optim import schedule as JS
from repro_torch.optim import adafactor as AF
from repro_torch.optim import adamw as AW
from repro_torch.optim import schedule as S

TOL = dict(rtol=1e-6, atol=1e-6)
# a matrix, a stacked norm scale (L, d), a vector and a stacked 3-d leaf
SHAPES = {"w": (8, 12), "blocks": {"scale": (3, 12), "wq": (3, 12, 4)},
          "bias": (12,)}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def one(shape):
        if isinstance(shape, dict):
            return {k: one(v) for k, v in shape.items()}
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {k: one(v) for k, v in sorted(SHAPES.items())}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _close(got, want):
    g = jax.tree.map(lambda t: t.numpy(), got,
                     is_leaf=lambda x: isinstance(x, torch.Tensor))
    for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(clip):
    cfg_j, cfg_t = JAW.AdamWConfig(grad_clip=clip), AW.AdamWConfig(
        grad_clip=clip)
    params = _tree(0)
    pj, pt = _j(params), _t(params)
    sj, st = JAW.adamw_init(pj), AW.adamw_init(pt)
    for i in range(3):
        grads = _tree(10 + i, scale=0.5)
        pj, sj, mj = JAW.adamw_update(pj, _j(grads), sj, 1e-2, cfg_j)
        pt, st, mt = AW.adamw_update(pt, _t(grads), st, 1e-2, cfg_t)
        _close(pt, pj)
        _close({"m": st["m"], "v": st["v"]}, {"m": sj["m"], "v": sj["v"]})
        assert int(st["step"]) == int(sj["step"]) == i + 1
        for k in ("grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]), **TOL)


def test_adamw_decays_the_stacked_norm_scale():
    """A zero gradient moves a leaf only through weight decay: the stacked
    (L, d) scale moves, the (d,) bias does not."""
    params = _t(_tree(0))
    zero = jax.tree.map(torch.zeros_like, params)
    new, _, _ = AW.adamw_update(params, zero, AW.adamw_init(params), 1e-2)
    assert not torch.equal(new["blocks"]["scale"], params["blocks"]["scale"])
    assert torch.equal(new["bias"], params["bias"])


def test_adamw_update_consumes_the_old_moments_and_writes_no_input():
    """The update empties the old state's moment trees, so that a step
    holds one copy of the moments (two of jamba's two-layer stack at full
    width do not fit an 80 GB card beside its weights), and writes no
    input tensor: the params, the gradients and the old moments keep
    their values, and the new state mirrors the params."""
    params, grads = _t(_tree(0)), _t(_tree(1, scale=0.5))
    state = AW.adamw_update(params, grads, AW.adamw_init(params), 1e-2)[1]
    held = [t for k in ("m", "v") for t in jax.tree.leaves(state[k])]
    inputs = jax.tree.leaves(params) + jax.tree.leaves(grads) + held
    before = [t.clone() for t in inputs]
    new_p, new_s, _ = AW.adamw_update(params, grads, state, 1e-2)
    assert state["m"] == {} and state["v"] == {}
    for t, b in zip(inputs, before):
        assert torch.equal(t, b)
    shape = jax.tree.structure(jax.tree.map(np.asarray, _tree(0)))
    for tree in (new_p, new_s["m"], new_s["v"]):
        assert jax.tree.structure(jax.tree.map(lambda t: t.numpy(), tree,
                                               is_leaf=lambda x: isinstance(
                                                   x, torch.Tensor))) == shape
    assert int(new_s["step"]) == 2


def test_adamw_update_in_pieces_gives_the_same_bits(monkeypatch):
    """A leaf larger than ``PIECE`` is updated piece by piece (the f32
    temporaries of one of jamba's expert stacks would not fit the card):
    the same bits as the whole leaf at once, weight decay decided on the
    leaf's own rank."""
    params, grads = _t(_tree(0)), _t(_tree(1, scale=0.5))
    state = AW.adamw_update(params, grads, AW.adamw_init(params), 1e-2)[1]
    twin = jax.tree.map(lambda t: t.clone(), state)
    whole = AW.adamw_update(params, grads, state, 1e-2)
    monkeypatch.setattr(AW, "PIECE", 7)
    pieces = AW.adamw_update(params, grads, twin, 1e-2)
    for a, b in zip(jax.tree.leaves(whole[:2]), jax.tree.leaves(pieces[:2])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adafactor_update_matches_reference(weight_decay):
    cfg_j = JAF.AdafactorConfig(weight_decay=weight_decay)
    cfg_t = AF.AdafactorConfig(weight_decay=weight_decay)
    params = _tree(1)
    pj, pt = _j(params), _t(params)
    sj, st = JAF.adafactor_init(pj), AF.adafactor_init(pt)
    # the stacked scale is factored, its state the reference's
    assert set(st["v"]["blocks"]["scale"]) == {"v_row", "v_col"}
    assert st["v"]["blocks"]["scale"]["v_row"].shape == (3,)
    for i in range(3):
        grads = _tree(20 + i, scale=0.3)
        pj, sj, mj = JAF.adafactor_update(pj, _j(grads), sj, 1e-3, cfg_j)
        pt, st, mt = AF.adafactor_update(pt, _t(grads), st, 1e-3, cfg_t)
        _close(pt, pj)
        _close(st["v"], sj["v"])
        np.testing.assert_allclose(float(mt["beta2"]), float(mj["beta2"]),
                                   **TOL)


@pytest.mark.parametrize("sched", ["cosine", "warmup"])
def test_schedules_match_reference(sched):
    if sched == "cosine":
        fj, ft = JS.cosine_schedule(3e-4, 50), S.cosine_schedule(3e-4, 50)
    else:
        fj = JS.linear_warmup_cosine(1e-3, 20, 200)
        ft = S.linear_warmup_cosine(1e-3, 20, 200)
    for step in (0, 1, 7, 19, 20, 21, 50, 199, 250):
        got = ft(torch.tensor(step, dtype=torch.int32))
        want = fj(jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=0)
    if sched == "warmup":
        assert float(ft(torch.tensor(0, dtype=torch.int32))) == 0.0
