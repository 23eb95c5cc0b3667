"""Port parity of training beyond the dense family on the CPU: for
qwen3-moe-30b-a3b (moe), rwkv6-7b (ssm), jamba-v0.1-52b (hybrid),
whisper-medium (encdec) and pixtral-12b (vlm), ``.reduced()`` in float32,
the loss, nll, aux and every gradient leaf of ``loss_and_grads`` against
``jax.value_and_grad(repro.models.transformer.loss_fn)``, three AdamW
steps of ``make_train_step`` and one Adafactor step of
``step_fn_for(cfg, "train")`` against the reference's; the plain backward
versions of the two recurrences (``ref.rwkv_chunk_bwd_ref``,
``ref.mamba_chunk_bwd_ref``, explicit adjoints) against ``jax.vjp`` of
the reference's oracles and against torch autograd through the port's
own; and whisper's encoder under remat.

Weights drawn in float32 as the reference's ``init_params`` draws them,
from a numpy seed (``np_init``: the same in every process), and carried
across with ``from_jax_tree``; batches from ``batch_for`` (numpy). The
reference's jitted functions are built once a family (module fixtures).
Tolerances: 1e-4 for the losses and gradients (f32, other summation
orders), 1e-3 for three AdamW steps, the existing Adafactor test's
1e-5 / 1e-6 for its parameters; the plain backward versions within 1e-4
of ``jax.vjp`` and of autograd (the same sums in other orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_arch
from repro.data import batch_for as jax_batch_for
from repro.kernels import ref as JREF
from repro.launch.steps import step_fn_for as jax_step_fn_for
from repro.models import transformer as RT
from repro.models.params import is_def
from repro.optim import adafactor as JAF
from repro.optim import adamw_init as jax_adamw_init
from repro.train import TrainStepConfig as JTrainStepConfig
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch
from repro_torch.data import batch_for
from repro_torch.kernels import ref
from repro_torch.launch.steps import step_fn_for
from repro_torch.models.params import from_jax_tree
from repro_torch.optim import adafactor_init, adamw_init
from repro_torch.train import TrainStepConfig, loss_and_grads, make_train_step

FAMILIES = ["qwen3-moe-30b-a3b", "rwkv6-7b", "jamba-v0.1-52b",
            "whisper-medium", "pixtral-12b"]
TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_leaf(pd, rng):
    """A float32 leaf drawn as the reference's ``_materialize`` draws it."""
    if pd.init in ("zeros", "ones"):
        return np.full(pd.shape, float(pd.init == "ones"), np.float32)
    if pd.init == "decay":
        return (np.log(rng.uniform(1e-3, 1.0, pd.shape)) * pd.scale
                ).astype(np.float32)
    std = pd.scale * (0.02 if pd.init == "small_normal"
                      else pd.fan_in() ** -0.5)
    return (rng.standard_normal(pd.shape) * std).astype(np.float32)


def np_init(defs):
    """float32 weights drawn as ``init_params`` draws them, leaf by leaf
    from a numpy seed, the same in every process. ``init_params`` folds
    ``hash()`` of each leaf's path into its key, which Python salts per
    process, so its weights, and with them how far float32 roundoff
    carries two summation orders apart, change from run to run."""
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(defs, is_leaf=is_def)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(_np_leaf(pd, rng)) for pd in leaves])


def _cfgs(name, **kw):
    return (dataclasses.replace(jax_arch(name).reduced(), dtype="float32",
                                **kw),
            dataclasses.replace(get_arch(name).reduced(), dtype="float32",
                                **kw))


class Family:
    """One family's configs, float32 weights in both packages and the
    reference's jitted loss gradient, built once."""

    def __init__(self, name):
        self.ref, self.port = _cfgs(name)
        self.pj = np_init(RT.param_defs(self.ref))
        self.pt = from_jax_tree(jax.tree.map(np.asarray, self.pj))
        self.grad = jax.jit(jax.value_and_grad(
            lambda p, b: RT.loss_fn(self.ref, p, b), has_aux=True))

    def batch(self, step=0):
        b = batch_for(self.port, B, S, seed=step)
        jb = jax_batch_for(self.ref, B, S, seed=step)
        for k in b:
            np.testing.assert_array_equal(b[k], np.asarray(jb[k]))
        return b


@pytest.fixture(scope="module")
def families():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = Family(name)
        return cache[name]
    return get


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(
        lambda t: t.detach().numpy(), tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_leaf_match_the_reference(families, name):
    f = families(name)
    b = f.batch()
    (loss_j, m_j), g_j = f.grad(f.pj, jax.tree.map(jnp.asarray, b))
    loss_t, m_t, g_t = loss_and_grads(f.port, f.pt, _port_batch(b))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), **TOL)
    if f.port.is_moe:
        assert float(m_t["aux"]) > 0
    assert jax.tree.structure(jax.tree.map(np.asarray, g_j)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, g_t))
    for got, want in zip(_leaves(g_t), jax.tree.leaves(g_j)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        assert np.isfinite(got).all()


@pytest.mark.parametrize("name", FAMILIES)
def test_three_adamw_steps_match_the_reference(families, name):
    f = families(name)
    step_j = jax.jit(jax_make_train_step(f.ref, JTrainStepConfig(
        learning_rate=lambda s: 1e-3)))
    step_t = make_train_step(f.port, TrainStepConfig(
        learning_rate=lambda s: 1e-3), device="cpu")
    pj, pt = f.pj, f.pt
    oj, ot = jax_adamw_init(pj), adamw_init(pt)
    for i in range(3):
        b = f.batch(i)
        pj, oj, mj = step_j(pj, oj, jax.tree.map(jnp.asarray, b))
        pt, ot, mt = step_t(pt, ot, b)
        for k in ("loss", "nll", "aux", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-3, atol=1e-3)
    for got, want in zip(_leaves(pt), jax.tree.leaves(pj)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-3)


@pytest.mark.parametrize("name", FAMILIES)
def test_the_lowered_train_step_matches_the_reference(families, name):
    """``step_fn_for(cfg, "train")``: loss -> grad -> Adafactor at lr
    1e-4, one step against the reference's."""
    f = families(name)
    b = f.batch()
    nj, _, mj = jax.jit(jax_step_fn_for(f.ref, "train"))(
        f.pj, JAF.adafactor_init(f.pj), jax.tree.map(jnp.asarray, b))
    nt, st, mt = step_fn_for(f.port, "train", device="cpu")(
        f.pt, adafactor_init(f.pt), b)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), **TOL)
    assert int(st["step"]) == 1
    for got, want in zip(_leaves(nt), jax.tree.leaves(nj)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_encoder_remat_gives_the_gradients_of_none(families, remat):
    """whisper's encoder blocks (and the decoder's) under remat: the same
    loss and gradients as without it."""
    f = families("whisper-medium")
    b = _port_batch(f.batch())
    loss0, _, g0 = loss_and_grads(f.port, f.pt, b)
    loss1, _, g1 = loss_and_grads(dataclasses.replace(f.port, remat=remat),
                                  f.pt, b)
    assert float(loss1) == float(loss0)
    for a, c in zip(_leaves(g1), _leaves(g0)):
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# the plain backward versions of the recurrences
# --------------------------------------------------------------------------- #
def _decays(rng, shape, kind):
    """The model's decays exp(-exp(w0)), w0 in ssm.py's clamp [-10, 4]:
    "strong" down to exp(-e^4) ~ 2e-24, "weak" up to exp(-e^-10) ~
    1 - 4.5e-5, "mixed" over the whole range."""
    lo, hi = {"strong": (2.0, 4.0), "weak": (-10.0, -8.0),
              "mixed": (-10.0, 4.0)}[kind]
    return np.exp(-np.exp(rng.uniform(lo, hi, shape))).astype(np.float32)


def _rwkv_inputs(BH, T, K, U, kind, seed, final_grad):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.normal(0, 0.5, (BH, T, K)).astype(np.float32)
                   for _ in range(4))
    w = _decays(rng, (BH, T, K), kind)
    u = rng.normal(0, 0.3, (U, K)).astype(np.float32)
    ds = rng.normal(0, 0.5, (BH, K, K)).astype(np.float32) \
        if final_grad else None
    return r, k, v, w, u, dy, ds


RWKV_CASES = [
    (6, 37, 16, 3, "mixed", True),   # U < BH, a ragged T, S_T's gradient
    (4, 20, 8, 4, "strong", False),  # decays near 2e-24
    (2, 50, 16, 1, "weak", True),    # decays near 1 - 4.5e-5, U 1
]


def _jax_rwkv_grads(r, k, v, w, u, dy, ds):
    """jax.vjp of the reference's oracle (s0 = 0), row by row, du summed
    over the rows that share u[bh % U]."""
    BH, _, K = r.shape
    U = u.shape[0]
    u_rows = np.tile(u, (BH // U, 1))

    def fwd(r, k, v, w, u):
        return jax.vmap(lambda *a: JREF.rwkv_chunk_ref(
            *a, jnp.zeros((K, K), jnp.float32)))(r, k, v, w, u)
    _, vjp = jax.vjp(fwd, r, k, v, w, u_rows)
    dr, dk, dv, dw, du = vjp((dy, np.zeros((BH, K, K), np.float32)
                              if ds is None else ds))
    return dr, dk, dv, dw, np.asarray(du).reshape(BH // U, U, K).sum(0)


@pytest.mark.parametrize("BH,T,K,U,kind,final_grad", RWKV_CASES)
def test_rwkv_plain_backward_matches_jax_vjp(BH, T, K, U, kind, final_grad):
    args = _rwkv_inputs(BH, T, K, U, kind, 1, final_grad)
    got = ref.rwkv_chunk_bwd_ref(*(None if a is None else torch.from_numpy(a)
                                   for a in args))
    want = _jax_rwkv_grads(*args)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


@pytest.mark.parametrize("BH,T,K,U,kind,final_grad", RWKV_CASES)
def test_rwkv_plain_backward_matches_autograd(BH, T, K, U, kind, final_grad):
    """Against torch autograd through ``ref.rwkv_chunk_ref``, with u
    broadcast over the rows as ``ops.rwkv_chunk`` broadcasts it."""
    r, k, v, w, u, dy, ds = (None if a is None else torch.from_numpy(a)
                             for a in _rwkv_inputs(BH, T, K, U, kind, 2,
                                                   final_grad))
    leaves = [t.clone().requires_grad_() for t in (r, k, v, w, u)]
    y, s = ref.rwkv_chunk_ref(*leaves[:4], leaves[4].repeat(BH // U, 1))
    loss = (y * dy).sum() + (0 if ds is None else (s * ds).sum())
    want = torch.autograd.grad(loss, leaves)
    got = ref.rwkv_chunk_bwd_ref(r, k, v, w, u, dy, ds)
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, **TOL)


def _mamba_inputs(Bm, T, d, n, kind, seed, final_grad):
    rng = np.random.default_rng(seed)
    a = {"mixed": rng.uniform(0, 1, (Bm, T, d, n)),
         "zero": np.where(rng.uniform(0, 1, (Bm, T, d, n)) < 0.5, 0.0,
                          rng.uniform(0, 1e-30, (Bm, T, d, n)))}[kind]
    u = rng.normal(0, 1, (Bm, T, d, n))
    C = rng.normal(0, 1, (Bm, T, n))
    dy = rng.normal(0, 1, (Bm, T, d))
    dh = rng.normal(0, 1, (Bm, d, n)) if final_grad else None
    return tuple(None if x is None else x.astype(np.float32)
                 for x in (a, u, C, dy, dh))


MAMBA_CASES = [
    (2, 13, 5, 4, "mixed", True),    # d and T off every tile, h_T's grad
    (1, 9, 3, 16, "zero", False),    # a = 0 or below 1e-30
]


@pytest.mark.parametrize("Bm,T,d,n,kind,final_grad", MAMBA_CASES)
def test_mamba_plain_backward_matches_jax_vjp(Bm, T, d, n, kind,
                                              final_grad):
    a, u, C, dy, dh = _mamba_inputs(Bm, T, d, n, kind, 3, final_grad)
    _, vjp = jax.vjp(jax.vmap(JREF.mamba_chunk_ref), a, u, C)
    want = vjp((dy, np.zeros((Bm, d, n), np.float32) if dh is None else dh))
    got = ref.mamba_chunk_bwd_ref(*(None if x is None else torch.from_numpy(x)
                                    for x in (a, u, C, dy, dh)))
    for g, w_ in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), **TOL)


@pytest.mark.parametrize("Bm,T,d,n,kind,final_grad", MAMBA_CASES)
def test_mamba_plain_backward_matches_autograd(Bm, T, d, n, kind,
                                               final_grad):
    a, u, C, dy, dh = (None if x is None else torch.from_numpy(x)
                       for x in _mamba_inputs(Bm, T, d, n, kind, 4,
                                              final_grad))
    leaves = [t.clone().requires_grad_() for t in (a, u, C)]
    y, h = ref.mamba_chunk_ref(*leaves)
    loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
    want = torch.autograd.grad(loss, leaves)
    for g, w_ in zip(ref.mamba_chunk_bwd_ref(a, u, C, dy, dh), want):
        torch.testing.assert_close(g, w_, **TOL)
