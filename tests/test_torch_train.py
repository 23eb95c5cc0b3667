"""Port parity of the training path on the CPU: ``loss_fn`` and every
gradient leaf of llama3.2-1b ``.reduced()`` in float32 against
``jax.value_and_grad(repro.models.transformer.loss_fn)``, the three remat
modes, ``make_train_step`` against the reference's jitted step, its
microbatches, the lowered Adafactor train step, the int8 compression at
world size 1, the data streams, the checkpoint store (both ways across
the packages), ``param_count`` and ``launch.train``'s crash/resume
contract.

Weights from the reference's ``init_params`` cast to float32 and carried
across with ``from_jax_tree``; batches from the data streams (numpy).
Tolerances: 1e-4 for the loss and gradients (f32, other summation
orders), 1e-3 for 12 train steps' losses, the reference's 2e-2 for
microbatches. The module runs torch on one thread: these models are
small enough that a thread pool only adds overhead."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as JST
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_arch as jax_arch
from repro.data import ByteCorpus as JByteCorpus
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import step_fn_for as jax_step_fn_for
from repro.models import transformer as RT
from repro.models.params import init_params as jax_init
from repro.models.params import param_bytes as jax_param_bytes
from repro.models.params import param_count as jax_param_count
from repro.optim import adafactor as JAF
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import linear_warmup_cosine as jax_warmup
from repro.train import TrainStepConfig as JTrainStepConfig
from repro.train import compression as JC
from repro.train import make_train_step as jax_make_train_step
from repro_torch import checkpoint as ST
from repro_torch.configs import ARCHS, get_arch
from repro_torch.data import ByteCorpus, SyntheticLM
from repro_torch.launch.steps import step_fn_for
from repro_torch.models import transformer as T
from repro_torch.models.params import (from_jax_tree, init_params,
                                       param_bytes, param_count)
from repro_torch.optim import adafactor_init, adamw_init, linear_warmup_cosine
from repro_torch.train import (TrainStepConfig, compression, loss_and_grads,
                               make_train_step)

KEY = jax.random.PRNGKey(0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    ref = dataclasses.replace(jax_arch("llama3.2-1b").reduced(),
                              dtype="float32", **kw)
    port = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                               dtype="float32", **kw)
    return ref, port


@pytest.fixture(scope="module")
def params():
    ref, _ = _cfgs()
    p = jax.jit(lambda key: jax.tree.map(
        lambda a: a.astype(jnp.float32), jax_init(RT.param_defs(ref), key)))(
            KEY)
    return p, from_jax_tree(jax.tree.map(np.asarray, p))


def _batch(vocab, seq=16, batch=4, step=0):
    return SyntheticLM(vocab, seq, batch).batch(step)


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(
        lambda t: t.detach().numpy(), tree,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_loss_and_every_gradient_leaf_match_the_reference(params):
    ref, port = _cfgs()
    pj, pt = params
    b = _batch(ref.vocab_size)
    b["loss_mask"] = (np.arange(16)[None, :] % 5 != 0).repeat(4, 0)
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: RT.loss_fn(ref, p, b), has_aux=True))(
            pj, jax.tree.map(jnp.asarray, b))
    loss_t, m_t, g_t = loss_and_grads(port, pt, _port_batch(b))
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    np.testing.assert_allclose(float(m_t["nll"]), float(m_j["nll"]), **TOL)
    assert float(m_t["aux"]) == float(m_j["aux"]) == 0.0
    assert jax.tree.structure(jax.tree.map(np.asarray, g_j)) == \
        jax.tree.structure(jax.tree.map(lambda t: 0, g_t))
    for got, want in zip(_leaves(g_t), jax.tree.leaves(g_j)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(params, remat):
    _, port = _cfgs()
    b = _port_batch(_batch(port.vocab_size))
    loss0, _, g0 = loss_and_grads(port, params[1], b)
    loss1, _, g1 = loss_and_grads(dataclasses.replace(port, remat=remat),
                                  params[1], b)
    assert float(loss1) == float(loss0)
    for a, c in zip(_leaves(g1), _leaves(g0)):
        np.testing.assert_allclose(a, c, rtol=1e-6, atol=1e-7)


def test_twelve_train_steps_match_the_reference(params):
    """AdamW under the warmup schedule, whose step 0 has rate 0 in both
    packages: 12 losses within 1e-3, and the rates equal."""
    ref, port = _cfgs()
    pj, pt = params
    data = SyntheticLM(ref.vocab_size, 16, 4)
    step_j = jax.jit(jax_make_train_step(ref, JTrainStepConfig(
        learning_rate=jax_warmup(2e-3, 3, 12))))
    step_t = make_train_step(port, TrainStepConfig(
        learning_rate=linear_warmup_cosine(2e-3, 3, 12)), device="cpu")
    oj, ot = jax_adamw_init(pj), adamw_init(pt)
    for i in range(12):
        b = data.batch(i)
        pj, oj, mj = step_j(pj, oj, jax.tree.map(jnp.asarray, b))
        pt, ot, mt = step_t(pt, ot, b)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6, atol=0)
        for k in ("nll", "grad_norm", "clip_scale"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-3, atol=1e-3)
    assert float(linear_warmup_cosine(2e-3, 3, 12)(
        torch.tensor(0, dtype=torch.int32))) == 0.0


def test_microbatches_match_the_full_batch():
    """Gradient accumulation over 4 microbatches in f32 against one batch,
    12 steps at the reduced config's bf16 weights (the reference's
    test_microbatching_matches_full_batch)."""
    cfg = get_arch("llama3.2-1b").reduced()
    data = SyntheticLM(cfg.vocab_size, 16, 8)
    losses = []
    for mb in (1, 4):
        p = init_params(T.param_defs(cfg), device="cpu", seed=0)
        o = adamw_init(p)
        step = make_train_step(cfg, TrainStepConfig(
            microbatches=mb, learning_rate=lambda s: 2e-3), device="cpu")
        out = []
        for i in range(12):
            p, o, m = step(p, o, data.batch(i))
            out.append(float(m["loss"]))
        losses.append(out)
    np.testing.assert_allclose(losses[0], losses[1], rtol=2e-2, atol=2e-2)


def test_the_lowered_train_step_matches_the_reference_adafactor(params):
    """``step_fn_for(cfg, "train")``: loss -> grad -> Adafactor at lr
    1e-4, with 2 microbatches, against the reference's first step."""
    ref, port = _cfgs()
    pj, pt = params
    b = _batch(ref.vocab_size)
    nj, _, mj = jax.jit(jax_step_fn_for(ref, "train", microbatches=2))(
        pj, JAF.adafactor_init(pj), jax.tree.map(jnp.asarray, b))
    nt, st, mt = step_fn_for(port, "train", device="cpu", microbatches=2)(
        pt, adafactor_init(pt), b)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]), **TOL)
    assert int(st["step"]) == 1
    for got, want in zip(_leaves(nt), jax.tree.leaves(nj)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", sorted(JAX_ARCHS))
def test_param_count_matches_the_reference(name):
    cfg_j, cfg_t = jax_arch(name), get_arch(name)
    assert param_count(T.param_defs(cfg_t)) == \
        jax_param_count(RT.param_defs(cfg_j))
    assert param_bytes(T.param_defs(cfg_t)) == \
        jax_param_bytes(RT.param_defs(cfg_j))


def test_llama_has_its_published_parameter_count():
    assert sorted(ARCHS) == sorted(JAX_ARCHS)
    assert param_count(T.param_defs(get_arch("llama3.2-1b"))) == 1_235_814_400


def test_compression_at_world_size_one_matches_the_reference():
    """The int8 EF all-reduce with no process group against the
    reference's on a 1 x 1 mesh, 5 rounds: means and error buffers."""
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    rng = np.random.default_rng(0)
    g = {"w": rng.normal(0, 1, (16, 24)).astype(np.float32),
         "b": {"s": rng.normal(0, 3, (24,)).astype(np.float32)}}
    ej = JC.init_error_state(jax.tree.map(jnp.asarray, g))
    et = compression.init_error_state(jax.tree.map(torch.from_numpy, g))
    allreduce_j = jax.jit(lambda g, e: JC.compressed_grad_allreduce(g, e,
                                                                   mesh))
    for i in range(5):
        gi = jax.tree.map(lambda x: x * (1 + 0.1 * i), g)
        oj, ej = allreduce_j(jax.tree.map(jnp.asarray, gi), ej)
        ot, et = compression.compressed_grad_allreduce(
            jax.tree.map(torch.from_numpy, gi), et)
        for got, want in zip(_leaves(ot) + _leaves(et),
                             jax.tree.leaves(oj) + jax.tree.leaves(ej)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                                       atol=1e-6)
    for c in (True, False):
        assert compression.payload_bytes(g, c) == JC.payload_bytes(
            jax.tree.map(jnp.asarray, g), c)


@pytest.mark.parametrize("step", [0, 1, 17])
def test_data_streams_give_the_reference_batches(step):
    for port, ref in ((SyntheticLM(128256, 64, 4, seed=3),
                       JSyntheticLM(128256, 64, 4, seed=3)),
                      (ByteCorpus(os.path.join(REPO, "src"), 48, 3, seed=1),
                       JByteCorpus(os.path.join(REPO, "src"), 48, 3,
                                   seed=1))):
        got, want = port.batch(step), ref.batch(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _state_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 6, generator=g).to(torch.bfloat16),
                       "n": {"scale": torch.randn(3, 6, generator=g)}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_round_trip_retention_and_no_visible_tmp(tmp_path):
    tree = _state_tree()
    mgr = ST.CheckpointManager(str(tmp_path), keep=2)
    for s in (4, 8, 12):
        mgr.save(s, tree, {"loss": float(s)})
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_12", "step_8"]
    assert ST.latest_step(str(tmp_path)) == 12
    out = mgr.restore_latest(jax.tree.map(
        torch.zeros_like, tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert out["step"] == 12 and out["metadata"] == {"loss": 12.0}
    for a, b in zip(jax.tree.leaves(out["tree"]), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A port checkpoint loads in the reference bit for bit (bf16 as
    bfloat16), and a reference checkpoint in the port."""
    tree = _state_tree()
    ST.save_checkpoint(str(tmp_path / "port"), 5, tree)
    template_j = jax.tree.map(
        lambda t: jnp.zeros(t.shape, jnp.bfloat16 if t.dtype == torch.bfloat16
                            else jnp.dtype(str(t.dtype).split(".")[1])),
        tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    got_j, _ = JST.load_checkpoint(str(tmp_path / "port"), 5, template_j)
    for a, b in zip(jax.tree.leaves(got_j), jax.tree.leaves(tree)):
        assert str(a.dtype) == str(b.dtype).split(".")[1]
        want = (b.view(torch.int16).numpy() if b.dtype == torch.bfloat16
                else b.numpy())
        np.testing.assert_array_equal(np.asarray(a).view(want.dtype), want)
    JST.save_checkpoint(str(tmp_path / "ref"), 6, got_j)
    got_t, _ = ST.load_checkpoint(str(tmp_path / "ref"), 6, jax.tree.map(
        torch.zeros_like, tree, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    for a, b in zip(jax.tree.leaves(got_t), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_launcher_crash_and_resume(tmp_path):
    """``launch.train --device cpu``: the injected failure exits 17 after
    the last durable checkpoint, the rerun resumes from it and finishes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama3.2-1b", "--smoke", "--device", "cpu", "--steps", "12",
            "--batch", "4", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "4", "--log-every", "4"]
    r1 = subprocess.run(args + ["--fail-at-step", "9"], capture_output=True,
                        text=True, env=env, timeout=300)
    assert r1.returncode == 17, r1.stderr[-2000:]
    assert "INJECTED FAILURE at step 9" in r1.stdout
    assert "[train] arch=llama3.2-1b-smoke params=90,432" in r1.stdout
    r2 = subprocess.run(args, capture_output=True, text=True, env=env,
                        timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from step 8" in r2.stdout
    assert "done:" in r2.stdout
