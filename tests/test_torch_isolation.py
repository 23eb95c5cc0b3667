"""The port stands alone: nothing in ``src/repro_torch/`` or ``chip_smoke.py``
imports jax or the reference package, its entry points refuse to run
quietly on the CPU, and the dispatch layer sends CPU tensors to the plain
versions without touching a kernel."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_segmented)
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.kernels.layernorm import layernorm, layernorm_bwd
from repro_torch.kernels.mamba_chunk import mamba_chunk
from repro_torch.kernels.masked_softmax import masked_softmax
from repro_torch.kernels.pim_matvec import pim_matvec
from repro_torch.kernels.rwkv_chunk import rwkv_chunk
from repro_torch.launch.steps import step_fn_for
from repro_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN or name.startswith("jax")


def test_importing_every_module_loads_no_jax_and_no_reference():
    modules = list(_port_modules())
    assert "repro_torch.serve.engine" in modules
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print('\\n'.join(sorted(sys.modules)))\n")
    env = {**os.environ, "PYTHONPATH": str(PORT.parent)}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    loaded = out.split()
    assert "repro_torch.serve.engine" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_the_reference(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert [n for n in names if _forbidden(n)] == []


def test_engine_without_a_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(get_arch("llama3.2-1b").reduced(), params={})


@pytest.mark.parametrize("kind,error,match", [
    pytest.param("prefill", RuntimeError, "no CUDA device", id="prefill"),
    pytest.param("decode", RuntimeError, "no CUDA device", id="decode"),
    pytest.param("train", RuntimeError, "no CUDA device", id="train"),
])
def test_step_functions_without_a_device_refuse_the_cpu(kind, error, match):
    """The prefill, serve and train steps (rwkv6-7b's too: every family
    trains) refuse the CPU unless asked for it; a kind other than train
    and prefill (the dry run's decode cells) is the serve step, as in the
    reference."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(error, match=match):
        step_fn_for(get_arch("rwkv6-7b").reduced(), kind)


def test_ops_send_cpu_tensors_to_the_plain_versions():
    g = torch.Generator().manual_seed(0)
    ops.reset_launch_counts()
    q = torch.randn(2, 4, 5, 16, generator=g)
    kv = torch.randn(2, 2, 9, 16, generator=g)
    torch.testing.assert_close(
        ops.flash_attention(q, kv, kv, q_offset=4),
        ref.flash_attention_ref(q, kv, kv, q_offset=4), rtol=0, atol=0)
    lens = torch.tensor([3, 9], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(q[:, :, 0], kv, kv, lens),
        ref.decode_attention_ref(q[:, :, 0], kv, kv, lens), rtol=0, atol=0)
    x, w = torch.randn(3, 16, generator=g), torch.randn(16, 24, generator=g)
    torch.testing.assert_close(ops.fused_matvec(x, w, activation="silu"),
                               ref.matvec_ref(x, w, None, "silu"),
                               rtol=0, atol=0)
    s = torch.randn(16, generator=g)
    torch.testing.assert_close(ops.layernorm(x, s, mode="rmsnorm"),
                               ref.norm_ref(x, s, mode="rmsnorm"),
                               rtol=0, atol=0)
    keep = torch.rand(3, 16, generator=g) < 0.5
    torch.testing.assert_close(ops.masked_softmax(x, keep),
                               ref.masked_softmax_ref(x, keep),
                               rtol=0, atol=0)
    r, wd = torch.randn(4, 5, 16, generator=g), torch.rand(4, 5, 16,
                                                             generator=g)
    torch.testing.assert_close(ops.rwkv_chunk(r, r, r, wd, s[None]),
                               ref.rwkv_chunk_ref(r, r, r, wd,
                                                  s[None].expand(4, 16)),
                               rtol=0, atol=0)
    a = torch.rand(2, 5, 16, 3, generator=g)
    torch.testing.assert_close(ops.mamba_chunk(a, a, r[:2, :, :3]),
                               ref.mamba_chunk_ref(a, a, r[:2, :, :3]),
                               rtol=0, atol=0)
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
    assert _build._libs == {}


def test_ops_refuse_a_device_without_a_path():
    """A device with neither a kernel nor a plain version raises. Meta
    (the dry run's shape inference) has a route of its own: an empty meta
    output of the kernel's shape and dtype, and no launch."""
    class Elsewhere:                    # a tensor as ``_use_kernel`` reads it
        is_cuda = False
        device = torch.device("xpu")
    with pytest.raises(ValueError, match="no kernel path"):
        ops._use_kernel(Elsewhere())
    before = ops.launch_counts()
    x = torch.empty(2, 8, dtype=torch.bfloat16, device="meta")
    y = ops.layernorm(x, torch.empty(8, device="meta"), mode="rmsnorm")
    assert y.is_meta and y.shape == x.shape and y.dtype == x.dtype
    assert ops.launch_counts() == before


@pytest.mark.parametrize("call", [
    lambda t: flash_attention(t(1, 2, 3, 16), t(1, 2, 3, 16),
                              t(1, 2, 3, 16)),
    lambda t: flash_attention_segmented(
        t(1, 2, 3, 16), t(1, 2, 3, 16), t(1, 2, 3, 16),
        [torch.zeros(1, 3, dtype=torch.int32)] * 4),
    lambda t: decode_attention(t(1, 2, 16), t(1, 2, 3, 16), t(1, 2, 3, 16),
                               torch.ones(1, dtype=torch.int32)),
    lambda t: pim_matvec(t(1, 16), t(16, 8)),
    lambda t: layernorm(t(2, 16), t(16), mode="rmsnorm"),
    lambda t: rwkv_chunk(t(2, 5, 16), t(2, 5, 16), t(2, 5, 16), t(2, 5, 16),
                         t(1, 16)),
    lambda t: masked_softmax(t(2, 16), torch.ones(2, 16, dtype=torch.bool)),
    lambda t: mamba_chunk(t(2, 5, 16, 4), t(2, 5, 16, 4), t(2, 5, 4)),
    lambda t: flash_attention_bwd(t(1, 2, 3, 16), t(1, 2, 3, 16),
                                  t(1, 2, 3, 16), t(1, 2, 3, 16), t(1, 2, 3),
                                  t(1, 2, 3, 16)),
    lambda t: layernorm_bwd(t(2, 16), t(16), None, t(2, 16), mode="rmsnorm"),
], ids=["flash_attention", "flash_attention_segmented", "decode_attention",
        "pim_matvec", "layernorm", "rwkv_chunk", "masked_softmax",
        "mamba_chunk", "flash_attention_bwd", "layernorm_bwd"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A wrapper launches its kernel or raises: given CPU tensors it
    raises before any build, and counts nothing."""
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        call(lambda *shape: torch.zeros(shape))
    assert ops.launch_counts() == {name: 0 for name in ops.KERNELS}
