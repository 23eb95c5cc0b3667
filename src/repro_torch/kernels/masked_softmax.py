"""masked_softmax — the paper's fused mask + softmax (§4.2.2), in Triton.

Replaces the TPU kernel ``repro/kernels/masked_softmax.py::masked_softmax``.
``ref.masked_softmax_ref`` is its plain PyTorch version. Masked entries
come out exactly 0, and a fully masked row all zeros (its sum is clamped at
1e-30), as on the TPU.

Why Triton and not CUDA C++: the kernel is one reduction over a row (its
max, then its sum) plus an elementwise pass, with no tensor-core work and
nothing staged beyond the row in registers -- the case where Triton's
generated code does as well as a hand-written CUDA kernel. Bound on an
H100: bytes -- the scores read once, the mask (one byte per entry, as the
TPU wrapper's int8) read once, the probabilities written once, over the
memory rate. Design: one program per row; the whole row (n padded to a
power of two) is loaded once, the max and the sum reduce in f32 from
registers, and each entry is written once.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels._checks import contiguous, on_cuda
from repro_torch.kernels.ref import NEG_INF, masked_softmax_ref  # noqa: F401  (plain version)

FLOAT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@functools.lru_cache(maxsize=None)
def _kernel():
    # triton is imported here, at the first launch: modules of the port
    # must import on machines without it
    import triton
    import triton.language as tl

    @triton.jit
    def softmax_kernel(x_ptr, m_ptr, o_ptr, n, NEG: tl.constexpr,
                       BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        inb = cols < n
        x = tl.load(x_ptr + row * n + cols, mask=inb, other=0.0
                    ).to(tl.float32)
        keep = tl.load(m_ptr + row * n + cols, mask=inb, other=0) != 0
        x = tl.where(keep, x, NEG)
        e = tl.where(keep, tl.exp(x - tl.max(x, axis=0)), 0.0)
        denom = tl.maximum(tl.sum(e, axis=0), 1e-30)
        tl.store(o_ptr + row * n + cols, (e / denom).to(o_ptr.dtype.element_ty),
                 mask=inb)

    return triton, softmax_kernel


def masked_softmax(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x: (rows, n) floating; mask: (rows, n) int8 or bool, nonzero = keep;
    both contiguous -> (rows, n) in x.dtype. Launches the Triton kernel
    once."""
    on_cuda(x, mask)
    contiguous(x=x, mask=mask)
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"masked_softmax takes floating scores, got {x.dtype}")
    if mask.dtype == torch.bool:
        mask = mask.view(torch.int8)
    if mask.dtype != torch.int8:
        raise TypeError(f"mask must be int8 or bool, got {mask.dtype}")
    if x.dim() != 2 or mask.shape != x.shape:
        raise ValueError(f"bad shapes x {tuple(x.shape)} mask "
                         f"{tuple(mask.shape)}")
    rows, n = x.shape
    out = torch.empty_like(x)
    if rows == 0 or n == 0:
        return out
    triton, kern = _kernel()
    block = triton.next_power_of_2(n)
    kern[(rows,)](x, mask, out, n, NEG=NEG_INF, BLOCK=block,
                  num_warps=4 if block <= 2048 else 8 if block <= 8192 else 16)
    masked_softmax.launches += 1
    return out


masked_softmax.launches = 0
