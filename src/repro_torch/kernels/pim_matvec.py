"""pim_matvec — the PIM twin: weight-streaming fused GEMV act(x @ W + b).

Replaces the TPU kernel ``repro/kernels/pim_matvec.py::pim_matvec``. The
kernel is hand-written CUDA (``csrc/pim_matvec.cu``, whose header says what
bounds it on an H100 and what its design does about that);
``ref.matvec_ref`` is its plain PyTorch version. It carries the decode
step's FC products; unlike the TPU kernel it takes any d_in and d_out.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (contiguous, dtype_code, on_cuda,
                                         stream_of)
from repro_torch.kernels.ref import matvec_ref  # noqa: F401  (plain version)

ACTIVATIONS = {"none": 0, "gelu": 1, "silu": 2}
ROWS_PER_LAUNCH = 8    # x rows whose partial sums one block keeps in registers


def pim_matvec(x: torch.Tensor, w: torch.Tensor, bias=None,
               activation: str = "none") -> torch.Tensor:
    """x: (n, d_in); w: (d_in, d_out); bias: (d_out,) or None ->
    (n, d_out) in x.dtype. Launches the CUDA kernel once per 8 rows of x
    (decode batches are at most a few slots)."""
    ts = (x, w) if bias is None else (x, w, bias)
    on_cuda(*ts)
    code = dtype_code(*ts)
    contiguous(x=x, w=w, **({} if bias is None else {"bias": bias}))
    n, d_in = x.shape
    d_out = w.shape[1]
    if w.shape != (d_in, d_out) or (bias is not None
                                    and bias.shape != (d_out,)) or n < 1:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    out = torch.empty((n, d_out), dtype=x.dtype, device=x.device)
    vec_ok = d_out % (16 // x.element_size()) == 0 and w.data_ptr() % 16 == 0
    lib = _build.load("pim_matvec")
    stream = stream_of(x)
    for r0 in range(0, n, ROWS_PER_LAUNCH):
        rows = min(ROWS_PER_LAUNCH, n - r0)
        err = lib.pim_matvec_launch(
            x[r0].data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out[r0].data_ptr(),
            rows, d_in, d_out, ACTIVATIONS[activation], code, int(vec_ok),
            stream)
        _build.check(lib, err, "pim_matvec")
        pim_matvec.launches += 1
    return out


pim_matvec.launches = 0
