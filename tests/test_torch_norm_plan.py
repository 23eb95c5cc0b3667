"""The norm kernels' launch plans, on the CPU.

The forward's warp count (``kernels/layernorm.py::warps``): 16 elements a
thread of the row padded to a power of two, from 1 to 16 warps; Triton's
default 4 at llama's d 2048 and 8 at the 7B models' d 4096, the counts
that time best there on an H100 (``PERF.md``). The backward's plan
(``bwd_plan``: programs, rows a program, rows at once, warps) and a
float32 emulation of its partial column sums, summed over the programs
in the finishing kernel's fixed order, against the plain version's."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import layernorm as LN
from repro_torch.kernels import ref


@pytest.mark.parametrize("d", [1, 64, 300, 2048, 3000, 4096, 16384,
                               65536])
def test_norm_warps_hold_16_elements_a_thread(d):
    block = 1 << (d - 1).bit_length()
    w = LN.warps(d)
    assert 1 <= w <= 16 and w & (w - 1) == 0
    assert 32 * 16 * w == min(max(block, 512), 16 * 512)


def test_norm_warps_at_served_widths():
    assert (LN.warps(2048), LN.warps(4096)) == (4, 8)


@pytest.mark.parametrize("rows", [1, 7, 64, 1027, 4096, 8193])
@pytest.mark.parametrize("d", [300, 2048, 4096, 7168])
@pytest.mark.parametrize("sms", [4, 132])
@pytest.mark.parametrize("partials", [True, False])
def test_norm_bwd_plan_takes_every_row_once(rows, d, sms, partials):
    """``bwd_plan``: contiguous runs of rows, each taken by one program;
    at most 2 programs an SM where the mode has column partials, 4 where
    it has none; ROWS and the warps powers of two; a tile of about 4,096
    elements, 16 a thread."""
    programs, per, at_once, n_warps = LN.bwd_plan(rows, d, sms,
                                                  partials=partials)
    runs = [range(p * per, min((p + 1) * per, rows)) for p in range(programs)]
    assert [r for run in runs for r in run] == list(range(rows))
    assert all(len(run) > 0 for run in runs)
    assert programs <= (2 if partials else 4) * sms and per % at_once == 0
    for n in (at_once, n_warps):
        assert n >= 1 and n & (n - 1) == 0
    block = 1 << (d - 1).bit_length()
    assert at_once * block <= max(block, 4096)
    assert n_warps == max(1, min(16, at_once * block // 512))


def _bwd_emulation(x, scale, bias, dy, mode, sms):
    """The norm backward's column sums as the kernels take them, in
    float32: per program its rows ROWS at a time into ROWS running sums,
    added together at the program's end, then the partials summed over the
    programs SUM_PARTS at a time in order."""
    rows, d = x.shape
    programs, per, at_once, _ = LN.bwd_plan(rows, d, sms)
    eps = ref.NORM_EPS[mode]
    part_s = torch.zeros(programs, d)
    part_b = torch.zeros(programs, d)
    for p in range(programs):
        acc_s, acc_b = torch.zeros(at_once, d), torch.zeros(at_once, d)
        for i in range(p * per, min((p + 1) * per, rows), at_once):
            xs, gs = x[i:i + at_once], dy[i:i + at_once]
            if mode == "rmsnorm":
                xhat = xs * torch.rsqrt((xs * xs).sum(1, keepdim=True) / d
                                        + eps)
            else:
                xc = xs - xs.sum(1, keepdim=True) / d
                xhat = xc * torch.rsqrt((xc * xc).sum(1, keepdim=True) / d
                                        + eps)
            acc_s[:len(xs)] += gs * xhat
            acc_b[:len(xs)] += gs
        part_s[p], part_b[p] = acc_s.sum(0), acc_b.sum(0)
    out = []
    for part in (part_s, part_b):
        acc = torch.zeros(d)
        for i in range(0, programs, LN.SUM_PARTS):
            acc += part[i:i + LN.SUM_PARTS].sum(0)
        out.append(acc)
    return out


@pytest.mark.parametrize("mode", ["rmsnorm", "layernorm", "np_layernorm"])
@pytest.mark.parametrize("rows,d,sms", [(1027, 300, 4), (700, 64, 132),
                                        (4096, 96, 2)])
def test_norm_bwd_partials_sum_to_the_column_sums(mode, rows, d, sms):
    """The fixed-order partial sums against ``ref.norm_bwd_ref``'s column
    sums of dy * xhat (dscale) and dy (dbias), in float32."""
    g = np.random.default_rng(rows + d)
    x = torch.from_numpy(g.standard_normal((rows, d)).astype(np.float32) * 3)
    dy = torch.from_numpy(g.standard_normal((rows, d)).astype(np.float32))
    ones, zeros = torch.ones(d), torch.zeros(d)
    _, want_s, want_b = ref.norm_bwd_ref(
        x, ones if mode != "np_layernorm" else None,
        zeros if mode == "layernorm" else None, dy, mode=mode)
    got_s, got_b = _bwd_emulation(x, ones, zeros, dy, mode, sms)
    if mode != "np_layernorm":
        torch.testing.assert_close(got_s, want_s, rtol=1e-5, atol=1e-4)
    if mode == "layernorm":
        torch.testing.assert_close(got_b, want_b, rtol=1e-5, atol=1e-4)
