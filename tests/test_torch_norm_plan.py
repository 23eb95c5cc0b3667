"""The norm kernel's warp count (``kernels/layernorm.py::warps``), on the
CPU: 16 elements a thread of the row padded to a power of two, from 1 to
16 warps; Triton's default 4 at llama's d 2048 and 8 at the 7B models'
d 4096, the counts that time best there on an H100 (``PERF.md``)."""
import pytest

from repro_torch.kernels import layernorm as LN


@pytest.mark.parametrize("d", [1, 64, 300, 2048, 3000, 4096, 16384,
                               65536])
def test_norm_warps_hold_16_elements_a_thread(d):
    block = 1 << (d - 1).bit_length()
    w = LN.warps(d)
    assert 1 <= w <= 16 and w & (w - 1) == 0
    assert 32 * 16 * w == min(max(block, 512), 16 * 512)


def test_norm_warps_at_served_widths():
    assert (LN.warps(2048), LN.warps(4096)) == (4, 8)
