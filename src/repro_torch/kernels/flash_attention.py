"""flash_attention — blocked GQA attention for the prefill stage.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
in both of its masking modes, with one hand-written CUDA source
(``csrc/flash_attention.cu``, whose header says what bounds it on an H100
and what its design does about that). It has two routes, chosen by dtype:
bf16 runs on the tensor cores (``wgmma``), float32 on the CUDA cores. Both
take both modes:

  * ``flash_attention`` — the static ``q_offset`` mode (unpacked chunked
    prefill); plain version ``ref.flash_attention_ref``;
  * ``flash_attention_segmented`` — the ``segment_info`` mode (packed
    prefill); plain version ``ref.segment_attention_ref``.

Each wrapper keeps its own launch count: one call is one launch, whichever
route. Unlike the TPU kernel, the CUDA kernel masks ragged edges itself, so
every chunk shape goes to it, including a last prefill chunk that overhangs
the cache. ``segment_tile_visible`` is the rule by which the bf16 route
skips KV tiles in the segmented mode, written on tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import dtype_code, on_cuda, stream_of
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    flash_attention_ref, segment_attention_ref)

HEAD_DIMS = (16, 32, 64, 96, 112, 128, 160)
Q_TILE = 64      # query rows a warpgroup of the bf16 route (wgmma's M)
KV_TILE = 64     # keys a KV tile of the bf16 route


def segment_tile_visible(q_pos: torch.Tensor, q_seg: torch.Tensor,
                         kv_pos: torch.Tensor, kv_seg: torch.Tensor,
                         rows: int = Q_TILE, keys: int = KV_TILE, *,
                         groups: int = 1) -> torch.Tensor:
    """Which KV tiles the bf16 route computes for each tile of query rows,
    in the segmented mode: (B, n_row_tiles, n_kv_tiles) bool.

    The kernel's rows are the ``groups`` (= H / KH) heads' S queries of a
    KV head one after another, cut into tiles of ``rows`` (64: a
    warpgroup's; a CTA of two loads the KV tiles either of them computes);
    keys into tiles of ``keys``. Only valid ids (>= 0) count: a tile of
    rows has the range of its valid segment ids and its largest valid
    position, a KV tile the range of its valid ids and its smallest valid
    position. The KV tile runs iff the two ranges meet and its smallest
    position does not exceed the rows' largest. A valid row's allowed key
    (same id, position not above its own) can only lie in a tile that
    runs, so the rule drops no pair the mask allows a valid row. ids:
    (B, S) and (B, Skv) int."""
    B, S = q_seg.shape
    big = torch.iinfo(torch.int64).max

    def tile_ranges(seg, pos, n, reps):
        seg, pos = seg.long().repeat(1, reps), pos.long().repeat(1, reps)
        pad = -seg.shape[1] % n
        seg = torch.nn.functional.pad(seg, (0, pad), value=-1)
        pos = torch.nn.functional.pad(pos, (0, pad))
        seg, pos = seg.reshape(B, -1, n), pos.reshape(B, -1, n)
        valid = seg >= 0
        lo = torch.where(valid, seg, big).amin(-1)
        hi = torch.where(valid, seg, -big).amax(-1)
        return lo, hi, valid, pos

    q_lo, q_hi, q_valid, qp = tile_ranges(q_seg, q_pos, rows, groups)
    q_pos_hi = torch.where(q_valid, qp, -big).amax(-1)
    k_lo, k_hi, k_valid, kp = tile_ranges(kv_seg, kv_pos, keys, 1)
    k_pos_lo = torch.where(k_valid, kp, big).amin(-1)
    return ((k_lo[:, None, :] <= q_hi[:, :, None])
            & (k_hi[:, None, :] >= q_lo[:, :, None])
            & (k_pos_lo[:, None, :] <= q_pos_hi[:, :, None]))


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Shapes and layout the kernel takes; returns K/V's head stride."""
    B, H, S, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, KH, Skv, D) or v.shape != k.shape or H % KH:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("kernel needs a contiguous q")
    head_stride = k.stride(1)
    for name, t in (("k", k), ("v", v)):
        if (t.stride(3) != 1 or t.stride(2) != D or t.stride(1) != head_stride
                or t.stride(0) != KH * head_stride):
            raise ValueError(f"kernel needs {name} as (B, KH, Skv, D) rows "
                             f"of a (B, KH, L, D) layout, got strides "
                             f"{t.stride()}")
    if q.dtype == torch.bfloat16 and not (
            all(t.data_ptr() % 16 == 0 for t in (q, k, v))
            and k.stride(1) % 8 == 0):
        raise ValueError("the bf16 route reads by TMA: q, k and v must "
                         "start 16-byte aligned, heads 8 elements apart")
    return head_stride


def _launch(q, k, v, ids, *, q_offset: int, causal: bool,
            lse=None) -> torch.Tensor:
    code = dtype_code(q, k, v)
    head_stride = _check_qkv(q, k, v)
    B, H, S, D = q.shape
    KH, Skv = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lib = _build.load("flash_attention")
    ptrs = [None] * 4 if ids is None else [t.data_ptr() for t in ids]
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), *ptrs, B, H, KH, S, Skv, D,
        head_stride, q_offset, int(causal), 1.0 / math.sqrt(D), code,
        stream_of(q))
    _build.check(lib, err, "flash_attention")
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    return_lse: bool = False):
    """Static mode. q: (B, H, S, D) contiguous; k, v: (B, KH, Skv, D) with
    contiguous (Skv, D) rows per head (a prefix slice of a cache is fine)
    -> (B, H, S, D) in q.dtype. ``return_lse=True`` also returns each
    row's log-sum-exp (B, H, S) f32 (natural log of the scaled scores, as
    ``ref.flash_attention_ref`` gives it), written by the same launch.
    Launches the CUDA kernel."""
    on_cuda(q, k, v)
    if causal and q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    B, H, S, _ = q.shape
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    o = _launch(q, k, v, None, q_offset=q_offset, causal=causal, lse=lse)
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


def flash_attention_segmented(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, segment_info) -> torch.Tensor:
    """Segmented mode. q, k, v as for ``flash_attention``; ``segment_info``
    = (q_pos, q_seg, kv_pos, kv_seg), contiguous int32 of shape (B, S),
    (B, S), (B, Skv), (B, Skv) on q's device. A query attends a key iff
    ``q_seg == kv_seg and q_pos >= kv_pos`` -> (B, H, S, D) in q.dtype.
    Launches the CUDA kernel."""
    ids = tuple(segment_info)
    on_cuda(q, k, v, *ids)
    B, S, Skv = q.shape[0], q.shape[2], k.shape[2]
    for name, t, n in zip(("q_pos", "q_seg", "kv_pos", "kv_seg"), ids,
                          (S, S, Skv, Skv)):
        if t.dtype != torch.int32 or t.shape != (B, n) \
                or not t.is_contiguous():
            raise ValueError(f"kernel needs {name} as contiguous int32 "
                             f"({B}, {n}), got {t.dtype} {tuple(t.shape)}")
    o = _launch(q, k, v, ids, q_offset=0, causal=False)
    flash_attention_segmented.launches += 1
    return o


flash_attention.launches = 0
flash_attention_segmented.launches = 0
