"""The KV-tile skip rule of the bf16 flash kernel's segmented mode, on the
CPU.

``kernels/flash_attention.py::segment_tile_visible`` is the rule the CUDA
kernel applies per (query tile, KV tile). Here, on packed layouts from the
port's own planner (``repro_torch.sched.plan_packed_job`` and
``models/attention.py::packed_segment_info``) and on hand-made ragged ones,
at the kernel's tile sizes and for several heads a KV head:

  * the rule keeps every (query, key) pair the mask allows a valid row;
  * it skips tiles on layouts with several segments a lane;
  * the plain segmented attention with the skipped tiles taken out equals
    the plain version on valid rows (exactly: a skipped key's probability
    was 0 already) and is finite on padded rows.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (KV_TILE, Q_TILE,
                                                 segment_tile_visible)
from repro_torch.models.attention import packed_segment_info
from repro_torch.sched import plan_packed_job

WAVES = {
    # the packed llama serve's prompt lengths (chip_smoke.serve_prompts)
    "serve": ([494, 555, 96, 175, 132, 448, 398, 596], 128),
    "short": ([5, 9, 12, 30, 80, 3, 64, 17], 128),
    "ragged chunk": ([80, 30, 12, 9, 3], 37),
    "long": ([700, 20, 20, 260], 64),
}


def _planned(name):
    """Every dispatch of the wave's packed plan, as the segment ids the
    packed prefill hands the kernel."""
    plens, chunk = WAVES[name]
    wave = [(i, SimpleNamespace(prompt=np.zeros(p, np.int32)))
            for i, p in enumerate(plens)]
    job = plan_packed_job(wave, max_slots=8, chunk=chunk, sub_batch=0)
    out = []
    for d in job.dispatches:
        t = [torch.from_numpy(a) for a in (d.seg_pos, d.seg_ids, d.valid,
                                           d.prefix_len)]
        out.append(packed_segment_info(*t, d.prefix_span))
    return out


def _hand_made(seed):
    """Ragged lanes: random segment lengths (a continuation id 0 after a
    random prefix, then whole prompts), padding columns, a lane of padding
    only, a prefix span off the KV tile."""
    rng = np.random.default_rng(seed)
    R, C = 4, int(rng.integers(40, 200))
    span = int(rng.integers(1, 300))
    q_pos = np.zeros((R, C), np.int32)
    q_seg = np.full((R, C), -2, np.int32)
    prefix = np.zeros(R, np.int32)
    for r in range(R - 1):                   # the last lane stays padding
        col, sid = 0, 1
        if rng.random() < 0.5:
            prefix[r] = rng.integers(1, span + 1)
            n = int(rng.integers(1, C + 1))
            q_pos[r, :n], q_seg[r, :n], col = prefix[r] + np.arange(n), 0, n
        while col < C:
            n = int(rng.integers(1, C // 2 + 2))
            if col + n > C:
                break
            q_pos[r, col:col + n], q_seg[r, col:col + n] = np.arange(n), sid
            col, sid = col + n, sid + 1
    pref_pos = np.tile(np.arange(span, dtype=np.int32), (R, 1))
    pref_seg = np.where(pref_pos < prefix[:, None], 0, -1).astype(np.int32)
    kv_pos = np.concatenate([pref_pos, q_pos], axis=1)
    kv_seg = np.concatenate([pref_seg, np.where(q_seg < 0, -1, q_seg)],
                            axis=1).astype(np.int32)
    return [torch.from_numpy(a) for a in (q_pos, q_seg, kv_pos, kv_seg)]


LAYOUTS = [(f"planned {name} {i}", info) for name in WAVES
           for i, info in enumerate(_planned(name))] \
    + [(f"hand-made {seed}", _hand_made(seed)) for seed in range(6)]


def _allowed(info):
    """(B, S, Skv): the mask's pairs for valid rows (q_seg >= 0)."""
    q_pos, q_seg, kv_pos, kv_seg = (t.long() for t in info)
    return ((q_seg[:, :, None] == kv_seg[:, None, :])
            & (q_pos[:, :, None] >= kv_pos[:, None, :])
            & (q_seg[:, :, None] >= 0))


def _runs(info, groups):
    """(B, G, S, Skv): whether the kernel runs the KV tile of key j for the
    query tile of row g * S + i (its rows are the G heads' S queries one
    after another)."""
    vis = segment_tile_visible(*info, groups=groups)
    S, Skv = info[1].shape[1], info[2].shape[1]
    rows = torch.arange(groups * S) // Q_TILE
    keys = torch.arange(Skv) // KV_TILE
    return vis[:, rows][:, :, keys].reshape(-1, groups, S, Skv)


@pytest.mark.parametrize("groups", [1, 4, 8])
@pytest.mark.parametrize("name,info", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_tile_rule_keeps_every_allowed_pair(name, info, groups):
    allowed = _allowed(info)[:, None]                  # (B, 1, S, Skv)
    runs = _runs(info, groups)
    assert not bool((allowed & ~runs).any())


@pytest.mark.parametrize("name", ["serve", "ragged chunk", "long"])
def test_tile_rule_skips_tiles_of_other_segments(name):
    """On a wave with several segments a lane, some dispatch has tiles the
    kernel need not run, at G 4 (llama3.2-1b's 32 / 8 heads)."""
    skipped = [float((~segment_tile_visible(*info, groups=4)).float().mean())
               for info in _planned(name)]
    assert max(skipped) > 0


def test_tile_rule_on_a_hand_made_layout():
    """One lane of segments 100 | 90 | 66 after a 500-key prefix, one of
    four 64-column prompts, one of padding only: the padding lane runs no
    tile, the prompt lane no prefix tile, and 64-row tiles of whole prompts
    only their own key tiles."""
    C, span = 256, 512
    q_pos = np.zeros((3, C), np.int32)
    q_seg = np.full((3, C), -2, np.int32)
    q_pos[0, :100], q_seg[0, :100] = 500 + np.arange(100), 0
    q_pos[0, 100:190], q_seg[0, 100:190] = np.arange(90), 1
    q_pos[0, 190:], q_seg[0, 190:] = np.arange(66), 2
    for s in range(4):
        q_pos[1, 64 * s:64 * (s + 1)], q_seg[1, 64 * s:64 * (s + 1)] = \
            np.arange(64), s + 1
    pref_pos = np.tile(np.arange(span, dtype=np.int32), (3, 1))
    pref_seg = np.where(pref_pos < np.array([[500], [0], [0]]), 0, -1)
    info = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            for a in (q_pos, q_seg,
                      np.concatenate([pref_pos, q_pos], 1),
                      np.concatenate([pref_seg, np.where(q_seg < 0, -1,
                                                         q_seg)], 1))]
    vis = segment_tile_visible(*info)                  # (3, 4, 12)
    assert not bool(vis[2].any())
    assert not bool(vis[1, :, :span // KV_TILE].any())
    chunk_tiles = vis[1, :, span // KV_TILE:]
    assert torch.equal(chunk_tiles, torch.eye(4, dtype=torch.bool))
    assert bool(vis[0, 0, :span // KV_TILE - 1].all())  # the prefix


def _restricted_attention(q, k, v, info, runs):
    """The plain segmented attention in f32 with the keys of tiles the
    kernel skips taken out (probability 0): scores -1e30 where masked,
    -inf where skipped, the running max starting at -1e30 as the kernel's
    does (a row that runs no tile gives 0), the row sum clamped at
    1e-30."""
    B, H, S, D = q.shape
    KH = k.shape[1]
    G = H // KH
    q_pos, q_seg, kv_pos, kv_seg = info
    mask = ((q_seg[:, :, None] == kv_seg[:, None, :])
            & (q_pos[:, :, None] >= kv_pos[:, None, :]))[:, None, None]
    qg = q.reshape(B, KH, G, S, D).float() / D ** 0.5
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float())
    s = torch.where(mask, s, torch.full_like(s, ref.NEG_INF))
    s = torch.where(runs[:, None], s, torch.full_like(s, float("-inf")))
    m = torch.clamp(s.amax(-1, keepdim=True), min=ref.NEG_INF)
    p = torch.exp(s - m)
    o = torch.einsum("bkgqc,bkcd->bkgqd", p, v.float())
    o = o / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return o.reshape(B, H, S, D)


@pytest.mark.parametrize("name,info", LAYOUTS[::3], ids=[n for n, _ in
                                                        LAYOUTS[::3]])
def test_restricted_attention_equals_the_plain_version(name, info):
    """Taking out the tiles the kernel skips changes no valid row, and
    leaves padded rows finite (G 4, D 16)."""
    rng = np.random.default_rng(0)
    B, S, Skv = info[1].shape[0], info[1].shape[1], info[2].shape[1]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, 8, S, 16), (B, 2, Skv, 16), (B, 2, Skv, 16)))
    got = _restricted_attention(q, k, v, info, _runs(info, 4))
    want = ref.segment_attention_ref(q, k, v, *info)
    assert bool(torch.isfinite(got).all())
    valid = (info[1] >= 0)[:, None, :, None].expand_as(got)
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-6, atol=1e-6)
