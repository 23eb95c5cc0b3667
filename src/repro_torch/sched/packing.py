"""Prefill packing planner: lay an admission wave out in PACKED chunk rows.

The port's own copy of ``repro/sched/packing.py`` (pure numpy; the port
imports nothing of the reference package).

The unpacked layout (``ServeEngine.build_prefill_job``) gives every admitted
slot its own row in a fixed (max_slots, chunk) dispatch grid and pads each
row to the wave's longest prompt, so a mixed wave dispatches mostly-empty
grids — the per-dispatch valid-token fraction the paper's Fig. 10 occupancy
assumes is lost exactly on the workloads PIM serving targets (many short
summarization prompts).

``plan_packed_job`` instead treats a dispatch as up to ``max_slots`` *lanes*
of ``chunk`` columns — decoupled from the slot grid, since every token
carries its true (slot, position) target — and first-fit-decreasing packs
the wave's prompt segments into as few lanes as possible:

  * a prompt longer than one chunk is cut at chunk boundaries, one lane per
    piece, lanes in order. Pieces with ``start > 0`` are *continuation*
    segments: they attend their slot's cache prefix through the per-lane
    (row_slot, prefix_len) gather, so a lane carries at most one (reserved
    segment id 0). Consecutive pieces may share a DISPATCH: the K/V scatter
    precedes the prefix gather inside one packed dispatch, so a later lane
    reads the K/V an earlier lane of the same dispatch just wrote — pieces
    only need non-decreasing dispatch order, which lane order gives for
    free. A 2-chunk prompt therefore prefills in ONE dispatch.
  * a prompt that fits a single chunk is a *whole* segment (ids 1..):
    self-contained — its entire attended context travels in the row — so it
    rides any lane with enough free columns, including the remainder of a
    continuation tail's lane ("several short prompts, or the tail of one
    job plus short prompts, per row").

Lanes then split into dispatches of at most ``max_slots`` rows, each
materialized at exactly the rows it carries — a wave of short prompts runs
as one small dense grid instead of ceil(S_max/C) sparse (max_slots, C)
grids: fewer dispatches AND a near-1 valid fraction.

Every token keeps its true (slot, global position) in ``seg_slot`` /
``seg_pos``; the kernel's segment mask (same id + causal by position) makes
the packing numerically invisible — packed and unpacked serves emit
identical greedy tokens, only the dispatch schedule (and its valid-token
fraction) differs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class _Segment:
    slot: int
    req: object
    start: int                # first prefill position this piece covers
    tokens: np.ndarray        # (length,) int32
    last: bool                # final piece of its prompt

    @property
    def length(self) -> int:
        return len(self.tokens)


@dataclass
class _Row:
    segments: List[_Segment] = field(default_factory=list)

    @property
    def used(self) -> int:
        return sum(s.length for s in self.segments)


@dataclass
class PackedDispatch:
    """One packed (R, C) prefill dispatch, fully materialized on the host.
    R = the lanes the plan actually uses (<= max_slots) — packed grids
    shrink to the rows they carry instead of computing max_slots rows."""
    tokens: np.ndarray        # (R, C) int32
    seg_slot: np.ndarray      # (R, C) int32 — target cache row per token
    seg_pos: np.ndarray       # (R, C) int32 — global prompt position
    seg_ids: np.ndarray       # (R, C) int32 — within-row segment id (-1 pad)
    valid: np.ndarray         # (R, C) bool
    row_slot: np.ndarray      # (R,) int32 — continuation prefix cache row
    prefix_len: np.ndarray    # (R,) int32 — true prefix extent per lane
    prefix_span: int          # static padded prefix slice (chunk multiple)
    rows: int                 # lanes carrying at least one segment (<= R)
    segments: int             # segments carried
    completes: List[Tuple[int, object]] = field(default_factory=list)

    @property
    def n_valid(self) -> int:
        return int(self.valid.sum())

    @property
    def token_slots(self) -> int:
        """Computed token cells (padded grid) — the valid-fraction
        denominator, the packed analogue of the unpacked B*C."""
        return int(self.valid.size)


@dataclass
class PackedPrefillJob:
    """An in-flight PACKED prefill sub-batch (duck-typed to ``PrefillJob``:
    the schedulers only touch done / next_valid_count / take_completed and
    hand it back to ``dispatch_prefill_chunk``)."""
    wave: List[Tuple[int, object]]
    dispatches: List[PackedDispatch]
    chunk: int
    sub_batch: int
    next_chunk: int = 0
    _completed_upto: int = 0

    @property
    def n_chunks(self) -> int:
        return len(self.dispatches)

    @property
    def done(self) -> bool:
        return self.next_chunk >= len(self.dispatches)

    def next_valid_count(self) -> int:
        if self.done:
            return 0
        return self.dispatches[self.next_chunk].n_valid

    def take_completed(self) -> List[Tuple[int, object]]:
        """(slot, req) pairs whose prompts finished in dispatches issued
        since the last call — packed jobs arm slots for generation as soon
        as their last segment is cached, not when the whole wave is."""
        out: List[Tuple[int, object]] = []
        while self._completed_upto < self.next_chunk:
            out.extend(self.dispatches[self._completed_upto].completes)
            self._completed_upto += 1
        return out


def plan_packed_job(wave: List[Tuple[int, object]], *, max_slots: int,
                    chunk: int, sub_batch: int,
                    segregate: bool = True) -> Optional[PackedPrefillJob]:
    """First-fit-decreasing pack of a wave's prefill tokens into chunk rows.

    Returns None when the wave has no cache tokens to write (all
    single-token prompts) — mirroring ``build_prefill_job``'s contract.
    Invariants (property-tested): every prompt's prefill span is covered
    exactly once at its true positions; no lane exceeds C columns; at most
    one continuation segment per lane; a prompt's pieces land in
    non-decreasing dispatches in piece order; each dispatch carries at most
    ``max_slots`` lanes; no (slot, position) cache cell is written by more
    than one token of one dispatch.

    ``segregate`` (default on) stable-sorts the lanes so rows WITHOUT a
    continuation prefix come first: a dispatch's ``prefix_span`` is the max
    prefix over its rows, and every row attends (masked) over the whole
    [prefix ; chunk] span, so mixing one continuation tail with short
    prompts makes the shorts pay prefix_span KV reads of pure masked-out
    attention. Segregated, short-prompt-only dispatches run at span 0 and
    only continuation dispatches pay the gather. The sort is stable and
    orders no-prefix rows ahead of prefix rows, so a prompt's pieces keep
    their non-decreasing dispatch order (piece 0 has no prefix and can only
    move earlier; pieces 1..n all have prefixes and keep relative order) —
    and the dispatch count (ceil(lanes / max_slots)) is unchanged. When
    every lane still fits one dispatch nothing changes at all.
    """
    B, C = max_slots, chunk
    items = []                          # (body_len, slot, req, [pieces])
    zero_prefill: List[Tuple[int, object]] = []
    for slot, req in wave:
        p = np.asarray(req.prompt, np.int32)[:-1]
        # a restored request (KV snapshot failover) already holds positions
        # [0, prefill_start) in its slot's cache — only the suffix prefills;
        # its first piece is then a continuation segment over that prefix
        base = int(getattr(req, "prefill_start", 0) or 0)
        body = p[base:]
        if len(body) == 0:
            zero_prefill.append((slot, req))
            continue
        pieces = [_Segment(slot=slot, req=req, start=base + c * C,
                           tokens=body[c * C:(c + 1) * C], last=False)
                  for c in range(-(-len(body) // C))]
        pieces[-1].last = True
        items.append((len(body), slot, req, pieces))
    if not items:
        return None

    # decreasing total length; slot breaks ties so the plan is deterministic
    items.sort(key=lambda t: (-t[0], t[1]))

    rows: List[_Row] = []               # global lane list, dispatch-ordered

    # pass 1 — multi-piece prompts: one fresh lane per piece, lanes in piece
    # order (lane order => non-decreasing dispatch order, so a later piece's
    # prefix gather sees the earlier piece's K/V — already cached, or
    # scattered earlier in the SAME dispatch). Full pieces fill their lane;
    # the tail lane keeps free columns for pass 2.
    shorts: List[_Segment] = []
    for _len, _slot, _req, pieces in items:
        # a single-piece body that starts past 0 (restored prefix) is a
        # continuation segment: it must own its lane's (row_slot,
        # prefix_len) gather, so it can't first-fit into shared lanes
        if len(pieces) == 1 and pieces[0].start == 0:
            shorts.append(pieces[0])
            continue
        for seg in pieces:
            rows.append(_Row(segments=[seg]))

    # pass 2 — whole (single-piece) prompts, longest first: first fit into
    # any lane with room (self-contained segments have no ordering or
    # prefix constraint), else open a new lane
    for seg in shorts:
        for row in rows:
            if row.used + seg.length <= C:
                row.segments.append(seg)
                break
        else:
            rows.append(_Row(segments=[seg]))

    # per-lane prefix spans: segregate continuation lanes behind plain ones
    # so span-free dispatches stop paying the prefix gather (see docstring)
    if segregate:
        rows.sort(key=lambda row: any(s.start > 0 for s in row.segments))

    # materialize: lanes split into dispatches of at most B rows, each grid
    # exactly the rows it carries
    out: List[PackedDispatch] = []
    last_piece_dispatch: dict = {}      # id(req) -> dispatch of last piece
    for d_idx in range(0, len(rows), B):
        d_rows = rows[d_idx:d_idx + B]
        R = len(d_rows)
        tokens = np.zeros((R, C), np.int32)
        seg_slot = np.zeros((R, C), np.int32)
        seg_pos = np.zeros((R, C), np.int32)
        seg_ids = np.full((R, C), -1, np.int32)
        valid = np.zeros((R, C), bool)
        row_slot = np.zeros((R,), np.int32)
        prefix_len = np.zeros((R,), np.int32)
        n_segments = 0
        for lane, row in enumerate(d_rows):
            col = 0
            next_id = 1
            for seg in row.segments:
                if seg.start > 0:
                    assert prefix_len[lane] == 0, \
                        "planner packed two continuations into one lane"
                    sid = 0
                    row_slot[lane] = seg.slot
                    prefix_len[lane] = seg.start
                else:
                    sid = next_id
                    next_id += 1
                sl = slice(col, col + seg.length)
                tokens[lane, sl] = seg.tokens
                seg_slot[lane, sl] = seg.slot
                seg_pos[lane, sl] = seg.start + np.arange(seg.length)
                seg_ids[lane, sl] = sid
                valid[lane, sl] = True
                col += seg.length
                n_segments += 1
                if seg.last:
                    last_piece_dispatch[(seg.slot, id(seg.req))] = \
                        (len(out), seg.slot, seg.req)
        span = int(-(-int(prefix_len.max()) // C) * C) if prefix_len.any() \
            else 0
        out.append(PackedDispatch(
            tokens=tokens, seg_slot=seg_slot, seg_pos=seg_pos,
            seg_ids=seg_ids, valid=valid, row_slot=row_slot,
            prefix_len=prefix_len, prefix_span=span, rows=len(d_rows),
            segments=n_segments, completes=[]))
    for d, slot, req in last_piece_dispatch.values():
        out[d].completes.append((slot, req))

    # single-token prompts have nothing to prefill: ready after the first
    # dispatch (the earliest point the job's caller arms completions)
    out[0].completes.extend(zero_prefill)
    return PackedPrefillJob(wave=list(wave), dispatches=out, chunk=C,
                            sub_batch=sub_batch)
