"""Serving engine of the port: phase-separated continuous batching.

Counterpart of ``repro/serve/engine.py``:

  * summarization (prefill) — admitted prompts run as whole chunks through
    ``T.prefill_chunk`` (the flash kernel), filling every slot's KV cache in
    ceil(S / chunk) calls; ``prefill_mode="sequential"`` is the reference
    path of one teacher-forced ``T.decode_step`` per prompt token;
  * generation (decode) — one ``T.decode_and_sample`` call per step across
    all slots: decode, sampling and the length / termination update stay
    on the device, and the step's only host sync is the (3, B) int32 fetch
    of (token, done, length). On the card that fetch is double-buffered:
    a ``non_blocking`` copy into a pinned host buffer plus a CUDA event at
    dispatch, synchronized in ``resolve_decode``. Nothing else in a step
    reads a device value on the host (no ``.item()``, ``.tolist()`` or
    ``bool(tensor)``), and host-to-device uploads go through pinned memory
    with ``non_blocking`` copies, so they never wait for the card;
  * every dispatch's phase and FC route lands in ``pas_log``.

Step composition belongs to a ``sched`` policy (``ServeConfig.policy``):
``serial`` prefills each admission wave to completion, ``interleaved``
and ``pim_aware`` feed one prefill chunk per step beside the resident
batch's decode (``sched/policies.py``). A slot whose prompt is still being
prefilled is resident but not ready: the decode's active mask leaves it
out, and its write cursor is parked at max_len-1.

An ``ssm`` (RWKV6) or ``hybrid`` (Jamba: Mamba, attention and MoE) stack
cannot prefill in chunks (its recurrent state is threaded token by token),
so it takes the sequential path whatever ``prefill_mode`` says, as in the
reference.

Packed prefill (``ServeConfig.pack``): a wave's prompts are first-fit-
decreasing packed into chunk lanes (several short prompts, or a long
prompt's tail plus shorts, per row; ``sched/packing.py``), and each packed
dispatch runs ``T.prefill_chunk_packed`` (the flash kernel's segmented
mode). The segment mask makes packing numerically invisible: packed and
unpacked serves give the same greedy tokens. A packed dispatch uploads its
layout arrays and adds no host sync.

Fused steps and supersteps: with ``fuse``, a co-scheduled step runs the
decode and the prefill chunk in one call (``T.fused_step``,
``dispatch_fused_step``); with ``superstep`` > 1, a pure-decode step may
run up to k decode rounds in one call (``T.decode_superstep``) and fetch
one (k, 3, B) result, copied into its own pinned buffer. Greedy tokens are
the same whatever the policy and knobs; temperature sampling draws
counter-based noise that a round with no live lane does not consume, so
fused and unfused, and superstep k and 1, sample the same tokens too.

Counters: one call of ``prefill_chunk``, ``decode_and_sample``,
``decode_superstep`` or a fused step (or, on the sequential path, of
``decode_step``) is one dispatch; ``host_syncs`` counts blocking fetches,
one per decode, superstep or fused dispatch. A ``trace.TraceRecorder`` (or
anything with its hooks) can be attached.

Chaos and snapshots (``chaos``): ``set_degraded`` forces every route the
engine records to the matrix-engine path (the numerics do not change),
``halt`` crashes the engine, ``export_recovery_state`` lists its in-flight
requests from host state. On an attention stack (every cache leaf has its
slot axis at 1 and its kv_seq axis at 3: the bf16 and int8 caches, not
SSM state) ``export_kv_snapshot`` copies the ready slots' new KV rows to
the host -- one blocking transfer an export, the draw counter included,
counted in ``export_transfers`` and, as in the reference, in
``snapshot_stats`` but not in ``host_syncs`` -- and ``add_request(
restore=...)`` queues a request whose admission scatters a checkpointed
prefix into its slot (``import_kv_snapshot``, uploaded through pinned
memory) so that only the suffix prefills. numpy has no bfloat16: a bf16
leaf's rows travel as ``np.uint16`` bit patterns.

A ``moe`` stack (attention mixers, MoE FFNs) prefills in chunks like a
dense one; each chunk's MoE layers route its whole (B, C) tokens as one
group, idle rows included, as in the reference. A ``vlm`` stack serves
like a dense one (the engine takes no patch prefix, as the reference's
takes none). An ``encdec`` stack prefills sequentially under ``serial``,
whatever the configuration asks, and its cross cache stays the zeros
``cache_defs`` gives: as in the reference, the engine encodes no frames.

Under a mesh (``sharding.axes.use_mesh``, a 'data' extent of 1) every
rank runs the same engine over the same requests: the collectives give
every rank the same bits, so the host's decisions agree. Each rank holds
its resident part of the cache (``models.params.local_defs``): under
decode layout B the positions of its sequence shard, so a rank's cache
does not snapshot. Every prefill path runs on such a shard, batched or
packed, bf16 or int8: a chunk writes the positions its rank owns and
gathers the prefix it reads (``models/attention.py``), and a decode
dispatch keeps its one host sync. The params are the caller's, cut to
the rank's part (``models.params.shard_tree``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import flatten_tree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pas import phase_log_entry
from repro_torch.models import transformer as T
from repro_torch.models.params import (init_params, local_defs,
                                       resident_axes, resolve_device)
from repro_torch.sched import (PackedPrefillJob, PrefillJob, make_scheduler,
                               plan_packed_job)
from repro_torch.sharding.axes import _current_mesh, axis_sizes


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int = 32
    generated: List[int] = field(default_factory=list)
    done: bool = False
    deferred: int = 0             # admission waves this request was passed over
    gid: Optional[int] = None     # fleet-global id
    # KV-snapshot failover: positions [0, prefill_start) are restored from
    # ``restore`` (the pending payload) at admission, not prefilled
    prefill_start: int = 0
    restore: Optional[dict] = None


@dataclass(frozen=True)
class ServeConfig:
    """Same fields and defaults as the reference's ``ServeConfig``."""
    max_slots: int = 4
    max_len: int = 256
    temperature: float = 0.0      # 0 = greedy
    eos_token: Optional[int] = None
    seed: int = 0
    prefill_chunk: int = 32       # summarization chunk (tokens per dispatch)
    prefill_mode: str = "batched"  # "batched" | "sequential" (reference)
    admission: str = "bucketed"   # "bucketed" (length-sorted) | "fifo"
    policy: str = "serial"        # "serial" | "interleaved" | "pim_aware"
    sub_batch: int = 0            # slots per interleaved wave (0 = all free)
    map_dims: Optional[Tuple[int, int]] = None  # (d_in, d_out) pim_aware routes
    double_buffer: bool = True    # async fetch of the decode result
    pack: bool = False            # packed prefill (sched/packing.py)
    max_prefill_jobs: int = 1     # prefill jobs an interleaving policy runs
    decode_floor: int = 0         # defer a decode of fewer ready slots
    fuse: bool = False            # co-scheduled decode + chunk in one call
    superstep: int = 1            # most decode rounds a pure-decode step runs
    queue_cap: int = 0            # admission-queue capacity (0 = unbounded)


# numpy's type for a cache leaf's rows on the host (a bf16 row crosses as
# its 16-bit patterns)
_HOST_DTYPE = {torch.bfloat16: np.dtype(np.uint16),
               torch.float16: np.dtype(np.float16),
               torch.float32: np.dtype(np.float32),
               torch.int8: np.dtype(np.int8)}


class AdmissionRejected(RuntimeError):
    """The admission queue is at capacity; the arrival was NOT enqueued."""


@dataclass
class PendingDecode:
    """A dispatched-but-unresolved decode step: its (3, B) fetch (on the
    device, or the pinned host buffer it is being copied into plus the
    event that marks the copy done) and the host view of its batch.
    ``overlap`` marks a decode co-scheduled with a prefill chunk,
    ``fused`` one that ran in the same call as the chunk."""
    fetch: torch.Tensor
    ready: Optional[torch.cuda.Event]
    active_np: np.ndarray
    n_tok: int
    route: dict
    overlap: bool = False
    fused: bool = False


@dataclass
class PendingSuperstep:
    """A dispatched-but-unresolved superstep: one (k, 3, B) fetch for k
    decode rounds. ``sid`` is the superstep's ordinal (the trace groups
    the k decode events it expands into by it)."""
    fetch: torch.Tensor
    ready: Optional[torch.cuda.Event]
    active_np: np.ndarray
    k: int
    route: dict
    sid: int


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params,
                 scfg: ServeConfig = ServeConfig(), recorder=None, *,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        B, L = scfg.max_slots, scfg.max_len
        mesh = _current_mesh()
        if mesh is not None and mesh.size > 1 and \
                axis_sizes(mesh).get("data", 1) > 1:
            raise ValueError("a serve under a mesh replicates its requests "
                             "over 'data': the mesh's data extent must be 1")
        self.cache = init_params(
            local_defs(T.cache_defs(cfg, B, L), mesh, resident_axes(cfg)),
            device=self.device)
        zeros = lambda: torch.zeros((B,), dtype=torch.int32,  # noqa: E731
                                    device=self.device)
        self.lens = zeros()           # device (decode input)
        self.last_tok = zeros()       # device (next decode input)
        self.gen_count = zeros()      # device (termination)
        self.max_new = zeros()        # device (termination)
        self.slot_req: List[Optional[Request]] = [None] * B
        self.slot_ready: List[bool] = [False] * B
        self.queue: List[Request] = []
        self._next_rid = 0
        # temperature sampling's draw counter (T.gumbel_noise), on the device
        self._draw = torch.zeros((), dtype=torch.int64, device=self.device)
        self._batched_ok = T.supports_batched_prefill(cfg)
        self.scheduler = make_scheduler(self.effective_policy,
                                        sub_batch=scfg.sub_batch,
                                        map_dims=scfg.map_dims,
                                        max_jobs=scfg.max_prefill_jobs,
                                        decode_floor=scfg.decode_floor)
        self.pas_log: List[dict] = []
        # a fused step counts as "fused" (neither prefill nor decode), a
        # superstep as one "decode"
        self.dispatch_counts = {"prefill": 0, "decode": 0, "fused": 0}
        self.host_syncs = 0           # blocking device->host transfers
        self.async_fetches = 0        # fetches whose copy started at dispatch
        self.decode_deferrals = 0     # decodes the decode_floor guard pushed
        self.superstep_tokens = 0     # decode rounds resolved by supersteps
        self._superstep_seq = 0       # superstep ordinal (trace)
        self.prefill_stats = {"token_slots": 0, "valid_tokens": 0,
                              "kv_cells": 0}
        # KV snapshots, as the reference counts them (read by the trace's
        # summary): ``export_syncs`` is one a leaf an entry, not in
        # host_syncs. ``export_transfers`` counts the port's blocking
        # transfers, one an export
        self.snapshot_stats = {"exports": 0, "export_bytes": 0,
                               "export_syncs": 0, "restores": 0,
                               "restored_tokens": 0, "restore_bytes": 0}
        self.export_transfers = 0
        self._snapshot_ok = self._batched_ok and all(
            leaf.dim() in (4, 5) and leaf.shape[1] == B
            and leaf.shape[3] == L for leaf in flatten_tree(
                self.cache).values())
        # chaos: a degraded engine records every route on the matrix-engine
        # path; a halted one crashed and never steps again
        self.degraded = False
        self.halted = False
        self.step_idx = 0
        self.wave_count = 0
        self.admission_rejects = 0
        # pinned host buffers for the double-buffered fetch, a pair for the
        # (3, B) decode fetch and, with supersteps, a (superstep, 3, B) pair
        # that a k-round fetch fills [:k] of (allocated here: pinning
        # memory mid-serve would stall the card)
        self._fetch_bufs = {}
        if self.device.type == "cuda" and scfg.double_buffer:
            shapes = [(3, B)] + ([(scfg.superstep, 3, B)]
                                 if scfg.superstep > 1 else [])
            self._fetch_bufs = {len(sh): [torch.empty(sh, dtype=torch.int32,
                                                      pin_memory=True)
                                          for _ in range(2)]
                                for sh in shapes}
        self._buf_i = {n: 0 for n in self._fetch_bufs}
        self.recorder = recorder
        if recorder is not None:
            recorder.bind(self)

    # ---- host -> device ---------------------------------------------------- #
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array to the engine's device without waiting for the card:
        through pinned memory and a ``non_blocking`` copy on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ---- request lifecycle ------------------------------------------------- #
    def add_request(self, prompt_tokens, max_new_tokens: int = 32,
                    arrival_step: Optional[int] = None,
                    gid: Optional[int] = None,
                    restore: Optional[dict] = None) -> int:
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if len(prompt) == 0:
            raise ValueError("empty prompt")
        if len(prompt) > self.scfg.max_len - 1:
            raise ValueError(f"prompt ({len(prompt)} tokens) exceeds "
                             f"max_len-1 ({self.scfg.max_len - 1})")
        if self.halted:
            raise RuntimeError("engine is halted (crashed node)")
        if restore is not None:
            if not self.snapshot_supported:
                raise ValueError("KV-snapshot restore needs the batched "
                                 "attention prefill path")
            P = int(restore["prefix_len"])
            if not 0 < P <= len(prompt) - 1:
                raise ValueError(f"restore prefix_len {P} outside "
                                 f"(0, {len(prompt) - 1}]")
        if 0 < self.scfg.queue_cap <= len(self.queue):
            self.admission_rejects += 1
            raise AdmissionRejected(
                f"admission queue at capacity ({self.scfg.queue_cap})")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_new_tokens, gid=gid)
        if restore is not None:
            req.prefill_start = int(restore["prefix_len"])
            req.restore = restore
        self.queue.append(req)
        if self.recorder is not None:
            offset = 0 if arrival_step is None \
                else max(self.step_idx - arrival_step, 0)
            self.recorder.on_request(self.step_idx, rid, len(prompt),
                                     max_new_tokens, arrival_offset=offset,
                                     gid=gid)
        return rid

    # ---- chaos hooks ------------------------------------------------------ #
    def set_degraded(self, flag: bool) -> None:
        """PIM-degraded mode: while set, every route the engine records
        (``pas_log``, the trace, the ``pim_aware`` gate) is the matrix-
        engine path. A routing record only: the kernels and the tokens do
        not change."""
        self.degraded = bool(flag)

    def halt(self) -> None:
        """Crash the engine: it never dispatches, completes or accepts a
        request again. Host state (and the cache) stay for post-mortem
        reads."""
        self.halted = True

    def export_recovery_state(self) -> List[dict]:
        """Every in-flight request (queued and resident), from host state:
        the prompt, the budget and the tokens generated so far."""
        out = [{"rid": r.rid, "prompt": r.prompt, "max_new": r.max_new_tokens,
                "generated": list(r.generated), "resident": False,
                "slot": None} for r in self.queue]
        for slot, r in enumerate(self.slot_req):
            if r is not None and not r.done:
                out.append({"rid": r.rid, "prompt": r.prompt,
                            "max_new": r.max_new_tokens,
                            "generated": list(r.generated),
                            "resident": True, "slot": slot})
        return sorted(out, key=lambda d: d["rid"])

    # ---- incremental KV snapshots ----------------------------------------- #
    @property
    def snapshot_supported(self) -> bool:
        """Every cache leaf is attention K/V (or an int8 scale) with its
        slot axis at 1 and its kv_seq axis at 3, on the batched prefill
        path."""
        return self._snapshot_ok

    def export_kv_snapshot(self, since: Optional[Dict[int, int]] = None
                           ) -> List[dict]:
        """The new KV rows [base, prefix_len) of every ready slot with a
        gid, ``base`` from ``since`` (gid -> prefix already held), with
        the request state a survivor needs, as the reference exports them.
        All rows and the draw counter (the ``rng`` metadata, never
        imported) cross in ONE blocking transfer, packed as bytes;
        ``prefix_len`` comes from host state."""
        if not self._snapshot_ok:
            return []
        since = since or {}
        flat = flatten_tree(self.cache)
        todo = []
        for slot, req in enumerate(self.slot_req):
            if req is None or req.done or not self.slot_ready[slot] \
                    or req.gid is None:
                continue
            P = len(req.prompt) - 1 + len(req.generated)
            base = int(since.get(req.gid, 0))
            if P > base:
                todo.append((slot, req, base, P))
        if not todo:
            return []
        parts, layout = [], []
        for slot, _req, base, P in todo:
            for key, leaf in flat.items():
                rows = leaf[:, slot, :, base:P].contiguous()
                parts.append(rows.view(torch.uint8).reshape(-1))
                layout.append((key, tuple(rows.shape), _HOST_DTYPE[
                    leaf.dtype]))
        parts.append(self._draw.reshape(1).view(torch.uint8))
        host = torch.cat(parts).cpu().numpy()
        self.export_transfers += 1
        draw = int(host[-8:].copy().view(np.int64)[0])
        entries, off = [], 0
        for i, (slot, req, base, P) in enumerate(todo):
            rows = {}
            for key, shape, dt in layout[i * len(flat):(i + 1) * len(flat)]:
                n = int(np.prod(shape)) * dt.itemsize
                rows[key] = host[off:off + n].copy().view(dt).reshape(shape)
                off += n
            nbytes = int(sum(a.nbytes for a in rows.values()))
            self.snapshot_stats["exports"] += 1
            self.snapshot_stats["export_bytes"] += nbytes
            self.snapshot_stats["export_syncs"] += len(rows)
            last = int(req.generated[-1]) if req.generated \
                else int(req.prompt[-1])
            entries.append({
                "gid": req.gid, "rid": req.rid, "slot": slot,
                "base": base, "prefix_len": P, "bytes": nbytes,
                "cache": rows, "plen": int(len(req.prompt)),
                "generated": list(req.generated),
                "max_new": req.max_new_tokens, "last_tok": last,
                "lens": P, "rng": [draw]})
        return entries

    def import_kv_snapshot(self, slot: int, snapshot: dict, *,
                           gid: Optional[int] = None,
                           rid: Optional[int] = None) -> None:
        """Write a checkpointed prefix's rows into positions
        [0, prefix_len) of ``slot``, each leaf uploaded through pinned
        memory (a bf16 leaf's uint16 rows reinterpreted). Called by
        ``admit_wave`` after its reset; prefill and decode write only
        above ``prefix_len``."""
        P = int(snapshot["prefix_len"])
        rows = snapshot["cache"]
        for key, leaf in flatten_tree(self.cache).items():
            a = np.array(rows[key])       # a writable copy for torch
            if a.dtype == np.uint16:      # bf16 bits; torch's 16-bit int
                a = a.view(np.int16)      # is signed
            leaf[:, slot, :, :P].copy_(self._upload(a).view(leaf.dtype))
        nbytes = int(snapshot.get("bytes", 0))
        self.snapshot_stats["restores"] += 1
        self.snapshot_stats["restored_tokens"] += P
        self.snapshot_stats["restore_bytes"] += nbytes
        if self.recorder is not None:
            self.recorder.on_restore(
                self.step_idx, gid=gid, rid=rid, prefix_len=P,
                nbytes=nbytes,
                snapshot_step=int(snapshot.get("snapshot_step", -1)))

    def load_stats(self) -> Dict[str, int]:
        """The router's load view, from host state only."""
        busy = sum(r is not None for r in self.slot_req)
        return {"queued": len(self.queue), "busy": busy,
                "ready": sum(self.slot_ready),
                "free": self.scfg.max_slots - busy}

    def free_slot_ids(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def ready_slot_ids(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req)
                if r is not None and self.slot_ready[i]]

    def has_ready_slots(self) -> bool:
        return bool(self.ready_slot_ids())

    @property
    def effective_prefill_mode(self) -> str:
        if self._batched_ok and self.scfg.prefill_mode == "batched":
            return "batched"
        return "sequential"

    @property
    def effective_policy(self) -> str:
        if self.scfg.policy != "serial" \
                and self.effective_prefill_mode != "batched":
            return "serial"
        return self.scfg.policy

    def _chunk_bucket(self, req: Request) -> int:
        C = self.scfg.prefill_chunk
        return -(-max(len(req.prompt) - 1, 1) // C)

    # ---- summarization (prefill) phase ------------------------------------- #
    def admit_wave(self, limit: Optional[int] = None
                   ) -> List[Tuple[int, Request]]:
        """Admit up to ``limit`` queued requests into free slots: reset their
        cache rows and budgets and mark them resident-but-not-ready.
        Bucketed admission sorts the queue stably by chunk-count bucket,
        aged by the waves a request was passed over."""
        free = self.free_slot_ids()
        if not (free and self.queue):
            return []
        if self.scfg.admission == "bucketed" and len(self.queue) > 1:
            self.queue.sort(key=lambda r: max(
                self._chunk_bucket(r) - r.deferred, 0))
        cap = len(free) if limit is None else min(limit, len(free))
        admitted: List[Tuple[int, Request]] = []
        while len(admitted) < cap and self.queue:
            admitted.append((free.pop(0), self.queue.pop(0)))
        for r in self.queue:
            r.deferred += 1
        sl = self._upload(np.array([s for s, _ in admitted], np.int64))
        # index_fill_ takes its value as a kernel argument; assigning a
        # Python scalar through an index would copy it to the card with a
        # blocking copy
        for leaves in self.cache.values():
            for leaf in leaves.values():
                leaf.index_fill_(1, sl, 0)
        # the decode step writes K/V at lens[slot] for every slot; a slot
        # mid-prefill parks its cursor at max_len-1 (never attended) so a
        # decode cannot clobber its prompt cache. The sequential path drives
        # lens itself and starts at 0.
        park = self.scfg.max_len - 1 \
            if self.effective_prefill_mode == "batched" else 0
        self.lens.index_fill_(0, sl, park)
        self.gen_count.index_fill_(0, sl, 0)
        self.max_new[sl] = self._upload(
            np.array([r.max_new_tokens for _, r in admitted], np.int32))
        for slot, req in admitted:
            self.slot_req[slot] = req
            self.slot_ready[slot] = False
        # checkpointed prefixes land after the reset, far below the parked
        # cursor; the suffix prefill's writes never touch them
        restores: List[Tuple[int, int, int]] = []
        for slot, req in admitted:
            if req.restore is not None:
                self.import_kv_snapshot(slot, req.restore, gid=req.gid,
                                        rid=req.rid)
                restores.append((slot, req.rid, req.prefill_start))
                req.restore = None
        self.wave_count += 1
        if self.recorder is not None:
            self.recorder.on_admit(
                self.step_idx,
                [(int(s), r.rid, int(len(r.prompt))) for s, r in admitted],
                restores=restores)
        return admitted

    def build_prefill_job(self, wave) -> Optional[PrefillJob]:
        """Lay a wave's prompt tokens (all but the last of each) out for
        chunked dispatch; None when there is nothing to cache. With
        ``pack=True`` the wave is first-fit-decreasing packed into chunk
        lanes (``plan_packed_job``) instead of one row per slot."""
        B, C = self.scfg.max_slots, self.scfg.prefill_chunk
        if self.scfg.pack:
            return plan_packed_job(wave, max_slots=B, chunk=C,
                                   sub_batch=self.wave_count - 1)
        S = max(len(r.prompt) - 1 for _, r in wave)
        if S == 0:
            return None
        n_chunks = -(-S // C)
        tokens = np.zeros((B, n_chunks * C), np.int32)
        valid = np.zeros((B, n_chunks * C), bool)
        for slot, req in wave:
            p = req.prompt[:-1]
            tokens[slot, :len(p)] = p
            # a restored prefix stays invalid: only the suffix prefills
            valid[slot, req.prefill_start:len(p)] = True
        if not valid.any():
            return None        # every wave member was fully restored
        return PrefillJob(wave=wave, tokens=tokens, valid=valid, chunk=C,
                          n_chunks=n_chunks, sub_batch=self.wave_count - 1)

    def _account_chunk_prefill(self, job: PrefillJob, c: int,
                               vc: np.ndarray, *, overlap: bool,
                               fused: bool) -> None:
        """Stats, PAS log and trace event of one unpacked chunk (alone or
        in a fused step)."""
        B, C = self.scfg.max_slots, job.chunk
        self.prefill_stats["token_slots"] += B * C
        self.prefill_stats["valid_tokens"] += int(vc.sum())
        self.prefill_stats["kv_cells"] += B * (c * C + C)
        entry = self._phase_entry("summarization", int(vc.sum()),
                                  len(job.wave))
        self.pas_log.append(entry)
        if self.recorder is not None:
            self.recorder.on_prefill(
                self.step_idx, offset=c * C, chunk=C,
                valid=int(vc.sum()), kv=c * C + C,
                slots=[int(s) for s, _ in job.wave if vc[s].any()],
                route=entry, sub_batch=job.sub_batch, overlap=overlap,
                fused=fused)

    def _account_packed_prefill(self, job: PackedPrefillJob, d, *,
                                overlap: bool, fused: bool) -> None:
        """Stats, PAS log and trace event of one packed dispatch. A packed
        event has no single offset (each lane sits elsewhere in its
        prompts), so the trace records offset -1 and the packing."""
        C = job.chunk
        self.prefill_stats["token_slots"] += d.token_slots
        self.prefill_stats["valid_tokens"] += d.n_valid
        self.prefill_stats["kv_cells"] += d.rows * (d.prefix_span + C)
        slots = sorted({int(s) for s in d.seg_slot[d.valid]})
        entry = self._phase_entry("summarization", d.n_valid, len(slots))
        self.pas_log.append(entry)
        if self.recorder is not None:
            self.recorder.on_prefill(
                self.step_idx, offset=-1, chunk=C, valid=d.n_valid,
                kv=d.prefix_span + C, slots=slots, route=entry,
                sub_batch=job.sub_batch, overlap=overlap, fused=fused,
                packed=True, segments=d.segments, rows=d.rows)

    def _next_chunk(self, job):
        """Advance ``job`` past its next chunk (a packed job: its next
        packed dispatch) and upload its inputs. Returns ``(run, account)``:
        ``run(cache) -> cache`` issues the chunk's model call
        (``T.prefill_chunk`` or ``T.prefill_chunk_packed``, whose grid is
        exactly the lanes the plan uses), ``account(overlap=, fused=)``
        books it; None for an unpacked chunk with no valid token."""
        cfg, params = self.cfg, self.params
        if isinstance(job, PackedPrefillJob):
            d = job.dispatches[job.next_chunk]
            job.next_chunk += 1
            layout = [self._upload(a) for a in (
                d.tokens, d.seg_slot, d.seg_pos, d.seg_ids, d.valid,
                d.row_slot, d.prefix_len)]
            return (lambda cache: T.prefill_chunk_packed(
                        cfg, params, layout[0], cache, *layout[1:],
                        prefix_span=d.prefix_span),
                    functools.partial(self._account_packed_prefill, job, d))
        c, C = job.next_chunk, job.chunk
        job.next_chunk += 1
        vc = job.valid[:, c * C:(c + 1) * C]
        if not vc.any():
            return None
        tokens = self._upload(job.tokens[:, c * C:(c + 1) * C])
        valid = self._upload(vc)
        return (lambda cache: T.prefill_chunk(cfg, params, tokens, cache,
                                              valid, offset=c * C),
                functools.partial(self._account_chunk_prefill, job, c, vc))

    def dispatch_prefill_chunk(self, job: PrefillJob, *,
                               overlap: bool = False) -> None:
        """Run the job's next chunk (or, for a packed job, its next packed
        dispatch). ``overlap=True`` marks it as co-scheduled with this
        step's decode (in the trace)."""
        chunk = self._next_chunk(job)
        if chunk is None:
            return
        run, account = chunk
        self.cache = run(self.cache)
        self.dispatch_counts["prefill"] += 1
        account(overlap=overlap, fused=False)

    def finish_prefill(self, wave) -> None:
        """A wave's prompt is cached: arm its slots for generation (the last
        prompt token is the first generation step's input)."""
        sl = self._upload(np.array([s for s, _ in wave], np.int64))
        plens = np.array([len(r.prompt) for _, r in wave], np.int32)
        self.lens[sl] = self._upload(plens - 1)
        self.last_tok[sl] = self._upload(
            np.array([r.prompt[-1] for _, r in wave], np.int32))
        for slot, _ in wave:
            self.slot_ready[slot] = True

    def prefill_wave(self, wave) -> None:
        """Serial-policy prefill: the whole wave, within the admission
        step (batched chunk loop, or the sequential reference path)."""
        if self.effective_prefill_mode == "batched":
            job = self.build_prefill_job(wave)
            if job is not None:
                while not job.done:
                    self.dispatch_prefill_chunk(job)
        else:
            self._prefill_sequential(wave)
        self.finish_prefill(wave)

    def _prefill_sequential(self, wave) -> None:
        """Reference path: teacher-forced decode steps, one dispatch per
        prompt token, each over all ``max_slots`` rows (the other rows
        feed token 0). For attention that is harmless: another slot's row
        is written at its own ``lens`` and overwritten later. A recurrent
        state is cumulative, though, so each prompt token of a wave-mate
        also advances every other slot's RWKV ``wkv`` and shift state, or
        Mamba ``conv`` and ``ssm`` state, and a prompt served beside others
        gives other tokens than served alone. MoE couples rows too: in
        every dispatch (and every decode step) all ``max_slots`` rows,
        idle ones included, compete for each expert's capacity of
        ``ceil(B * k * capacity_factor / E)`` tokens, so a row's token can
        be dropped from an expert because of what another row routed
        there. The reference does exactly this, and the port keeps it so
        that both give the same tokens."""
        B = self.scfg.max_slots
        for slot, req in wave:
            for pos, tok in enumerate(req.prompt[:-1]):
                t = np.zeros((B, 1), np.int32)
                t[slot, 0] = tok
                _logits, self.cache = T.decode_step(
                    self.cfg, self.params, self._upload(t), self.cache,
                    self.lens)
                self.lens[slot:slot + 1] += 1
                self.dispatch_counts["prefill"] += 1
                self.prefill_stats["token_slots"] += B
                self.prefill_stats["valid_tokens"] += 1
                self.prefill_stats["kv_cells"] += B * (pos + 1)
            n_valid = max(len(req.prompt) - 1, 0)
            entry = self._phase_entry("summarization", n_valid, len(wave))
            self.pas_log.append(entry)
            if self.recorder is not None and n_valid:
                self.recorder.on_prefill(
                    self.step_idx, offset=0, chunk=n_valid, valid=n_valid,
                    kv=n_valid, slots=[slot], route=entry,
                    sub_batch=self.wave_count - 1, overlap=False)

    # ---- generation phase: one decode call across ready slots -------------- #
    def _phase_entry(self, phase: str, n_tokens: int, active: int) -> dict:
        return phase_log_entry(phase, n_tokens, active,
                               self.cfg.d_model, self.cfg.d_ff,
                               force_mu=self.degraded)

    def _ready_active(self) -> Tuple[Optional[np.ndarray], int]:
        """(active mask, count) over the ready slots; (None, 0) when none
        is: the prologue of every decode dispatch."""
        ready = self.ready_slot_ids()
        if not ready:
            return None, 0
        active_np = np.zeros((self.scfg.max_slots,), bool)
        active_np[ready] = True
        return active_np, len(ready)

    def _log_generation(self, n_tok: int) -> dict:
        entry = self._phase_entry("generation", n_tok, n_tok)
        self.pas_log.append(entry)
        return entry

    def _sampling(self) -> dict:
        return dict(temperature=self.scfg.temperature,
                    eos_token=self.scfg.eos_token, max_len=self.scfg.max_len,
                    seed=self.scfg.seed)

    def _start_fetch(self, fetch: torch.Tensor):
        """Double-buffered fetch: on the card, a ``non_blocking`` copy into
        the next pinned buffer of the fetch's rank (a superstep's k rounds
        fill the first k rows of its (superstep, 3, B) buffer) and an event
        that marks it done. Returns (fetch or its host buffer, event)."""
        if not self.scfg.double_buffer:
            return fetch, None
        self.async_fetches += 1
        bufs = self._fetch_bufs.get(fetch.dim())
        if bufs is None:
            return fetch, None
        i = self._buf_i[fetch.dim()]
        self._buf_i[fetch.dim()] = i ^ 1
        buf = bufs[i][:fetch.shape[0]] if fetch.dim() == 3 else bufs[i]
        buf.copy_(fetch, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return buf, ready

    def _fetch_np(self, fetch: torch.Tensor, ready) -> np.ndarray:
        """The blocking half of the fetch: one host sync."""
        self.host_syncs += 1
        if ready is not None:
            ready.synchronize()
            return fetch.numpy().copy()
        return fetch.cpu().numpy()

    def dispatch_decode(self, *, overlap: bool = False
                        ) -> Optional[PendingDecode]:
        """Issue the decode + sample + terminate call for every ready slot
        and start the fetch's copy to the host; the blocking sync happens
        in ``resolve_decode``, after whatever the scheduler co-schedules."""
        active_np, n_tok = self._ready_active()
        if active_np is None:
            return None
        entry = self._log_generation(n_tok)
        (fetch, self.cache, self.last_tok, self.lens, self.gen_count,
         self._draw) = T.decode_and_sample(
            self.cfg, self.params, self.cache, self.last_tok, self.lens,
            self._upload(active_np), self.gen_count, self.max_new, self._draw,
            **self._sampling())
        self.dispatch_counts["decode"] += 1
        fetch, ready = self._start_fetch(fetch)
        return PendingDecode(fetch=fetch, ready=ready, active_np=active_np,
                             n_tok=n_tok, route=entry, overlap=overlap)

    def dispatch_fused_step(self, job) -> PendingDecode:
        """Issue ONE call carrying the ready slots' decode and the job's
        next prefill chunk (``T.fused_step``): one ``fused`` dispatch,
        traced as a fused prefill + decode pair. The caller guarantees a
        ready slot and a chunk with valid tokens."""
        active_np, n_tok = self._ready_active()
        if active_np is None:
            raise RuntimeError("a fused step needs a ready slot")
        dentry = self._log_generation(n_tok)
        chunk = self._next_chunk(job)
        if chunk is None:
            raise RuntimeError("a fused step got an empty prefill chunk")
        run, account = chunk
        (fetch, self.cache, self.last_tok, self.lens, self.gen_count,
         self._draw) = T.fused_step(
            self.cfg, self.params, self.cache, run, self.last_tok, self.lens,
            self._upload(active_np), self.gen_count, self.max_new, self._draw,
            **self._sampling())
        account(overlap=True, fused=True)
        self.dispatch_counts["fused"] += 1
        fetch, ready = self._start_fetch(fetch)
        return PendingDecode(fetch=fetch, ready=ready, active_np=active_np,
                             n_tok=n_tok, route=dentry, overlap=True,
                             fused=True)

    def dispatch_decode_superstep(self, k: int
                                  ) -> Optional[PendingSuperstep]:
        """Issue ONE call running k decode rounds (``T.decode_superstep``;
        finished lanes freeze on the device) and start its (k, 3, B)
        fetch: one ``decode`` dispatch, one host sync. The route is decided
        once, at dispatch, so the k decode events share it."""
        active_np, n_tok = self._ready_active()
        if active_np is None:
            return None
        entry = self._log_generation(n_tok)
        (fetch, self.cache, self.last_tok, self.lens, self.gen_count,
         self._draw) = T.decode_superstep(
            self.cfg, self.params, self.cache, self.last_tok, self.lens,
            self._upload(active_np), self.gen_count, self.max_new, self._draw,
            k=k, **self._sampling())
        self.dispatch_counts["decode"] += 1
        fetch, ready = self._start_fetch(fetch)
        sid = self._superstep_seq
        self._superstep_seq += 1
        return PendingSuperstep(fetch=fetch, ready=ready, active_np=active_np,
                                k=k, route=entry, sid=sid)

    def _finish_slot(self, i: int) -> None:
        r = self.slot_req[i]
        r.done = True
        self.slot_req[i] = None
        self.slot_ready[i] = False
        if self.recorder is not None:
            if self.scfg.eos_token is not None \
                    and r.generated[-1] == self.scfg.eos_token:
                reason = "eos"
            elif len(r.generated) >= r.max_new_tokens:
                reason = "max_new"
            else:
                reason = "cache_full"
            self.recorder.on_complete(self.step_idx, r.rid, reason,
                                      len(r.generated))

    def resolve_decode(self, pending: PendingDecode
                       ) -> List[Tuple[int, int]]:
        """Wait for the step's (token, done, len) fetch -- the step's one
        blocking host sync -- and apply it: tokens, trace, completions."""
        fetch_np = self._fetch_np(pending.fetch, pending.ready)
        toks_np, done_np, lens_np = (fetch_np[0], fetch_np[1].astype(bool),
                                     fetch_np[2])
        active_idx = np.nonzero(pending.active_np)[0]
        out = [(self.slot_req[i].rid, int(toks_np[i])) for i in active_idx]
        for i, (_rid, tok) in zip(active_idx, out):
            self.slot_req[i].generated.append(tok)
        if self.recorder is not None:
            self.recorder.on_decode(
                self.step_idx, occupancy=pending.n_tok,
                slot_lens=[int(x) for x in lens_np],
                slots=[int(i) for i in active_idx],
                tokens=list(out), route=pending.route,
                overlap=pending.overlap, fused=pending.fused)
        for i in active_idx:
            if done_np[i]:
                self._finish_slot(i)
        return out

    def resolve_decode_superstep(self, pending: PendingSuperstep
                                 ) -> List[Tuple[int, int]]:
        """Wait for a superstep's (k, 3, B) fetch -- one host sync for k
        rounds -- and expand it round by round: tokens in round order, a
        decode event per round with a live lane, completions at the round
        where a lane ended, and the engine clock one tick a round."""
        fetch_np = self._fetch_np(pending.fetch, pending.ready)
        out: List[Tuple[int, int]] = []
        active = pending.active_np.copy()
        for i in range(pending.k):
            if i:
                self.step_idx += 1     # inner rounds advance the timeline
            idx = np.nonzero(active)[0]
            if idx.size == 0:
                continue               # every lane done; the clock still ran
            toks_np, lens_np = fetch_np[i, 0], fetch_np[i, 2]
            done_np = fetch_np[i, 1].astype(bool)
            step_out = [(self.slot_req[s].rid, int(toks_np[s])) for s in idx]
            for s, (_rid, tok) in zip(idx, step_out):
                self.slot_req[s].generated.append(tok)
            self.superstep_tokens += 1
            if self.recorder is not None:
                self.recorder.on_decode(
                    self.step_idx, occupancy=int(idx.size),
                    slot_lens=[int(x) for x in lens_np],
                    slots=[int(s) for s in idx],
                    tokens=list(step_out), route=pending.route,
                    overlap=False, superstep=pending.k,
                    superstep_id=pending.sid)
            for s in idx:
                if done_np[s]:
                    self._finish_slot(s)
            active &= ~done_np
            out.extend(step_out)
        return out

    # ---- step: composition delegated to the scheduling policy --------------- #
    def step(self) -> List[Tuple[int, int]]:
        if self.halted:
            raise RuntimeError("engine is halted (crashed node); a crashed "
                               "replica must never dispatch again")
        out = self.scheduler.step(self)
        self.step_idx += 1
        return out

    def run_until_done(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        results: Dict[int, List[int]] = {}
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            for rid, tok in self.step():
                results.setdefault(rid, []).append(tok)
        return results
