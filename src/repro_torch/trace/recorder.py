"""TraceRecorder: capture a served workload from ``ServeEngine``.

The port's own copy of ``repro/trace/recorder.py``: the same hooks and
events, so the port's engine records what the reference's records.

Attach at engine construction (``ServeEngine(cfg, params, scfg,
recorder=TraceRecorder())``); the engine calls the ``on_*`` hooks as
requests arrive, admission waves prefill, and decode steps sample. The
recorder is pure bookkeeping — it never forces a device sync; everything it
stores is host data the engine already had (the per-step fetch already
carries tokens, done flags and slot lengths in one transfer).

``sinks`` streams every event (header and summary included) to observers as
it is recorded — ``obs.MetricsHub`` is the canonical sink: attach
``TraceRecorder(sinks=[hub])`` and live metrics stay current step by step,
at the same zero-dispatch/zero-sync cost as recording itself.

``stream_path`` makes recording CRASH-SAFE: every line (header included) is
appended to the file and flushed as it is recorded, so a replica killed
mid-serve still leaves a loadable trace on disk — at worst the final line
is torn, which ``Trace.loads`` tolerates (warn + drop). The in-memory
events list and ``to_trace()`` are unaffected.
"""
from __future__ import annotations

import json
from typing import Iterable, List, Optional, Tuple

from repro_torch.trace.schema import SCHEMA_VERSION, Trace


class TraceRecorder:
    def __init__(self, sinks: Iterable = (), node_id: int = 0,
                 fleet: Optional[dict] = None, chaos: Optional[dict] = None,
                 stream_path=None):
        # node_id / fleet (schema v6): which replica this recorder serves
        # and the fleet shape it serves in ({"replicas": N, "routing": P});
        # a standalone serve is node 0 of no fleet. chaos (schema v7): the
        # serialized FaultPlan + recovery knobs of a chaos serve (null
        # fault-free) — the full fault schedule ships in the header so a
        # recorded chaos run replays bit-identically.
        self._engine = None
        self._header: Optional[dict] = None
        self.events: List[dict] = []
        self.sinks = list(sinks)
        self.node_id = int(node_id)
        self.fleet = dict(fleet) if fleet is not None else None
        self.chaos = dict(chaos) if chaos is not None else None
        self.stream_path = stream_path
        self._stream = None
        self._streamed_summary = False

    def _stream_line(self, ev: dict) -> None:
        if self._stream is not None:
            self._stream.write(json.dumps(ev) + "\n")
            self._stream.flush()     # crash-safe: at most one torn line

    def _emit(self, ev: dict) -> None:
        self.events.append(ev)
        self._stream_line(ev)
        for s in self.sinks:
            s.observe(ev)

    def close(self) -> None:
        """Finish the JSONL stream (writes the summary line if the engine
        is bound and it was not streamed yet)."""
        if self._stream is None:
            return
        summary = self._summary()
        if summary is not None and not self._streamed_summary:
            self._stream_line(summary)
            self._streamed_summary = True
        self._stream.close()
        self._stream = None

    # ---- engine attachment ------------------------------------------------ #
    def bind(self, engine) -> None:
        if self._engine is not None and self._engine is not engine:
            raise RuntimeError("TraceRecorder is already bound to an engine")
        self._engine = engine
        cfg, scfg = engine.cfg, engine.scfg
        self._header = {
            "type": "header", "version": SCHEMA_VERSION,
            "node_id": self.node_id, "fleet": self.fleet,
            "chaos": self.chaos,
            "arch": cfg.name, "family": cfg.family,
            "model": {
                "num_layers": cfg.num_layers, "d_model": cfg.d_model,
                "num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
                "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                "vocab_size": cfg.vocab_size,
            },
            "serve": {
                "max_slots": scfg.max_slots, "max_len": scfg.max_len,
                "prefill_chunk": scfg.prefill_chunk,
                "prefill_mode": engine.effective_prefill_mode,
                "admission": scfg.admission,
                "temperature": scfg.temperature,
                "eos_token": scfg.eos_token, "seed": scfg.seed,
                "policy": engine.effective_policy,
                "sub_batch": scfg.sub_batch,
                "pack": scfg.pack,
                "max_prefill_jobs": scfg.max_prefill_jobs,
                "decode_floor": scfg.decode_floor,
                "fuse": scfg.fuse,
                "superstep": scfg.superstep,
            },
        }
        if self.stream_path is not None and self._stream is None:
            self._stream = open(self.stream_path, "w")
        self._stream_line(self._header)
        for s in self.sinks:
            s.observe(self._header)

    # ---- engine hooks ------------------------------------------------------ #
    def on_request(self, step: int, rid: int, prompt_len: int,
                   max_new: int, arrival_offset: int = 0,
                   gid: Optional[int] = None) -> None:
        # arrival_offset (schema v5): ticks between the request's TRUE
        # open-loop arrival and the step the engine first saw it — nonzero
        # when a superstep's k inner rounds advanced the clock past the
        # arrival before the driver could inject it.
        # gid (schema v7): the request's fleet-global id — stable across a
        # failover re-prefill on another node, where the local rid changes.
        self._emit({"type": "request", "step": step, "rid": rid,
                    "prompt_len": prompt_len, "max_new": max_new,
                    "arrival_offset": arrival_offset,
                    "gid": rid if gid is None else int(gid)})

    def on_admit(self, step: int,
                 wave: List[Tuple[int, int, int]],
                 restores: Iterable[Tuple[int, int, int]] = ()) -> None:
        # restores (schema v8): [slot, rid, prefix_len] per admitted request
        # whose slot was seeded from a KV snapshot — its prefill covers only
        # [prefix_len, prompt) instead of the whole prompt.
        self._emit({"type": "admit", "step": step,
                    "wave": [list(w) for w in wave],
                    "restores": [list(r) for r in restores]})

    def on_prefill(self, step: int, *, offset: int, chunk: int, valid: int,
                   kv: int, slots: List[int], route: dict,
                   sub_batch: int = 0, overlap: bool = False,
                   packed: bool = False, segments: Optional[int] = None,
                   rows: Optional[int] = None,
                   fused: bool = False) -> None:
        # unpacked layout: one row per dispatched slot, one segment per row
        if segments is None:
            segments = len(slots)
        if rows is None:
            rows = len(slots)
        self._emit({"type": "prefill", "step": step,
                    "offset": offset, "chunk": chunk, "valid": valid,
                    "kv": kv, "slots": slots, "route": dict(route),
                    "sub_batch": sub_batch, "overlap": overlap,
                    "packed": packed, "segments": segments,
                    "rows": rows, "fused": fused})

    def on_decode(self, step: int, *, occupancy: int, slot_lens: List[int],
                  slots: List[int], tokens: List[Tuple[int, int]],
                  route: dict, overlap: bool = False, fused: bool = False,
                  superstep: int = 1, superstep_id: int = -1) -> None:
        self._emit({"type": "decode", "step": step,
                    "occupancy": occupancy, "slot_lens": slot_lens,
                    "slots": slots,
                    "tokens": [list(t) for t in tokens],
                    "route": dict(route), "overlap": overlap,
                    "fused": fused, "superstep": superstep,
                    "superstep_id": superstep_id})

    def on_complete(self, step: int, rid: int, reason: str,
                    n_generated: int) -> None:
        self._emit({"type": "complete", "step": step, "rid": rid,
                    "reason": reason, "n_generated": n_generated})

    # ---- chaos hooks (schema v7, emitted by chaos) ------------------------ #
    def on_fault(self, step: int, kind: str, phase: str, **extra) -> None:
        # phase: "begin" for instantaneous faults and window starts, "end"
        # for window ends (end events carry ``since`` = the begin tick)
        ev = {"type": "fault", "step": step, "kind": kind, "phase": phase}
        ev.update(extra)
        self._emit(ev)

    def on_recover(self, step: int, gid: int, rid: int, from_node: int,
                   crash_step: int, prefix_tokens: int,
                   reprefill_tokens: int, retry: int,
                   restored_tokens: int = 0) -> None:
        # failover landed HERE: global request ``gid`` (local rid ``rid``)
        # re-prefilled prompt+prefix after node ``from_node`` crashed.
        # restored_tokens (schema v8): tokens seeded from a KV snapshot
        # instead of re-prefilled — reprefill_tokens is only the PAID
        # suffix, so restored + reprefill = the full from-zero cost.
        self._emit({"type": "recover", "step": step, "gid": gid, "rid": rid,
                    "from_node": from_node, "crash_step": crash_step,
                    "prefix_tokens": prefix_tokens,
                    "reprefill_tokens": reprefill_tokens, "retry": retry,
                    "restored_tokens": int(restored_tokens)})

    # ---- snapshot hooks (schema v8, emitted by chaos.snapshots) ----------- #
    def on_snapshot(self, step: int, *, gid: int, rid: int, slot: int,
                    base: int, prefix_len: int, nbytes: int,
                    durable: bool = False,
                    mirror_node: Optional[int] = None) -> None:
        # this node exported the KV delta [base, prefix_len) for gid into
        # the SnapshotStore; durable = the merged record is disk-backed
        self._emit({"type": "snapshot", "step": step, "gid": gid,
                    "rid": rid, "slot": slot, "base": base,
                    "prefix_len": prefix_len, "bytes": int(nbytes),
                    "durable": bool(durable), "mirror_node": mirror_node})

    def on_restore(self, step: int, *, gid: int, rid: int, prefix_len: int,
                   nbytes: int, snapshot_step: int) -> None:
        # a snapshot landed HERE: [0, prefix_len) KV rows for gid were
        # scattered into a fresh slot; only the suffix will re-prefill
        self._emit({"type": "restore", "step": step, "gid": gid,
                    "rid": rid, "prefix_len": prefix_len,
                    "bytes": int(nbytes),
                    "snapshot_step": int(snapshot_step)})

    def on_failed(self, step: int, gid: int, reason: str,
                  retries: int) -> None:
        # terminal: the retry budget is exhausted — recorded, never dropped
        self._emit({"type": "failed", "step": step, "gid": gid,
                    "reason": reason, "retries": retries})

    def on_reject(self, step: int, gid: int, reason: str,
                  retries: int) -> None:
        # terminal admission rejection (queue_reject fault / capacity)
        self._emit({"type": "reject", "step": step, "gid": gid,
                    "reason": reason, "retries": retries})

    # ---- export ------------------------------------------------------------ #
    def _summary(self) -> Optional[dict]:
        if self._engine is None:
            return None
        e = self._engine
        return {"type": "summary",
                "dispatch_counts": dict(e.dispatch_counts),
                "host_syncs": e.host_syncs,
                "prefill_stats": dict(e.prefill_stats),
                "decode_deferrals": e.decode_deferrals,
                "superstep_tokens": e.superstep_tokens,
                "sched_stats": dict(e.scheduler.stats),
                "snapshot_stats": dict(getattr(e, "snapshot_stats", {}))}

    def to_trace(self) -> Trace:
        if self._header is None:
            raise RuntimeError("recorder was never bound to an engine")
        summary = self._summary()
        if summary is not None:
            # sinks see the summary too (idempotent for MetricsHub: the
            # latest engine counters simply replace the previous snapshot)
            for s in self.sinks:
                s.observe(summary)
        return Trace(header=dict(self._header), events=list(self.events),
                     summary=summary).validate()

    def save(self, path) -> Trace:
        tr = self.to_trace()
        tr.save(path)
        return tr
