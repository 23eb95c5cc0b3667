"""Workload-trace JSONL schema (versioned) + the ``Trace`` container.

The port's own copy of ``repro/trace/schema.py``: the same
``SCHEMA_VERSION``, required keys and JSONL form, byte for byte, so a
trace the port records reads like one the reference records.

A trace is one JSON object per line:

  line 1:   {"type": "header", "version": 4, "arch": ..., "family": ...,
             "model": {num_layers, d_model, num_heads, num_kv_heads,
                       head_dim, d_ff, vocab_size},
             "serve": {max_slots, max_len, prefill_chunk, prefill_mode,
                       admission, temperature, eos_token, seed,
                       policy, sub_batch, pack, max_prefill_jobs,
                       decode_floor, fuse, superstep}}
  then, in engine-timeline order, any of:
    {"type": "request",  "step", "rid", "prompt_len", "max_new"}
    {"type": "admit",    "step", "wave": [[slot, rid, prompt_len], ...]}
    {"type": "prefill",  "step", "offset", "chunk", "valid", "kv",
                         "slots": [...], "route": {phase_log_entry},
                         "sub_batch": wave ordinal, "overlap": bool,
                         "packed": bool, "segments": int, "rows": int,
                         "fused": bool}
    {"type": "decode",   "step", "occupancy", "slot_lens": [per-slot len],
                         "slots": [...], "tokens": [[rid, tok], ...],
                         "route": {phase_log_entry}, "overlap": bool,
                         "fused": bool, "superstep": int,
                         "superstep_id": int}
    {"type": "complete", "step", "rid", "reason", "n_generated"}
  last line: {"type": "summary", "dispatch_counts", "host_syncs",
              "prefill_stats"}

"prefill" and "decode" are the *schedulable* events: each lowers to one PAS
command stream (see trace/lower.py). The header carries enough model shape
to rebuild a ``ModelConfig`` for lowering without the original config module.

Version history:
  v1 — the serial wave loop only. No scheduling-policy fields.
  v2 — scheduler subsystem: header.serve gains ``policy`` (the step-
       composition policy that served the trace) and ``sub_batch``;
       ``prefill`` events carry their admission-wave ordinal (``sub_batch``)
       and an ``overlap`` flag (co-scheduled with the same step's decode);
       ``decode`` events carry ``overlap``. Loading a v1 trace upgrades it
       in place with serial-semantics defaults (policy="serial",
       sub_batch=wave order not recoverable -> 0, overlap=False), so every
       downstream consumer can rely on v2 keys.
  v3 — packed prefill + concurrent jobs: header.serve gains ``pack``,
       ``max_prefill_jobs`` and ``decode_floor``; ``prefill`` events carry
       ``packed`` (rows hold several prompts / a continuation tail),
       ``segments`` (prompt segments in the dispatch) and ``rows`` (lanes
       used). A packed event's ``offset`` is -1 (rows sit at different
       positions of different prompts); ``valid`` is the TRUE packed token
       count and ``kv`` the padded attended context (prefix span + chunk),
       so lowering scores the dispatch the engine actually ran. Loading a
       v1/v2 trace upgrades in place: packed=False, one segment per
       dispatched slot (segments=rows=len(slots)), pack=False,
       max_prefill_jobs=1, decode_floor=0.
  v4 — fused serving steps: header.serve gains ``fuse`` and ``superstep``;
       ``prefill`` and ``decode`` events carry ``fused`` (the overlapped
       step ran as ONE dispatch — the fused pair shares a step and both
       events flag it, so the replay scores them as one issue root);
       ``decode`` events carry ``superstep`` (the k of the multi-step
       dispatch that produced this step's tokens; 1 = a plain dispatch)
       and ``superstep_id`` (the superstep dispatch ordinal — the k
       per-step events one superstep expands into share it; -1 = plain).
       Loading a v1/v2/v3 trace upgrades in place: fused=False,
       superstep=1, superstep_id=-1, fuse=False, header superstep=1.
  v5 — superstep-aware trace clocks (observability): ``request`` events
       carry ``arrival_offset`` — the engine-clock ticks between the
       request's TRUE open-loop arrival and the step the engine first saw
       it. Arrivals inject only between scheduler steps, so a decode
       superstep's k inner rounds advance the clock past any arrival that
       lands mid-span; without the offset every such arrival appears
       batched at the superstep boundary and TTFT under-reports by up to
       k-1 ticks. ``summary`` gains optional ``sched_stats`` (the
       scheduler's per-step-kind tick counts: overlapped / fused /
       superstep / serialized / ...). Loading a v1-v4 trace upgrades in
       place: arrival_offset=0 (arrival == injection, the pre-v5
       semantics).
  v6 — fleet serving (``fleet``): the header gains top-level ``node_id``
       (which replica of a fleet recorded this trace; every event in one
       file belongs to one node — a fleet serve writes one trace PER
       replica, each protocol-lintable on its own) and ``fleet`` (either
       null for a standalone serve or {"replicas": N, "routing": policy}
       describing the fleet the node served in). Per-node engine clocks
       share the fleet driver's global tick, so gauges/timelines from
       different nodes of one serve merge on a common timebase. Loading a
       v1-v5 trace upgrades in place: node_id=0, fleet=None (a single-node
       serve is a one-replica fleet).
  v7 — chaos-tolerant fleet serving (``chaos``): the header gains
       ``chaos`` (null for a fault-free serve, else the serialized
       ``FaultPlan`` + recovery knobs — the full fault schedule ships in
       the trace, so a recorded chaos run replays bit-identically);
       ``request`` events gain ``gid``, the GLOBAL arrival id (rids are
       per-engine, so cross-replica exactly-once accounting needs a fleet-
       wide identity; a standalone serve records gid == rid). Four new
       event types carry the fault/recovery timeline:
         {"type": "fault",   "step", "kind", "phase", ...}   — a fault
             transition on this node (kind in node_crash / pim_degraded /
             slow_node / queue_reject; phase "start"|"end"; window ends
             carry "since" (the start fleet tick) and window parameters;
             every event also carries "fleet_step", the global tick)
         {"type": "recover", "step", "gid", "rid", "from_node",
             "crash_step", "prefix_tokens", "reprefill_tokens", "retry"}
             — this node picked up a crashed node's in-flight request:
             re-prefill of prompt + prefix_tokens generated-so-far tokens
             (reprefill_tokens = the full re-prefilled sequence length)
         {"type": "failed",  "step", "gid", "reason", "retries"} — the
             request exceeded its recovery retry budget; terminal
         {"type": "reject",  "step", "gid", "reason", "retries"} — the
             request exceeded its admission retry budget; terminal
       Loading a v1-v6 trace upgrades in place: chaos=None, gid=rid (a
       fault-free standalone serve).
  v8 — incremental KV snapshots (``chaos.snapshots``): the header's
       ``chaos`` dict gains ``snapshot_interval`` / ``snapshot_mirror`` /
       ``backoff_cap`` (recovery knobs ship in the trace so a snapshot-era
       chaos run replays bit-identically); ``admit`` events gain
       ``restores`` — [[slot, rid, prefix_len], ...] for wave members whose
       KV prefix was seeded from a snapshot instead of prefilled (empty for
       ordinary waves); ``recover`` events gain ``restored_tokens`` (prefix
       tokens restored from a durable snapshot; ``reprefill_tokens`` is now
       the tokens actually RE-PREFILLED — the paid suffix — so
       restored + reprefilled = the full recovered sequence). Two new event
       types carry the snapshot timeline:
         {"type": "snapshot", "step", "gid", "prefix_len", "bytes",
             "rid", "slot", "base", "durable", "mirror_node"} — this node
             exported the delta rows [base, prefix_len) of one slot's KV
             at fleet tick ``step``; ``durable`` marks a disk-backed store,
             ``mirror_node`` the peer replica holding a copy (null = none)
         {"type": "restore", "step", "gid", "rid", "prefix_len", "bytes",
             "snapshot_step"} — this node seeded a recovered request's slot
             with a checkpointed prefix taken at ``snapshot_step``
       ``verify.check_snapshot_provenance`` audits that every
       restored prefix is covered by durable snapshot events that
       happened-before the crash. Loading a v1-v7 trace upgrades in place:
       restores=[], restored_tokens=0 (pre-snapshot recovery re-prefilled
       everything from token zero).
"""
from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig

SCHEMA_VERSION = 8
SUPPORTED_VERSIONS = (1, 2, 3, 4, 5, 6, 7, 8)

# required keys per event type (beyond "type")
_REQUIRED: Dict[str, tuple] = {
    "header": ("version", "arch", "family", "model", "serve"),
    "request": ("step", "rid", "prompt_len", "max_new"),
    "admit": ("step", "wave"),
    "prefill": ("step", "offset", "chunk", "valid", "kv", "slots", "route"),
    "decode": ("step", "occupancy", "slot_lens", "slots", "tokens", "route"),
    "complete": ("step", "rid", "reason", "n_generated"),
    "summary": ("dispatch_counts", "host_syncs", "prefill_stats"),
    # chaos events (v7): fault transitions + failover recovery records
    "fault": ("step", "kind", "phase"),
    "recover": ("step", "gid", "rid", "from_node", "crash_step",
                "prefix_tokens", "reprefill_tokens", "retry"),
    "failed": ("step", "gid", "reason", "retries"),
    "reject": ("step", "gid", "reason", "retries"),
    # snapshot events (v8): incremental KV checkpoints + prefix restores
    "snapshot": ("step", "gid", "prefix_len", "bytes"),
    "restore": ("step", "gid", "rid", "prefix_len", "bytes",
                "snapshot_step"),
}
# additional keys required from v2 / v3 on
_REQUIRED_V2: Dict[str, tuple] = {
    "prefill": ("sub_batch", "overlap"),
    "decode": ("overlap",),
}
_REQUIRED_V3: Dict[str, tuple] = {
    "prefill": ("packed", "segments", "rows"),
}
# additional keys required from v4 on
_REQUIRED_V4: Dict[str, tuple] = {
    "prefill": ("fused",),
    "decode": ("fused", "superstep", "superstep_id"),
}
# additional keys required from v5 on
_REQUIRED_V5: Dict[str, tuple] = {
    "request": ("arrival_offset",),
}
# additional keys required from v6 on (header only: which fleet node
# recorded the trace, and the fleet shape it served in — null standalone)
_REQUIRED_V6: Dict[str, tuple] = {
    "header": ("node_id", "fleet"),
}
# additional keys required from v7 on: the serialized fault plan (null
# fault-free) and the global arrival id on every request event
_REQUIRED_V7: Dict[str, tuple] = {
    "header": ("chaos",),
    "request": ("gid",),
}
# additional keys required from v8 on: snapshot-aware admission and the
# restored/re-prefilled split on recovery records
_REQUIRED_V8: Dict[str, tuple] = {
    "admit": ("restores",),
    "recover": ("restored_tokens",),
}
_MODEL_KEYS = ("num_layers", "d_model", "num_heads", "num_kv_heads",
               "head_dim", "d_ff", "vocab_size")
_ROUTE_KEYS = ("phase", "tokens", "active", "gemv_path", "ffn_route")
# serial-semantics defaults a v1 event upgrades with
_V1_DEFAULTS: Dict[str, Dict[str, object]] = {
    "prefill": {"sub_batch": 0, "overlap": False},
    "decode": {"overlap": False},
}


class TraceSchemaError(ValueError):
    pass


def validate_event(ev: dict, version: int = SCHEMA_VERSION) -> dict:
    """Schema-validate one trace line against the given schema version;
    returns it unchanged on success."""
    if not isinstance(ev, dict) or "type" not in ev:
        raise TraceSchemaError(f"not a trace event: {ev!r}")
    t = ev["type"]
    if t not in _REQUIRED:
        raise TraceSchemaError(f"unknown event type {t!r}")
    required = _REQUIRED[t]
    if version >= 2:
        required = required + _REQUIRED_V2.get(t, ())
    if version >= 3:
        required = required + _REQUIRED_V3.get(t, ())
    if version >= 4:
        required = required + _REQUIRED_V4.get(t, ())
    if version >= 5:
        required = required + _REQUIRED_V5.get(t, ())
    if version >= 6:
        required = required + _REQUIRED_V6.get(t, ())
    if version >= 7:
        required = required + _REQUIRED_V7.get(t, ())
    if version >= 8:
        required = required + _REQUIRED_V8.get(t, ())
    missing = [k for k in required if k not in ev]
    if missing:
        raise TraceSchemaError(f"{t} event missing keys {missing}: {ev!r}")
    if t == "header":
        if ev["version"] not in SUPPORTED_VERSIONS:
            raise TraceSchemaError(
                f"unsupported trace version {ev['version']} "
                f"(supported: {SUPPORTED_VERSIONS})")
        missing = [k for k in _MODEL_KEYS if k not in ev["model"]]
        if missing:
            raise TraceSchemaError(f"header.model missing {missing}")
        if ev["version"] >= 2 and "policy" not in ev["serve"]:
            raise TraceSchemaError("v2 header.serve missing 'policy'")
        if ev["version"] >= 3 and "pack" not in ev["serve"]:
            raise TraceSchemaError("v3 header.serve missing 'pack'")
        if ev["version"] >= 4 and "fuse" not in ev["serve"]:
            raise TraceSchemaError("v4 header.serve missing 'fuse'")
    if t in ("prefill", "decode"):
        missing = [k for k in _ROUTE_KEYS if k not in ev["route"]]
        if missing:
            raise TraceSchemaError(f"{t}.route missing {missing}")
    return ev


def upgrade_event(ev: dict, version: int) -> dict:
    """Fill older-semantics defaults into a pre-current event so downstream
    consumers (lowering, replay grouping) can rely on the current keys."""
    if version >= SCHEMA_VERSION:
        return ev
    if version < 2:
        for k, v in _V1_DEFAULTS.get(ev["type"], {}).items():
            ev.setdefault(k, v)
        if ev["type"] == "header":
            ev["serve"].setdefault("policy", "serial")
            ev["serve"].setdefault("sub_batch", 0)
    if version < 3:
        if ev["type"] == "prefill":
            # pre-packing layout: one row per dispatched slot, one segment
            # per row — the counts downstream occupancy analysis relies on
            ev.setdefault("packed", False)
            ev.setdefault("segments", len(ev["slots"]))
            ev.setdefault("rows", len(ev["slots"]))
        elif ev["type"] == "header":
            ev["serve"].setdefault("pack", False)
            ev["serve"].setdefault("max_prefill_jobs", 1)
            ev["serve"].setdefault("decode_floor", 0)
    if version < 4:
        # pre-fusion semantics: every dispatch stands alone — overlapped
        # steps were two host dispatches, every decode step its own fetch
        if ev["type"] == "prefill":
            ev.setdefault("fused", False)
        elif ev["type"] == "decode":
            ev.setdefault("fused", False)
            ev.setdefault("superstep", 1)
            ev.setdefault("superstep_id", -1)
        elif ev["type"] == "header":
            ev["serve"].setdefault("fuse", False)
            ev["serve"].setdefault("superstep", 1)
    if version < 5:
        # pre-observability semantics: the recorded step IS the arrival
        # (no superstep-span sub-step offsets were tracked)
        if ev["type"] == "request":
            ev.setdefault("arrival_offset", 0)
    if version < 6:
        # pre-fleet semantics: every trace is node 0 of a standalone serve
        if ev["type"] == "header":
            ev.setdefault("node_id", 0)
            ev.setdefault("fleet", None)
    if version < 7:
        # pre-chaos semantics: fault-free serve, request identity is local
        if ev["type"] == "header":
            ev.setdefault("chaos", None)
        elif ev["type"] == "request":
            ev.setdefault("gid", ev["rid"])
    if version < 8:
        # pre-snapshot semantics: no KV prefix ever restored — every
        # recovery re-prefilled the full sequence from token zero
        if ev["type"] == "admit":
            ev.setdefault("restores", [])
        elif ev["type"] == "recover":
            ev.setdefault("restored_tokens", 0)
    return ev


def model_config_from_header(header: dict) -> ModelConfig:
    """Rebuild a lowering-sufficient ModelConfig from a trace header. Only
    the shape fields the command builders read are restored — the trace does
    not carry weights or execution knobs."""
    m = header["model"]
    return ModelConfig(
        name=header["arch"], family=header["family"],
        num_layers=m["num_layers"], d_model=m["d_model"],
        num_heads=m["num_heads"], num_kv_heads=m["num_kv_heads"],
        head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab_size=m["vocab_size"],
    )


@dataclass
class Trace:
    """A loaded (or freshly recorded) workload trace."""
    header: dict
    events: List[dict] = field(default_factory=list)
    summary: Optional[dict] = None
    # corrupt interior lines skipped by a strict=False load (0 on strict
    # loads): surfaced so partially synced traces are scored knowingly
    skipped_lines: int = 0

    @property
    def version(self) -> int:
        return self.header.get("version", SCHEMA_VERSION)

    def of_type(self, t: str) -> List[dict]:
        return [e for e in self.events if e["type"] == t]

    @property
    def schedulable(self) -> List[dict]:
        """The events that lower to command streams, in timeline order."""
        return [e for e in self.events if e["type"] in ("prefill", "decode")]

    def validate(self) -> "Trace":
        validate_event(self.header, self.version)
        for e in self.events:
            validate_event(e, self.version)
        if self.summary is not None:
            validate_event(self.summary, self.version)
        return self

    # ---- (de)serialization ------------------------------------------------ #
    def dumps(self) -> str:
        lines = [json.dumps(self.header)]
        lines += [json.dumps(e) for e in self.events]
        if self.summary is not None:
            lines.append(json.dumps(self.summary))
        return "\n".join(lines) + "\n"

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def loads(cls, text: str, *, tolerate_truncation: bool = False,
              strict: bool = True) -> "Trace":
        """Parse a JSONL trace. ``tolerate_truncation`` drops a torn FINAL
        line (a replica killed mid-write). ``strict=False`` additionally
        skips corrupt INTERIOR lines — bad JSON or schema-invalid events
        from a partially synced snapshot-era stream — with a warning each;
        the count lands in ``Trace.skipped_lines`` so consumers can report
        how much of the timeline is missing. Header problems (no header,
        duplicate header, unsupported version) stay fatal either way: a
        trace whose identity line is gone cannot be scored honestly."""
        header, events, summary = None, [], None
        version = SCHEMA_VERSION
        skipped = 0
        lines = text.splitlines()
        last_ln = max((i for i, ln in enumerate(lines, 1) if ln.strip()),
                      default=0)
        for ln, line in enumerate(lines, 1):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                if tolerate_truncation and ln == last_ln:
                    # a replica killed mid-write leaves one torn final line
                    # (the recorder streams line-buffered JSONL): drop it
                    # with a warning so the surviving prefix stays lint-able
                    warnings.warn(
                        f"trace line {ln}: dropping truncated final line "
                        f"({e})", RuntimeWarning, stacklevel=2)
                    break
                if not strict and header is not None:
                    warnings.warn(
                        f"trace line {ln}: skipping corrupt interior line "
                        f"({e})", RuntimeWarning, stacklevel=2)
                    skipped += 1
                    continue
                raise TraceSchemaError(f"line {ln}: bad JSON ({e})") from e
            if isinstance(ev, dict) and ev.get("type") == "header":
                # validate the header against its own declared version
                validate_event(ev, ev.get("version", SCHEMA_VERSION))
                if header is not None:
                    raise TraceSchemaError(f"line {ln}: duplicate header")
                version = ev["version"]
                header = upgrade_event(ev, version)
                continue
            try:
                validate_event(ev, version)
            except TraceSchemaError:
                if not strict and header is not None:
                    warnings.warn(
                        f"trace line {ln}: skipping schema-invalid line",
                        RuntimeWarning, stacklevel=2)
                    skipped += 1
                    continue
                raise
            if header is None:
                raise TraceSchemaError(
                    f"line {ln}: {ev['type']} before header")
            if summary is not None:
                raise TraceSchemaError(
                    f"line {ln}: {ev['type']} after summary "
                    f"(summary must be the last line)")
            ev = upgrade_event(ev, version)
            if ev["type"] == "summary":
                summary = ev
            else:
                events.append(ev)
        if header is None:
            raise TraceSchemaError("trace has no header line")
        return cls(header=header, events=events, summary=summary,
                   skipped_lines=skipped)

    @classmethod
    def load(cls, path, *, tolerate_truncation: bool = True,
             strict: bool = True) -> "Trace":
        # files are where crashes tear lines (the chaos recorders stream
        # line-buffered JSONL): a torn FINAL line loads as a warning +
        # drop by default; in-memory strings (loads) stay strict. Pass
        # strict=False to additionally skip corrupt INTERIOR lines
        # (counted in ``skipped_lines``).
        with open(path) as f:
            return cls.loads(f.read(),
                             tolerate_truncation=tolerate_truncation,
                             strict=strict)
