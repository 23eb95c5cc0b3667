"""Incremental KV-state snapshots: the failover layer that makes crash
recovery re-prefill only the UNCHECKPOINTED suffix (the port's own copy
of ``repro/chaos/snapshots.py``).

On the fleet clock, every ``snapshot_interval`` ticks each alive replica
exports the *delta* of its slot cache since its last snapshot
(``ServeEngine.export_kv_snapshot``: per ready slot, the new K/V rows
[base, prefix_len) plus host request metadata) into this host-side
``SnapshotStore``. The store merges deltas into one contiguous prefix per
request gid, and tracks where each record would survive a node crash:

  * in-memory only — the record conceptually lives on its OWNER's host;
    it dies with the owner (``drop_node`` deletes it) and exists so that
    delta bookkeeping works even when durability is off;
  * mirrored — ``put(..., mirror_node=peer)`` marks the record as copied
    to a peer replica chosen by the router's ring; it survives the owner's
    crash as long as the mirror is alive at crash time;
  * disk-backed — with a ``root`` directory, every merged record is
    published with ``checkpoint.store``'s atomic-write discipline
    (tmp dir -> uint8-view npz -> fsynced manifest -> rename), so a crash
    mid-save never corrupts the newest durable snapshot. On the owner's
    crash the in-memory payload is dropped and ``lookup`` lazily reloads
    from disk — the torn-save round trip is genuinely exercised, not
    mirrored around.

Rows are plain numpy arrays. numpy has no bfloat16, so a bf16 cache
leaf's rows travel as their 16-bit patterns (``np.uint16``, the same two
bytes an element) and the engine reinterprets them on import; int8 K/V and
their scales travel as they are.

On ``node_crash``, ``serve_fleet_chaos`` recovers each in-flight request
from ``lookup(gid)``: the survivor's slot is seeded with the checkpointed
prefix (``import_kv_snapshot``) and only the suffix past ``prefix_len``
re-prefills. KV rows are a pure function of the token sequence and the
params, so restored rows are byte-identical to what a from-zero re-prefill
would recompute — the reference's ``check_snapshot_provenance`` audits that
every restored prefix is covered by durable snapshot events that
happened-before the crash.
"""
from __future__ import annotations

import os
import shutil
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.store import atomic_save_arrays, load_arrays

# after the slot axis is removed from a (layers, slot, kv_heads, kv_seq,
# ...) cache leaf, the kv_seq axis — the delta concatenation axis — is 2
_SEQ_AXIS = 2

_META_KEYS = ("plen", "generated", "max_new", "last_tok", "lens", "rng")


class SnapshotStore:
    """Host-side store of one merged KV-prefix record per request gid."""

    def __init__(self, root: Optional[str] = None):
        self.root = root
        if root is not None:
            os.makedirs(root, exist_ok=True)
        # gid -> {node, prefix_len, tick, mirror_node, cache|None, path,
        #         bytes, meta}
        self.records: Dict[int, dict] = {}
        self.stats = {"puts": 0, "merged_rows": 0, "disk_writes": 0,
                      "disk_loads": 0, "dropped": 0, "bytes": 0}

    @property
    def disk_backed(self) -> bool:
        return self.root is not None

    # ---- export side ---------------------------------------------------- #
    def since(self, node: int) -> Dict[int, int]:
        """gid -> already-snapshotted prefix length for records owned by
        ``node`` — the high-water map ``export_kv_snapshot`` diffs
        against, making every export a delta."""
        return {gid: r["prefix_len"] for gid, r in self.records.items()
                if r["node"] == node}

    def put(self, node: int, entries: List[dict], *, tick: int,
            mirror_node: Optional[int] = None) -> None:
        """Merge one node's exported deltas at fleet tick ``tick``. Each
        entry's ``base`` must equal the stored high-water for its gid
        (``since`` guarantees it); rows concatenate on the kv_seq axis into
        one contiguous [0, prefix_len) prefix. Disk-backed stores publish
        the MERGED record atomically per update — the delta is what crosses
        the host boundary, the store compacts."""
        for e in entries:
            gid = int(e["gid"])
            rec = self.records.get(gid)
            have = rec["prefix_len"] if rec is not None else 0
            assert int(e["base"]) == have, \
                (f"snapshot delta for gid {gid} starts at {e['base']} but "
                 f"the store holds [0, {have})")
            rows = {k: np.asarray(v) for k, v in e["cache"].items()}
            if rec is not None and have > 0:
                if rec["cache"] is None:   # payload dropped at a crash;
                    self.lookup(gid)       # extend from the disk copy
                assert rec["cache"] is not None, \
                    f"gid {gid} delta extends a record with no payload"
                rows = {k: np.concatenate([rec["cache"][k], rows[k]],
                                          axis=_SEQ_AXIS)
                        for k in rows}
            nbytes = int(sum(a.nbytes for a in rows.values()))
            meta = {k: e[k] for k in _META_KEYS if k in e}
            path = None
            if self.root is not None:
                path = os.path.join(self.root, f"gid{gid}_t{tick}")
                atomic_save_arrays(
                    path, rows, extra={"tick": tick},
                    metadata={"gid": gid, "node": node,
                              "prefix_len": int(e["prefix_len"]),
                              "tick": tick, **_jsonable(meta)})
                self.stats["disk_writes"] += 1
                old = rec["path"] if rec is not None else None
                if old and old != path:
                    shutil.rmtree(old, ignore_errors=True)
            self.records[gid] = {
                "node": node, "prefix_len": int(e["prefix_len"]),
                "tick": tick, "mirror_node": mirror_node,
                "cache": rows, "path": path, "bytes": nbytes,
                "meta": meta,
            }
            self.stats["puts"] += 1
            self.stats["merged_rows"] += int(e["prefix_len"]) - have
            self.stats["bytes"] += int(e["bytes"])

    # ---- crash / recovery side ------------------------------------------ #
    def drop_node(self, node: int,
                  alive: Optional[Callable[[int], bool]] = None) -> None:
        """Apply a crash of ``node`` to durability: records it OWNED lose
        their in-memory payload (lazy disk reload) when disk-backed,
        survive when their mirror peer is alive, and are deleted otherwise;
        records mirrored TO it lose that mirror."""
        for gid, r in list(self.records.items()):
            if r["node"] == node:
                if r["path"] is not None:
                    r["cache"] = None      # survivors reload from disk
                elif r["mirror_node"] is not None and (
                        alive is None or alive(r["mirror_node"])):
                    pass                   # the mirror copy survives
                else:
                    del self.records[gid]
                    self.stats["dropped"] += 1
            elif r["mirror_node"] == node:
                r["mirror_node"] = None

    def lookup(self, gid: int) -> Optional[dict]:
        """Newest durable record for ``gid`` with its payload materialized
        (lazy disk reload for records whose owner crashed), or None."""
        r = self.records.get(gid)
        if r is None:
            return None
        if r["cache"] is None:
            if r["path"] is None:
                return None
            flat, _meta = load_arrays(r["path"])
            r["cache"] = {k: np.asarray(v) for k, v in flat.items()}
            self.stats["disk_loads"] += 1
        return r

    def reassign(self, gid: int, node: int) -> None:
        """A restore placed ``gid`` on a new owner: future deltas from that
        node extend this record (``since`` reports it there)."""
        r = self.records.get(gid)
        if r is not None:
            r["node"] = node

    def drop(self, gid: int) -> None:
        """Forget a gid (from-zero fallback made the record stale-by-
        construction, or the request reached a terminal state)."""
        r = self.records.pop(gid, None)
        if r is not None:
            self.stats["dropped"] += 1
            if r["path"]:
                shutil.rmtree(r["path"], ignore_errors=True)

    def summary(self) -> dict:
        return {"records": len(self.records),
                "disk_backed": self.disk_backed, **self.stats}


def _jsonable(meta: dict) -> dict:
    out = {}
    for k, v in meta.items():
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, (np.integer,)):
            v = int(v)
        out[k] = v
    return out


__all__ = ["SnapshotStore"]
