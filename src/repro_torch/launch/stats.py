"""The timeline's coverage check (the port's own copy of
``check_coverage`` from ``repro/launch/stats.py``; the rest of that
module, the stats CLI with its simulator replay, waits for the port's
simulator)."""
from __future__ import annotations

from typing import List, Optional

from repro_torch.obs import dispatch_slices
from repro_torch.trace.schema import Trace


def check_coverage(trace: Trace, events: List[dict],
                   pid: Optional[int] = None) -> List[str]:
    """The timeline's coverage contract vs the trace's own summary: one
    dispatch slice a dispatch, one resolve slice a host sync. ``pid``
    selects one node's engine track group in a fleet export (and scopes
    the resolve-slice count to it); default is the single-engine
    layout."""
    problems = []
    if trace.summary is not None:
        want = sum(trace.summary["dispatch_counts"].values())
        got = len(dispatch_slices(events) if pid is None
                  else dispatch_slices(events, pid=pid))
        if got != want:
            problems.append(f"timeline has {got} dispatch slices; the "
                            f"trace summary counts {want} dispatches")
        want_syncs = trace.summary["host_syncs"]
        got_syncs = sum(1 for e in events if e["ph"] == "X"
                        and e.get("cat") == "fetch"
                        and (pid is None or e.get("pid") == pid))
        if got_syncs != want_syncs:
            problems.append(f"timeline has {got_syncs} resolve slices; the "
                            f"trace summary counts {want_syncs} host syncs")
    return problems
