"""Routing policies: which replica serves the next arrival (the port's
own copy of ``repro/fleet/router.py``).

A router is pure host-side bookkeeping — it reads prompts and
``ServeEngine.load_stats()`` (queue depth + slot occupancy, both plain
host state) and returns a node id. It never touches device state, so
routing adds zero dispatches and zero host syncs to any replica.

Determinism is part of the contract: every policy is a pure function of
(arrival order, prompt bytes, engine load), with ties broken by lowest
node id — the same seeded workload always routes the same way, so a
routing comparison can be held to a committed baseline.

Health-aware routing (``chaos``): every policy accepts an optional
``health`` object (``alive(node) -> bool``, ``penalty(node) -> float``).
Crashed nodes leave the ring entirely — no policy ever returns a dead
node — and degraded/slow nodes are load-penalized so LeastLoaded steers
new work away while they limp. ``health=None`` (the default) is the
fault-free fast path and reproduces the pre-chaos behaviour bit-for-bit.
"""
from __future__ import annotations

import zlib
from typing import List, Optional, Sequence

import numpy as np

ROUTING_POLICIES = ("round_robin", "least_loaded", "prefix_affinity")


def _alive_nodes(replicas: int, health) -> List[int]:
    if health is None:
        return list(range(replicas))
    alive = [n for n in range(replicas) if health.alive(n)]
    if not alive:
        raise RuntimeError("no alive replicas to route to")
    return alive


def _penalty(health, node: int) -> float:
    return 0.0 if health is None else float(health.penalty(node))


class Router:
    """Base: ``route(prompt, engines, health=None) -> node id`` in
    [0, replicas), restricted to health-alive nodes."""

    name = "base"

    def __init__(self, replicas: int):
        if replicas < 1:
            raise ValueError(f"need at least 1 replica, got {replicas}")
        self.replicas = replicas

    def route(self, prompt: np.ndarray, engines: Sequence,
              health=None) -> int:
        raise NotImplementedError


class RoundRobin(Router):
    """Arrival i -> node i mod N, independent of load and content.
    Dead nodes are skipped (the cursor advances past them), so the cycle
    degenerates to round-robin over the surviving ring."""

    name = "round_robin"

    def __init__(self, replicas: int):
        super().__init__(replicas)
        self._next = 0

    def route(self, prompt: np.ndarray, engines: Sequence,
              health=None) -> int:
        alive = _alive_nodes(self.replicas, health)
        for _ in range(self.replicas):
            node = self._next
            self._next = (self._next + 1) % self.replicas
            if node in alive:
                return node
        raise RuntimeError("no alive replicas to route to")  # unreachable


class LeastLoaded(Router):
    """argmin over alive replicas of (queued + busy slots + health
    penalty). Ties break first by fewest requests routed so far, then by
    lowest node id — fully deterministic (a pure function of engine load +
    routing history), and free of the tie-to-node-0 pathology where every
    odd-sized burst arriving at an idle fleet hands node 0 the extra
    request."""

    name = "least_loaded"

    def __init__(self, replicas: int):
        super().__init__(replicas)
        self._routed = [0] * replicas

    def route(self, prompt: np.ndarray, engines: Sequence,
              health=None) -> int:
        loads = []
        for node in _alive_nodes(self.replicas, health):
            st = engines[node].load_stats()
            loads.append((st["queued"] + st["busy"] + _penalty(health, node),
                          self._routed[node], node))
        node = min(loads)[2]
        self._routed[node] += 1
        return node


class PrefixAffinity(Router):
    """Hash the prompt's first ``prefix_len`` tokens -> node, so requests
    sharing a prefix (same system prompt) land on the same replica — the
    routing hook the ROADMAP's cross-request prefix/page reuse needs.
    ``zlib.crc32`` over the token bytes, not Python ``hash``: stable
    across processes regardless of PYTHONHASHSEED. Under faults the hash
    maps onto the sorted ring of alive nodes, so only requests whose home
    node died get rehomed (and they rehome deterministically)."""

    name = "prefix_affinity"

    def __init__(self, replicas: int, prefix_len: int = 8):
        super().__init__(replicas)
        if prefix_len < 1:
            raise ValueError(f"prefix_len must be >= 1, got {prefix_len}")
        self.prefix_len = prefix_len

    def route(self, prompt: np.ndarray, engines: Sequence,
              health=None) -> int:
        prefix = np.asarray(prompt, np.int32)[:self.prefix_len]
        h = zlib.crc32(prefix.tobytes())
        home = h % self.replicas
        if health is None or health.alive(home):
            return home
        alive = _alive_nodes(self.replicas, health)
        return alive[h % len(alive)]


def make_router(policy: str, replicas: int, *,
                prefix_len: int = 8) -> Router:
    if policy == "round_robin":
        return RoundRobin(replicas)
    if policy == "least_loaded":
        return LeastLoaded(replicas)
    if policy == "prefix_affinity":
        return PrefixAffinity(replicas, prefix_len=prefix_len)
    raise ValueError(f"unknown routing policy {policy!r}; "
                     f"choose from {ROUTING_POLICIES}")


__all__ = ["ROUTING_POLICIES", "Router", "RoundRobin", "LeastLoaded",
           "PrefixAffinity", "make_router"]
