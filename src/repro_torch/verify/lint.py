"""AST lint: host-synchronizing calls in scheduler/serving code.

The serving engine's whole design is that the only blocking device->host
transfer per decode round is the resolve-time fetch (the wait on a copy
the dispatch already started). A stray ``.item()``, ``.cpu()``,
``.tolist()`` or ``.synchronize()`` in ``repro_torch.serve`` or
``repro_torch.sched`` silently reintroduces a per-step sync — invisible to
unit tests, ruinous to dispatch overlap. ``lint_host_syncs`` walks the AST
of every module under the scanned directories and reports each such call
as a ``host_sync`` finding unless an allowlist entry names it. An AST
cannot tell a tensor's ``.tolist()`` from a numpy array's, so the
allowlist also names the host-side ones.

Allowlist format (one entry per line, ``#`` comments):

    serve/engine.py::ServeEngine.resolve_decode   # file::qualified-name
    serve/engine.py                               # whole file

The port's own copy of ``repro/verify/lint.py``, with PyTorch's sync calls
in place of JAX's.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable, List, Sequence, Tuple

from repro_torch.verify.hazards import Finding

# t.item(), t.cpu(), t.tolist(), torch.cuda.synchronize() / event.synchronize()
SYNC_ATTRS = ("item", "cpu", "tolist", "synchronize")
SYNC_NAMES: Tuple[str, ...] = ()             # PyTorch has no bare sync call


def load_allowlist(path) -> List[str]:
    entries: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                entries.append(line)
    return entries


class _SyncVisitor(ast.NodeVisitor):
    def __init__(self):
        self.stack: List[str] = []
        self.hits: List[Tuple[int, str, str]] = []   # (line, call, qualname)

    def _scoped(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_ClassDef = _scoped

    def visit_Call(self, node: ast.Call):
        qual = ".".join(self.stack) or "<module>"
        fn = node.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in SYNC_ATTRS:
                self.hits.append((node.lineno, f".{fn.attr}()", qual))
            elif fn.attr in SYNC_NAMES:
                self.hits.append((node.lineno, f"{fn.attr}()", qual))
        elif isinstance(fn, ast.Name) and fn.id in SYNC_NAMES:
            self.hits.append((node.lineno, f"{fn.id}()", qual))
        self.generic_visit(node)


def _allowed(rel: str, qual: str, allowlist: Sequence[str]) -> bool:
    base = os.path.basename(rel)
    for entry in allowlist:
        if "::" in entry:
            efile, equal = entry.split("::", 1)
            if equal == qual and efile in (rel, base):
                return True
        elif entry in (rel, base):
            return True
    return False


def lint_host_syncs(dirs: Iterable[str],
                    allowlist: Sequence[str] = (),
                    root: str = "") -> List[Finding]:
    """Scan every ``.py`` under ``dirs`` for host-sync calls. ``root``
    (when given) makes the reported paths relative."""
    findings: List[Finding] = []
    for d in dirs:
        for dirpath, _dirnames, filenames in sorted(os.walk(d)):
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, root) if root else path
                with open(path) as f:
                    src = f.read()
                try:
                    tree = ast.parse(src, filename=path)
                except SyntaxError as e:
                    findings.append(Finding(
                        "error", "host_sync",
                        f"cannot parse {rel}: {e}", location=rel))
                    continue
                v = _SyncVisitor()
                v.visit(tree)
                for line, call, qual in v.hits:
                    if _allowed(rel, qual, allowlist):
                        continue
                    findings.append(Finding(
                        "error", "host_sync",
                        f"host-synchronizing call {call} in {qual} — "
                        f"allowlist it explicitly if the sync is intended",
                        location=f"{rel}:{line}"))
    return findings


__all__ = ["SYNC_ATTRS", "SYNC_NAMES", "lint_host_syncs", "load_allowlist"]
