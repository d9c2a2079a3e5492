"""Static lock-order graph over the threaded planes.

The cache, the coop ring, the staging executor and the QoS queue each
own a lock; deadlock at pod scale comes from two planes acquiring them
in opposite orders (cache→coop on the miss path vs coop→cache on the
serve path is the classic near-miss review keeps re-checking).  This
pass builds a static acquired-while-held graph:

* lock identities are ``ClassName.attr`` for ``self.attr =
  threading.Lock()/RLock()/Condition()``; a ``Condition(self.lock)``
  aliases the lock it wraps;
* an edge A→B is recorded when ``with self.B:`` nests lexically inside
  ``with self.A:``, or when a call made while holding A can (transitively,
  through same-class methods and ``self.<attr>.<method>()`` calls on
  attributes whose class is constructed in-module) acquire B;
* any cycle in the union graph is a finding.

This is intentionally an over-approximation (it ignores conditional
paths) — a cycle it reports is an ordering the code can express, which
is exactly what the review rule rejected.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional, Sequence

from tpubench_torch.analysis.core import (
    AnalysisPass,
    Finding,
    SourceFile,
    call_name,
    dotted,
    pkg_path,
)

# The threaded planes the review rounds audit for ordering, by their path
# inside the package walked (``pkg_path``).
LOCK_ORDER_FILES = (
    "pipeline/cache.py",
    "pipeline/coop.py",
    "staging/executor.py",
    "serve/qos.py",
    # Elastic membership composes over the coop broker/ring and the
    # serve admission queue — its lock must stay a leaf (listeners and
    # journal writes run OUTSIDE it).
    "dist/membership.py",
    # Storage-lifecycle storm ledger: its lock stays a leaf (backend
    # calls and flight appends run OUTSIDE it).
    "lifecycle/storm.py",
    # Replay driver: lock-free by design today; registered so any lock
    # it ever grows joins the ordering graph from day one (it composes
    # over the fake backend's fault plane and the serve planes).
    "replay/driver.py",
    # Incident drill: its ledger lock guards restore/save byte counters
    # and stays a leaf — backend reads, cache fetches and flight
    # appends all run OUTSIDE it (it composes over the admission queue,
    # the coop broker and the storm ledger, each with locks of its own).
    "workloads/drill.py",
    # Delta tracker: the shard-state lock is a leaf; CAS writes and
    # manifest uploads never run under it.
    "lifecycle/delta.py",
    # gRPC wire plane: the client conn's write/stream locks and the
    # wire fake's per-conn write lock each stay leaves — backend
    # reads, fault sleeps and session mutations all run OUTSIDE them
    # (the h2 frame loop is single-threaded per conn by design).
    "storage/grpc_wire/client.py",
    "storage/fake_grpc_wire_server.py",
    # Fleet driver: single-threaded by design — no locks today. It
    # composes over Membership (whose lock must stay a leaf) and the
    # admission queue, so any lock it ever grows joins the ordering
    # graph from day one (the replay-driver precedent).
    "fleet/driver.py",
)

_LOCK_CTORS = {"Lock", "RLock", "Condition"}


@dataclasses.dataclass
class _ClassLocks:
    name: str
    path: str
    locks: dict[str, str]            # self-attr -> lock id
    attr_types: dict[str, str]       # self-attr -> ClassName
    methods: dict[str, ast.FunctionDef]
    # lock id -> underlying primitive: plain "Lock" is non-reentrant
    # (re-acquiring while held is a guaranteed self-deadlock); "RLock"
    # and bare Condition() (RLock-backed) are re-entrant.
    kinds: dict[str, str] = dataclasses.field(default_factory=dict)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _ann_name(ann: Optional[ast.AST]) -> str:
    """'ChunkCache' from ``cache: ChunkCache`` / ``Optional[ChunkCache]``."""
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Subscript):  # Optional[X] / "X | None" forms
        return _ann_name(ann.slice)
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip('"')
    return ""


def _collect_class(cls: ast.ClassDef, path: str) -> _ClassLocks:
    locks: dict[str, str] = {}
    attr_types: dict[str, str] = {}
    pending_alias: dict[str, str] = {}
    # Components usually arrive as annotated __init__ params
    # (``cache: ChunkCache``) stored onto self — type self-attrs from
    # those so cross-plane call edges resolve.
    param_types: dict[str, str] = {}
    init = next(
        (n for n in cls.body
         if isinstance(n, ast.FunctionDef) and n.name == "__init__"),
        None,
    )
    if init is not None:
        args = init.args
        for a in list(args.args) + list(args.kwonlyargs):
            t = _ann_name(a.annotation)
            if t and t[0].isupper():
                param_types[a.arg] = t
    kinds: dict[str, str] = {}
    for node in ast.walk(cls):
        if isinstance(node, ast.AnnAssign):
            attr = _self_attr(node.target)
            t = _ann_name(node.annotation)
            if attr and t and t[0].isupper():
                attr_types[attr] = t
            continue
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        attr = _self_attr(node.targets[0])
        if attr is None:
            continue
        if isinstance(node.value, ast.Name) and \
                node.value.id in param_types:
            attr_types[attr] = param_types[node.value.id]
            continue
        if not isinstance(node.value, ast.Call):
            continue
        ctor = call_name(node.value).rsplit(".", 1)[-1]
        if ctor in _LOCK_CTORS:
            arg_attr = None
            if node.value.args:
                arg_attr = _self_attr(node.value.args[0])
            if ctor == "Condition" and arg_attr is not None:
                pending_alias[attr] = arg_attr  # shares the wrapped lock
            else:
                lock_id = f"{cls.name}.{attr}"
                locks[attr] = lock_id
                # Bare Condition() is RLock-backed → re-entrant.
                kinds[lock_id] = "RLock" if ctor == "Condition" else ctor
        elif ctor and ctor[0].isupper():
            attr_types[attr] = ctor
    for attr, target in pending_alias.items():
        # The alias shares the wrapped lock's id AND its reentrancy.
        locks[attr] = locks.get(target, f"{cls.name}.{target}")
    methods = {
        n.name: n for n in cls.body
        if isinstance(n, ast.FunctionDef)
    }
    return _ClassLocks(cls.name, path, locks, attr_types, methods, kinds)


@dataclasses.dataclass
class LockGraph:
    edges: dict[str, set[str]]
    sites: dict[tuple[str, str], tuple[str, int]]  # edge -> first site
    # lock id -> underlying primitive ("Lock"/"RLock")
    kinds: dict[str, str] = dataclasses.field(default_factory=dict)
    # re-acquire of a non-reentrant Lock while held: (lock, path, line)
    self_deadlocks: list[tuple[str, str, int]] = dataclasses.field(
        default_factory=list
    )

    def add(self, a: str, b: str, path: str, line: int) -> None:
        if a == b:
            # RLock (and bare-Condition) re-acquire is legal; a plain
            # Lock re-acquired while held deadlocks unconditionally.
            if self.kinds.get(a, "Lock") == "Lock" and not any(
                s[0] == a for s in self.self_deadlocks
            ):
                self.self_deadlocks.append((a, path, line))
            return
        self.edges.setdefault(a, set()).add(b)
        self.sites.setdefault((a, b), (path, line))


def build_lock_graph(files: Sequence[SourceFile]) -> LockGraph:
    classes: dict[str, _ClassLocks] = {}
    for sf in files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = _collect_class(node, sf.path)

    graph = LockGraph(edges={}, sites={})
    for cl in classes.values():
        graph.kinds.update(cl.kinds)
    # (class, method) -> set of lock ids it may acquire, transitively.
    may_acquire: dict[tuple[str, str], set[str]] = {}
    # deferred: (held lock id, callee class, callee method, path, line)
    deferred: list[tuple[str, str, str, str, int]] = []

    def walk(cl: _ClassLocks, method: ast.FunctionDef,
             acquires: set[str], path: str) -> None:
        def rec(node: ast.AST, held: list[str]) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in node.items:
                    # Calls inside the context expression run before
                    # THIS item's acquire but AFTER earlier items' —
                    # visit them under the accumulating inner set.
                    rec(item.context_expr, inner)
                    attr = _self_attr(item.context_expr)
                    lock = cl.locks.get(attr) if attr else None
                    if lock:
                        acquires.add(lock)
                        for h in inner:
                            graph.add(h, lock, path, node.lineno)
                        inner.append(lock)
                for stmt in node.body:
                    rec(stmt, inner)
                return
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                callee: Optional[tuple[str, str]] = None
                if d.startswith("self.") and d.count(".") == 1:
                    callee = (cl.name, d.split(".", 1)[1])
                elif d.startswith("self.") and d.count(".") == 2:
                    _, attr, meth = d.split(".")
                    target_cls = cl.attr_types.get(attr)
                    if target_cls:
                        callee = (target_cls, meth)
                if callee and held:
                    for h in held:
                        deferred.append(
                            (h, callee[0], callee[1], path, node.lineno)
                        )
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # Nested defs (worker closures) run on other threads
                # with an empty held-set of their own.
                for child in ast.iter_child_nodes(node):
                    rec(child, [])
                return
            for child in ast.iter_child_nodes(node):
                rec(child, held)

        for child in ast.iter_child_nodes(method):
            rec(child, [])

    for cl in classes.values():
        for mname, m in cl.methods.items():
            acq: set[str] = set()
            walk(cl, m, acq, cl.path)
            may_acquire[(cl.name, mname)] = acq

    # Transitive closure of may_acquire through same-program calls.
    call_edges: dict[tuple[str, str], set[tuple[str, str]]] = {}
    for cl in classes.values():
        for mname, m in cl.methods.items():
            outs: set[tuple[str, str]] = set()
            for n in ast.walk(m):
                if isinstance(n, ast.Call):
                    d = dotted(n.func)
                    if d.startswith("self.") and d.count(".") == 1:
                        outs.add((cl.name, d.split(".", 1)[1]))
                    elif d.startswith("self.") and d.count(".") == 2:
                        _, attr, meth = d.split(".")
                        t = cl.attr_types.get(attr)
                        if t:
                            outs.add((t, meth))
            call_edges[(cl.name, mname)] = outs
    changed = True
    while changed:
        changed = False
        for key, outs in call_edges.items():
            acc = may_acquire.setdefault(key, set())
            for callee in outs:
                extra = may_acquire.get(callee, set())
                if not extra <= acc:
                    acc |= extra
                    changed = True

    for held, ccls, cmeth, path, line in deferred:
        for lock in may_acquire.get((ccls, cmeth), set()):
            graph.add(held, lock, path, line)
    return graph


def find_cycles(graph: LockGraph) -> list[list[str]]:
    """Every elementary cycle reachable by DFS (deduped by rotation)."""
    cycles: list[list[str]] = []
    seen: set[tuple[str, ...]] = set()

    def dfs(node: str, path: list[str], on_path: set[str]) -> None:
        for nxt in sorted(graph.edges.get(node, ())):
            if nxt in on_path:
                cyc = path[path.index(nxt):] + [nxt]
                core = cyc[:-1]
                rot = min(
                    tuple(core[i:] + core[:i]) for i in range(len(core))
                )
                if rot not in seen:
                    seen.add(rot)
                    cycles.append(cyc)
            elif len(path) < 32:
                dfs(nxt, path + [nxt], on_path | {nxt})

    for start in sorted(graph.edges):
        dfs(start, [start], {start})
    return cycles


def _lock_order_pass(files: Sequence[SourceFile]) -> list[Finding]:
    scoped = [sf for sf in files if pkg_path(sf.path) in LOCK_ORDER_FILES]
    if not scoped:
        return []
    graph = build_lock_graph(scoped)
    out: list[Finding] = []
    for lock, path, line in graph.self_deadlocks:
        out.append(Finding(
            "lock-order", path, line, lock,
            f"self-deadlock:{lock}",
            f"non-reentrant {lock} re-acquired while already held "
            "(possibly through a callee) — a plain threading.Lock "
            "deadlocks here unconditionally",
        ))
    for cyc in find_cycles(graph):
        path, line = graph.sites.get(
            (cyc[0], cyc[1]), (scoped[0].path, 0)
        )
        out.append(Finding(
            "lock-order", path, line, cyc[0],
            "cycle:" + ">".join(cyc[:-1]),
            "lock-order cycle (deadlock expressible): "
            + " -> ".join(cyc),
        ))
    return out


LOCK_ORDER_PASS = AnalysisPass(
    pass_id="lock-order",
    doc="static acquired-while-held graph over cache/coop/staging/qos "
        "locks rejects ordering cycles",
    run=_lock_order_pass,
)
