"""Ownership-lifecycle passes: flight ops and slab leases.

Two recurring review-finding classes share one shape — an object is
*acquired* (``wf.begin(...)`` → FlightOp, ``pool.lease(...)`` →
SlabLease) and must reach exactly one *close* (``finish``/``abandon``,
``release``) on every path, unless ownership escapes to a caller or a
container.  The generic engine here is deliberately lexical-CFG-lite:
it reasons about assignments, ``with`` blocks, try/except/finally
structure, returns and raises, which is exactly the granularity the
hand reviews operated at (and what three past lease-leak fixes and two
flight-op fixes needed).  Anything subtler belongs in the allowlist
with a justification, not in a cleverer analyzer.
"""

from __future__ import annotations

import ast
from typing import Sequence

from tpubench_torch.analysis.core import (
    AnalysisPass,
    Finding,
    SourceFile,
    call_name,
    dotted,
    iter_functions,
    parent_map,
    uses_name,
)


def _acquire_calls(node: ast.AST, attr: str) -> list[ast.Call]:
    """Every ``<expr>.<attr>(...)`` call under ``node``."""
    return [
        n for n in ast.walk(node)
        if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr == attr
    ]


def _closer_calls(fn: ast.AST, var: str, closers: set[str]) -> list[ast.Call]:
    return [
        n for n in ast.walk(fn)
        if isinstance(n, ast.Call)
        and isinstance(n.func, ast.Attribute)
        and n.func.attr in closers
        and isinstance(n.func.value, ast.Name)
        and n.func.value.id == var
    ]


def _escapes(fn: ast.AST, var: str, assign: ast.AST) -> bool:
    """Ownership transfer: returned/yielded, stored into an attribute,
    subscript or container, or handed to another call.  After an
    escape the close obligation belongs to the new owner."""
    for n in ast.walk(fn):
        if n is assign:
            continue
        if isinstance(n, (ast.Return, ast.Yield, ast.YieldFrom)):
            if n.value is not None and uses_name(n.value, var):
                return True
        elif isinstance(n, ast.Assign):
            if any(
                isinstance(t, (ast.Attribute, ast.Subscript))
                for t in n.targets
            ) and uses_name(n.value, var):
                return True
        elif isinstance(n, ast.Call):
            # var passed BARE as an argument (cache.put(key, lease),
            # q.put((idx, op))) transfers ownership; a derived value
            # (fill(lease.view())) does not — the lease stays ours.
            if isinstance(n.func, ast.Attribute) and isinstance(
                n.func.value, ast.Name
            ) and n.func.value.id == var:
                continue
            args = list(n.args) + [kw.value for kw in n.keywords]
            for a in args:
                if _is_bare_ref(a, var):
                    return True
    return False


def _is_bare_ref(node: ast.AST, var: str) -> bool:
    """The name itself, or a container literal holding it — NOT an
    arbitrary expression that merely mentions it."""
    if isinstance(node, ast.Name):
        return node.id == var
    if isinstance(node, ast.Starred):
        return _is_bare_ref(node.value, var)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return any(_is_bare_ref(e, var) for e in node.elts)
    if isinstance(node, ast.Dict):
        return any(v is not None and _is_bare_ref(v, var)
                   for v in list(node.keys) + list(node.values))
    return False


def _closed_on_raise(raise_node: ast.AST, fn: ast.AST,
                     parents: dict[int, ast.AST],
                     closer_ids: set[int], var: str,
                     closers: set[str]) -> bool:
    """Is the resource closed when this ``raise`` unwinds out of the
    function?  True when an enclosing ``finally`` closes it, when the
    raise sits in an except handler that already closed it, or when
    the raise is in a try body whose handlers close it."""
    node: ast.AST = raise_node
    while node is not fn:
        parent = parents.get(id(node))
        if parent is None:
            break
        if isinstance(parent, ast.Try):
            if any(
                id(c) in closer_ids
                for s in parent.finalbody for c in ast.walk(s)
            ):
                return True
            in_body = any(node is s or _contains(s, node)
                          for s in parent.body)
            if in_body and any(
                id(c) in closer_ids
                for h in parent.handlers for c in ast.walk(h)
            ):
                return True
        if isinstance(parent, ast.ExceptHandler):
            if any(id(c) in closer_ids for c in ast.walk(parent)):
                return True
        node = parent
    return False


def _contains(root: ast.AST, target: ast.AST) -> bool:
    return any(n is target for n in ast.walk(root))


def _has_unconditional_close(fn: ast.AST, parents: dict[int, ast.AST],
                             assign: ast.AST, closer_nodes: list[ast.Call],
                             var: str) -> bool:
    """Does at least one closer run on the plain fall-through path?

    A closer guarded only by ``if <var> is not None``-style tests (the
    op-may-be-None idiom) or sitting in an ``if`` whose OTHER branch
    also closes counts as unconditional; a closer reachable only under
    an unrelated condition (``if ok: op.finish(1)``) or only inside a
    loop the acquire is not in does not — that is the classic
    happy-path-only leak."""
    acquire_anc: set[int] = set()
    node: ast.AST = assign
    while node is not fn:
        node = parents.get(id(node), fn)
        acquire_anc.add(id(node))

    def branch_closes(stmts) -> bool:
        return any(
            isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
            and isinstance(c.func.value, ast.Name)
            and c.func.value.id == var
            and any(c is cn for cn in closer_nodes)
            for s in stmts for c in ast.walk(s)
        )

    for c in closer_nodes:
        node = c
        conditional = False
        while node is not fn and id(node) not in acquire_anc:
            parent = parents.get(id(node))
            if parent is None or parent is fn or \
                    id(parent) in acquire_anc:
                # Reached the region shared with the acquire: anything
                # above guards both sides equally.
                break
            if isinstance(parent, ast.If):
                guarded = uses_name(parent.test, var)
                both = (
                    branch_closes(parent.body)
                    and parent.orelse and branch_closes(parent.orelse)
                )
                if not guarded and not both:
                    conditional = True
                    break
            elif isinstance(parent, (ast.For, ast.While, ast.AsyncFor)) \
                    and id(parent) not in acquire_anc:
                # A close only inside a loop the acquire is outside of
                # may run zero times.
                conditional = True
                break
            elif isinstance(parent, ast.ExceptHandler):
                # A close only in an error handler never runs on the
                # fall-through path.
                conditional = True
                break
            node = parent
        if not conditional:
            return True
    return False


def ownership_findings(
    sf: SourceFile, *, pass_id: str, acquire_attr: str,
    closers: set[str], code_prefix: str, what: str,
) -> list[Finding]:
    out: list[Finding] = []
    # Every finding below starts at an acquire call inside the function
    # it names: a file, or a function, without one has nothing to check.
    if not _acquire_calls(sf.tree, acquire_attr):
        return out
    for qual, fn in iter_functions(sf.tree):
        if not _acquire_calls(fn, acquire_attr):
            continue
        parents = parent_map(fn)
        # Nested defs are visited in their own iter_functions pass —
        # skip acquire sites that belong to an inner function, or every
        # finding would double-report under both qualnames.
        def _owned_here(node: ast.AST) -> bool:
            p = parents.get(id(node))
            while p is not None and p is not fn:
                if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    return False
                p = parents.get(id(p))
            return True

        # `with ...begin(...) [as x]` closes via __exit__: compliant.
        with_calls: set[int] = set()
        for n in ast.walk(fn):
            if isinstance(n, (ast.With, ast.AsyncWith)):
                for item in n.items:
                    for c in _acquire_calls(item.context_expr, acquire_attr):
                        with_calls.add(id(c))

        # Every form that binds the acquire to a name: plain assign,
        # annotated assign, walrus — an annotation must not hide a
        # leak from the gate.
        bindings: list[tuple[str, ast.AST, ast.AST]] = []
        claimed: set[int] = set()
        for n in ast.walk(fn):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 and \
                    isinstance(n.targets[0], ast.Name):
                bindings.append((n.targets[0].id, n, n.value))
            elif isinstance(n, ast.AnnAssign) and \
                    isinstance(n.target, ast.Name) and n.value is not None:
                bindings.append((n.target.id, n, n.value))
            elif isinstance(n, ast.NamedExpr) and \
                    isinstance(n.target, ast.Name):
                bindings.append((n.target.id, n, n.value))
        for _var, _node, value in bindings:
            for c in _acquire_calls(value, acquire_attr):
                claimed.add(id(c))

        for var, stmt, value in bindings:
            if _owned_here(stmt):
                calls = [
                    c for c in _acquire_calls(value, acquire_attr)
                    if id(c) not in with_calls
                ]
                if not calls:
                    continue
                closer_nodes = _closer_calls(fn, var, closers)
                if not closer_nodes and not _escapes(fn, var, stmt):
                    out.append(Finding(
                        pass_id, sf.path, stmt.lineno, qual,
                        f"{code_prefix}-leak:{var}",
                        f"{what} `{var}` acquired via .{acquire_attr}() "
                        f"but never reaches {'/'.join(sorted(closers))} "
                        f"and never escapes this function",
                    ))
                    continue
                if not closer_nodes:
                    continue  # escaped: new owner's obligation
                if not _has_unconditional_close(
                    fn, parents, stmt, closer_nodes, var
                ) and not _escapes(fn, var, stmt):
                    out.append(Finding(
                        pass_id, sf.path, stmt.lineno, qual,
                        f"{code_prefix}-conditional-close:{var}",
                        f"{what} `{var}` is closed only under a "
                        "condition unrelated to the handle (or only "
                        "on an error/loop path) — the fall-through "
                        "path leaks it",
                    ))
                    continue
                closer_ids = {id(c) for c in closer_nodes}
                first_close = min(c.lineno for c in closer_nodes)
                for n in ast.walk(fn):
                    if isinstance(n, ast.Raise) and _owned_here(n) \
                            and n.lineno > stmt.lineno \
                            and not _closed_on_raise(
                                n, fn, parents, closer_ids, var, closers):
                        # A raise between acquire and the last close
                        # with no finally/handler close → the unwind
                        # path leaks.  Raises after the first close on
                        # the fallthrough path are fine (already
                        # closed when control got there).
                        if n.lineno <= first_close:
                            out.append(Finding(
                                pass_id, sf.path, n.lineno, qual,
                                f"{code_prefix}-error-path:{var}",
                                f"{what} `{var}` may unwind un-closed: "
                                f"raise at line {n.lineno} has no "
                                f"finally/handler calling "
                                f"{'/'.join(sorted(closers))}",
                            ))
                            break

        # A bare-expression acquire not bound by ANY form above (with,
        # assign, walrus) is unconditionally dropped.
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Expr) and _owned_here(stmt):
                for c in _acquire_calls(stmt.value, acquire_attr):
                    if id(c) in with_calls or id(c) in claimed:
                        continue
                    out.append(Finding(
                        pass_id, sf.path, stmt.lineno, qual,
                        f"{code_prefix}-dropped",
                        f"result of .{acquire_attr}() discarded — the "
                        f"{what} can never be closed",
                    ))
    return out


# ------------------------------------------------------- flight-op pass --

_STAMPERS = {"note_phase", "annotate"}
_OP_STAMP_ATTRS = {"mark", "note"}
_ADOPTERS = {"adopt_op", "adopt_trace", "trace_scope"}


def _thread_target_names(tree: ast.AST) -> set[str]:
    """Simple names handed to ``threading.Thread(target=...)`` in this
    module (the helper-thread set the single-appender rule governs)."""
    names: set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and call_name(n).endswith("Thread"):
            for kw in n.keywords:
                if kw.arg == "target":
                    d = dotted(kw.value)
                    if d:
                        names.add(d.rsplit(".", 1)[-1])
    return names


def _flight_pass(files: Sequence[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        out.extend(ownership_findings(
            sf, pass_id="flight-op", acquire_attr="begin",
            closers={"finish", "abandon"}, code_prefix="op",
            what="flight op",
        ))
        # Single-appender rule: a Thread-target function that stamps
        # phases ambently (note_phase/annotate) or on a foreign op must
        # adopt_op (or begin its own op) first — otherwise its stamps
        # land on whatever op the thread last held, or nowhere.
        targets = _thread_target_names(sf.tree)
        if not targets:
            continue
        for qual, fn in iter_functions(sf.tree):
            if fn.name not in targets:
                continue
            calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
            stamps = [
                c for c in calls
                if call_name(c).rsplit(".", 1)[-1] in _STAMPERS
            ]
            if not stamps:
                continue
            adopts = any(
                call_name(c).rsplit(".", 1)[-1] in _ADOPTERS or
                call_name(c).endswith(".begin")
                for c in calls
            )
            if not adopts:
                out.append(Finding(
                    "flight-op", sf.path, stamps[0].lineno, qual,
                    "stamp-without-adopt",
                    "thread-target function stamps flight phases "
                    "(note_phase/annotate) without adopt_op/begin — "
                    "the single-appender rule: helper threads must "
                    "adopt the op they stamp for",
                ))
    return out


def _resource_pass(files: Sequence[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        out.extend(ownership_findings(
            sf, pass_id="resource", acquire_attr="lease",
            closers={"release"}, code_prefix="lease",
            what="slab lease",
        ))
    return out


FLIGHT_PASS = AnalysisPass(
    pass_id="flight-op",
    doc="every begun FlightOp reaches exactly one finish/abandon on all "
        "paths; helper threads adopt_op before stamping phases",
    run=_flight_pass,
)

RESOURCE_PASS = AnalysisPass(
    pass_id="resource",
    doc="SlabLease acquire/release balance across try/except/finally "
        "dataflow (the class behind three past lease-leak fixes)",
    run=_resource_pass,
)
