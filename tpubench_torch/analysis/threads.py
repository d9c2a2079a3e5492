"""Thread-hygiene pass.

Two mechanized review rules:

* **Named threads** — every ``threading.Thread(...)`` carries a
  ``name=`` kwarg.  Anonymous ``Thread-7`` in a stack dump or a flight
  journal is useless at pod scale; every review round renamed one.
* **The coop-serve / Ctrl-C rule** — ``except BaseException`` (and bare
  ``except:``) handlers must re-raise.  A swallowed BaseException eats
  KeyboardInterrupt/SystemExit: worker bodies that *record* errors must
  catch ``Exception`` and let cancellation unwind.  Handlers that
  legitimately route the error through recorded state re-raised
  elsewhere (WorkerGroup, the hedge out-queue, the staging reaper) are
  vetted in the allowlist with justifications.
"""

from __future__ import annotations

import ast
from typing import Sequence

from tpubench_torch.analysis.core import (
    AnalysisPass,
    Finding,
    SourceFile,
    call_name,
    walk_scoped,
)


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    """A Raise on the handler's own unwind path — a raise inside a
    nested def/lambda registered as a callback does not re-raise for
    the handler and must not satisfy the rule."""
    def scan(node: ast.AST) -> bool:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Raise) or scan(child):
                return True
        return False

    return scan(handler)


def _catches_baseexception(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True  # bare except:
    names = []
    if isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    elif isinstance(t, ast.Name):
        names = [t.id]
    return "BaseException" in names


def _thread_pass(files: Sequence[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        for scope, node in walk_scoped(sf.tree):
            if isinstance(node, ast.Call):
                name = call_name(node)
                # endswith: aliased imports (`import threading as
                # _threading`, a lazy-import pattern the tree uses)
                # must not hide an unnamed thread from the gate.
                if name == "Thread" or name.endswith(".Thread"):
                    has_name = any(kw.arg == "name" for kw in node.keywords)
                    if not has_name:
                        out.append(Finding(
                            "thread", sf.path, node.lineno, scope,
                            "unnamed-thread",
                            "threading.Thread without name= — anonymous "
                            "threads are invisible in stack dumps, "
                            "flight journals and the straggler tables",
                        ))
            elif isinstance(node, ast.ExceptHandler):
                if _catches_baseexception(node) and not \
                        _handler_reraises(node):
                    kind = "bare except" if node.type is None else \
                        "except BaseException"
                    out.append(Finding(
                        "thread", sf.path, node.lineno, scope,
                        "baseexception-swallow",
                        f"{kind} without re-raise swallows "
                        "KeyboardInterrupt/SystemExit (the coop-serve "
                        "Ctrl-C rule) — catch Exception, or re-raise, "
                        "or vet in the allowlist",
                    ))
    return out


THREAD_PASS = AnalysisPass(
    pass_id="thread",
    doc="every threading.Thread is named; BaseException/bare-except "
        "handlers re-raise (worker bodies record via Exception)",
    run=_thread_pass,
)
