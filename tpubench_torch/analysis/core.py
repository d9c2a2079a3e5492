"""Shared machinery for the invariant-analysis plane (``check``), a copy
of ``tpubench``'s analyzer pointed at this package.

Review rounds kept re-catching the same hand-audited invariant classes —
flight-op lifecycle, worker-thread error hygiene, slab-lease release on
error paths, injectable clock/rng, bounded sample buffers, N-way catalog
drift.  This package mechanizes them: each recurring finding class is a
:class:`AnalysisPass` over the parsed AST of the whole tree, run by
:func:`run_check` and surfaced through the ``check`` CLI (human +
``--json``), with a checked-in vetted allowlist (`allowlist.json`) whose
every entry carries a required justification string.  The suite runs as
a tier-1 test, so a regression in any mechanized invariant fails CI, not
review.

The tree walked is a parameter (``package``, default ``tpubench_torch``):
the passes name the files they govern by their path INSIDE the package
(:func:`pkg_path`), so the same analyzer run over ``tpubench/`` gives
``tpubench``'s own report.  Finding keys keep the repo-relative path.

Design notes
------------
* Findings are keyed WITHOUT line numbers (``pass:path:symbol:code``)
  so the allowlist survives unrelated edits to the same file; the line
  is carried for display only.
* Allowlist entries that no longer match any finding are themselves
  findings (``stale-allowlist``) — the list can only shrink back, never
  rot.
* Passes receive every parsed file (some, like lock-order, are
  whole-program); fixture-driven tests inject synthetic
  :class:`SourceFile` lists instead of walking the tree.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import time
from typing import Callable, Iterable, Optional, Sequence

SCHEMA = "tpubench-check/1"
ALLOWLIST_SCHEMA = "tpubench-check-allowlist/1"

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_PKG_DIR))
DEFAULT_ALLOWLIST = os.path.join(_PKG_DIR, "allowlist.json")
# The package a default run walks (this one).
PACKAGE = os.path.basename(os.path.dirname(_PKG_DIR))


class CheckConfigError(Exception):
    """Analyzer misconfiguration (bad allowlist, unreadable tree) —
    distinct from findings: exits 2, never 1, so CI can tell 'the tree
    is dirty' from 'the checker itself is broken'."""


@dataclasses.dataclass(frozen=True)
class Finding:
    pass_id: str
    path: str      # repo-relative, forward slashes
    line: int
    symbol: str    # dotted lexical scope ("Class.method.<locals>")
    code: str      # short stable slug for the finding class
    message: str

    @property
    def key(self) -> str:
        # Line-free on purpose: an allowlist entry must survive edits
        # elsewhere in the file.  Two findings sharing a key share the
        # vetting (same symbol, same invariant class).
        return f"{self.pass_id}:{self.path}:{self.symbol}:{self.code}"

    def to_dict(self, allowlisted: bool) -> dict:
        return {
            "pass": self.pass_id,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "code": self.code,
            "message": self.message,
            "key": self.key,
            "allowlisted": allowlisted,
        }


@dataclasses.dataclass
class SourceFile:
    path: str        # repo-relative
    text: str
    tree: ast.AST

    @classmethod
    def parse(cls, path: str, text: str) -> "SourceFile":
        return cls(path=path, text=text, tree=ast.parse(text, filename=path))


@dataclasses.dataclass
class AnalysisPass:
    pass_id: str
    doc: str
    run: Callable[[Sequence[SourceFile]], list[Finding]]
    # Seconds of each part a pass times on its own (the drift pass: each
    # guard), as of its last run; :func:`run_check` reports them.
    part_seconds: dict[str, float] = dataclasses.field(default_factory=dict)


def pkg_path(path: str) -> str:
    """A repo-relative path's part inside its top-level package
    (``tpubench_torch/serve/qos.py`` -> ``serve/qos.py``): what the
    passes' file lists name, whichever package is walked."""
    return path.split("/", 1)[1] if "/" in path else path


def load_tree(root: str = REPO_ROOT,
              paths: Optional[Iterable[str]] = None,
              package: str = PACKAGE) -> list[SourceFile]:
    """Parse ``package`` under ``root`` (or an explicit path list) into
    :class:`SourceFile`\\ s, sorted for deterministic output."""
    files: list[SourceFile] = []
    if paths:
        rels = sorted(
            os.path.relpath(os.path.abspath(p), root).replace(os.sep, "/")
            for p in paths
        )
    else:
        rels = []
        pkg = os.path.join(root, package)
        if not os.path.isdir(pkg):
            raise CheckConfigError(f"no {package} package under {root}")
        for dirpath, _dirnames, filenames in os.walk(pkg):
            for fn in filenames:
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn), root)
                    rels.append(rel.replace(os.sep, "/"))
        rels.sort()
    for rel in rels:
        full = os.path.join(root, rel)
        try:
            with open(full) as f:
                text = f.read()
            files.append(SourceFile.parse(rel, text))
        except (OSError, SyntaxError) as e:
            raise CheckConfigError(f"cannot analyze {rel}: {e}") from e
    return files


# ------------------------------------------------------------ allowlist --

def load_allowlist(path: str = DEFAULT_ALLOWLIST) -> dict[str, str]:
    """key -> justification.  Every entry MUST carry a non-empty
    justification — an unexplained suppression is itself a config
    error, the 'vetted' in vetted-allowlist."""
    if not os.path.exists(path):
        if path == DEFAULT_ALLOWLIST:
            return {}  # no checked-in allowlist yet: nothing vetted
        # An explicitly requested allowlist that doesn't exist is a
        # misconfiguration (typo'd --allowlist) — exit 2, NOT 'every
        # vetting suddenly surfaces as a finding' (exit 1).
        raise CheckConfigError(f"allowlist not found: {path}")
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckConfigError(f"allowlist unreadable: {e}") from e
    if doc.get("schema") != ALLOWLIST_SCHEMA:
        raise CheckConfigError(
            f"allowlist {path}: schema {doc.get('schema')!r}, "
            f"expected {ALLOWLIST_SCHEMA!r}"
        )
    out: dict[str, str] = {}
    for i, entry in enumerate(doc.get("entries", [])):
        key = entry.get("key", "")
        just = (entry.get("justification") or "").strip()
        if not key:
            raise CheckConfigError(f"allowlist entry {i}: missing key")
        if not just:
            raise CheckConfigError(
                f"allowlist entry {key!r}: justification is required — "
                "every suppression must say why it is safe"
            )
        if key in out:
            raise CheckConfigError(f"allowlist entry {key!r}: duplicate")
        out[key] = just
    return out


# --------------------------------------------------------------- report --

@dataclasses.dataclass
class Report:
    findings: list[Finding]
    allowlist: dict[str, str]
    skipped: list[str]           # e.g. engine-dependent drift guard
    files_scanned: int
    passes: list[str]
    # Repo-relative paths actually analyzed: staleness is only judged
    # for allowlist entries whose file was in scope, so a
    # path-restricted run (pre-commit over changed files) does not
    # declare every other entry stale.
    scanned_paths: frozenset[str] = frozenset()
    # Wall seconds of the tree's load, each pass and each part a pass
    # timed (``drift:<guard>``), as this run took them; not part of the
    # JSON schema, which stays the reference's.
    seconds: dict[str, float] = dataclasses.field(
        default_factory=dict, compare=False)

    @property
    def active(self) -> list[Finding]:
        return [f for f in self.findings if f.key not in self.allowlist]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.key in self.allowlist]

    @property
    def stale_allowlist(self) -> list[str]:
        # Staleness needs BOTH dimensions in scope: the entry's file
        # was scanned AND the pass that mints its key actually ran —
        # otherwise a --no-drift or path-restricted run would declare
        # out-of-scope vettings stale.
        hit = {f.key for f in self.findings}
        ran = set(self.passes)
        return sorted(
            k for k in self.allowlist
            if k not in hit
            and _key_path(k) in self.scanned_paths
            and k.split(":", 1)[0] in ran
        )

    @property
    def clean(self) -> bool:
        return not self.active and not self.stale_allowlist

    @property
    def exit_code(self) -> int:
        return 0 if self.clean else 1

    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA,
            "passes": list(self.passes),
            "files_scanned": self.files_scanned,
            "findings": [
                f.to_dict(f.key in self.allowlist) for f in self.findings
            ],
            "stale_allowlist": self.stale_allowlist,
            "skipped": list(self.skipped),
            "summary": {
                "findings": len(self.active),
                "allowlisted": len(self.suppressed),
                "stale_allowlist": len(self.stale_allowlist),
                "clean": self.clean,
            },
        }

    def render(self) -> str:
        lines: list[str] = []
        by_pass: dict[str, list[Finding]] = {}
        for f in self.active:
            by_pass.setdefault(f.pass_id, []).append(f)
        for pid in sorted(by_pass):
            lines.append(f"[{pid}]")
            for f in sorted(by_pass[pid], key=lambda x: (x.path, x.line)):
                lines.append(
                    f"  {f.path}:{f.line}: {f.symbol}: {f.message}"
                    f"  (key: {f.key})"
                )
        for key in self.stale_allowlist:
            lines.append(
                f"[allowlist] stale entry no longer matched by any "
                f"finding — remove it: {key}"
            )
        for s in self.skipped:
            lines.append(f"[skipped] {s}")
        n, m = len(self.active), len(self.suppressed)
        lines.append(
            f"check: {n} finding{'s' if n != 1 else ''} "
            f"({m} allowlisted, {len(self.stale_allowlist)} stale allowlist "
            f"entr{'ies' if len(self.stale_allowlist) != 1 else 'y'}) "
            f"across {self.files_scanned} files"
        )
        return "\n".join(lines)


def run_check(root: str = REPO_ROOT,
              paths: Optional[Iterable[str]] = None,
              files: Optional[Sequence[SourceFile]] = None,
              passes: Optional[Sequence[AnalysisPass]] = None,
              allowlist: Optional[dict[str, str]] = None,
              allowlist_path: str = DEFAULT_ALLOWLIST,
              with_drift: bool = True,
              package: str = PACKAGE) -> Report:
    """Run the suite.  ``files`` (pre-parsed) beats ``paths`` beats the
    default walk of ``package``; ``with_drift=False`` skips the runtime
    drift guards (fixture tests have no live registries to compare, and
    the guards read this package's own surfaces whatever is walked)."""
    from tpubench_torch.analysis.passes import all_passes  # cycle-free

    seconds: dict[str, float] = {}
    if files is None:
        t0 = time.perf_counter()
        files = load_tree(root, paths, package)
        seconds["load_tree"] = time.perf_counter() - t0
    if passes is None:
        passes = all_passes(with_drift=with_drift, repo_root=root)
    if allowlist is None:
        allowlist = load_allowlist(allowlist_path)
    findings: list[Finding] = []
    skipped: list[str] = []
    for p in passes:
        t0 = time.perf_counter()
        out = p.run(files)
        seconds[p.pass_id] = time.perf_counter() - t0
        seconds.update({f"{p.pass_id}:{k}": v
                        for k, v in p.part_seconds.items()})
        for item in out:
            if isinstance(item, str):  # pass-level skip note
                skipped.append(item)
            else:
                findings.append(item)
    findings.sort(key=lambda f: (f.pass_id, f.path, f.line, f.code))
    return Report(
        findings=findings, allowlist=allowlist, skipped=skipped,
        files_scanned=len(files), passes=[p.pass_id for p in passes],
        scanned_paths=frozenset(sf.path for sf in files),
        seconds=seconds,
    )


def _key_path(key: str) -> str:
    """The path component of an allowlist key (pass:path:symbol:code —
    repo-relative posix paths never contain colons)."""
    parts = key.split(":")
    return parts[1] if len(parts) >= 2 else ""


# ------------------------------------------------------------ AST utils --

def qualnames(tree: ast.AST) -> dict[int, str]:
    """id(node) -> dotted lexical qualname for every function/class."""
    out: dict[int, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                qn = f"{prefix}.{child.name}" if prefix else child.name
                out[id(child)] = qn
                visit(child, qn)
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def iter_functions(tree: ast.AST):
    """Yield (qualname, FunctionDef) for every function, nested included."""
    qn = qualnames(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield qn[id(node)], node


def walk_scoped(tree: ast.AST):
    """Yield (enclosing-scope qualname, node) for every node — the ONE
    scope-attribution walk (finding keys embed the symbol, so every
    pass must attribute scopes identically or allowlist entries drift
    between passes)."""
    qn = qualnames(tree)

    def visit(node: ast.AST, scope: str):
        for child in ast.iter_child_nodes(node):
            child_scope = qn.get(id(child), scope)
            yield child_scope, child
            yield from visit(child, child_scope)

    yield from visit(tree, "<module>")


def parent_map(root: ast.AST) -> dict[int, ast.AST]:
    out: dict[int, ast.AST] = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def call_name(call: ast.Call) -> str:
    """Best-effort dotted name of a call target ('threading.Thread',
    'wf.begin', 'adopt_op')."""
    return dotted(call.func)


def dotted(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def uses_name(node: ast.AST, name: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == name for n in ast.walk(node)
    )
