"""Determinism & bounds pass.

Two mechanized review rules:

* **Injectable time/randomness** — controller/sampler modules (the
  AIMD tune controller, QoS admission, arrival processes, trace
  sampling) must not call wall/monotonic clocks or module-global RNGs
  directly: tests and record/replay need to drive them with a fake
  ``clock=`` / seeded ``rng=``.  Seeded constructions
  (``random.Random(seed)``, ``np.random.Generator(Philox(seed))``)
  are the compliant idiom and are not flagged.
* **Bounded accumulators** — obs/serve-path classes that ``append`` to
  a ``self.*`` list, or build a ``deque()`` without ``maxlen``, must
  show an explicit cap (the EXACT_SAMPLE_CAP discipline: reservoir
  halving, ring overwrite, len-checked trim, or periodic clear).  An
  open-loop serve run is unbounded in time; any per-event append
  without a cap is an OOM with a delay fuse.
"""

from __future__ import annotations

import ast
from typing import Sequence

from tpubench_torch.analysis.core import (
    AnalysisPass,
    Finding,
    SourceFile,
    call_name,
    pkg_path,
    qualnames,
    walk_scoped,
)

# Modules where clock/rng injection is mandatory (controllers decide,
# samplers select — both must be drivable by tests and replay), by their
# path inside the package walked (``pkg_path``).
CLOCK_MODULES = (
    "tune/controller.py",
    "serve/qos.py",
    "workloads/arrivals.py",
    "obs/trace.py",
    # Elastic membership: event stamps must ride the injected clock so
    # the serve harness can drive them with virtual schedule time and
    # the state-machine tests replay deterministically.
    "dist/membership.py",
    # Storage-lifecycle metadata storm: the open-loop dispatcher's
    # arrival stamps and per-op latencies must ride an injectable clock
    # so seeded storms replay deterministically in tests.
    "lifecycle/storm.py",
    # Record/replay plane: bundle distillation, the replay driver and
    # the --fail-on gate must be pure functions of their inputs — a
    # wall-clock or unseeded draw anywhere here breaks the
    # record → replay → record byte-identity contract.
    "replay/bundle.py",
    "replay/driver.py",
    "replay/gate.py",
    # Incident drill + delta saves: the kill/join script, the save
    # cadence and the dirty-shard draws all ride virtual schedule time
    # and seeded RNGs — a naked clock here would make the recorded
    # drill bundle unreplayable.
    "workloads/drill.py",
    "lifecycle/delta.py",
    # gRPC wire plane: the hand-rolled codec/framing/call layers and
    # the hermetic wire server must stay clock-free (perf_counter_ns
    # for span stamps only) — the fault timeline they serve is the
    # record/replay control variable, so a naked wall clock or
    # unseeded draw here would skew A/B runs that share a FaultPlan.
    "storage/grpc_wire/proto.py",
    "storage/grpc_wire/framing.py",
    "storage/grpc_wire/client.py",
    "storage/fake_grpc_wire_server.py",
    # Virtual-time fleet engine: the whole point is bit-identical
    # replays at 4096 hosts — the event loop owns time, service draws
    # ride seeded Philox, and the only real clock allowed is the
    # perf_counter_ns pair that measures the sim's own wall cost.
    "fleet/vtime.py",
    "fleet/calibrate.py",
    "fleet/driver.py",
)

# Paths whose classes must bound every accumulator (obs/serve planes
# live for the whole run / the whole open-loop schedule).
BOUNDS_PREFIXES = ("obs/", "serve/")
BOUNDS_FILES = ("workloads/serve.py",)

_NAKED_CLOCKS = {"time.time", "time.monotonic", "time.monotonic_ns"}
# Seeded RNG constructions allowed even in clock modules.
_SEEDED_RNG_CTORS = {"Random", "Generator", "Philox", "PCG64",
                     "SeedSequence", "default_rng"}


def _clock_findings(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    for scope, node in walk_scoped(sf.tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name in _NAKED_CLOCKS:
            out.append(Finding(
                "determinism", sf.path, node.lineno, scope,
                f"naked-clock:{name}",
                f"direct {name}() in a controller/sampler module "
                "— inject a clock= parameter so tests and "
                "record/replay can drive virtual time",
            ))
        elif name.startswith("random.") or \
                name.startswith("np.random.") or \
                name.startswith("numpy.random."):
            leaf = name.rsplit(".", 1)[-1]
            seeded = leaf in _SEEDED_RNG_CTORS and (
                node.args or node.keywords
            )
            if not seeded:
                out.append(Finding(
                    "determinism", sf.path, node.lineno, scope,
                    f"naked-rng:{name}",
                    f"module-global {name}() in a controller/"
                    "sampler module — take a seeded rng= "
                    "parameter instead",
                ))
    return out


# ---------------------------------------------------------------- bounds --

def _class_bound_evidence(cls: ast.ClassDef, attr: str) -> bool:
    """Does this class show ANY cap mechanism for ``self.<attr>``?
    Accepted evidence: len(self.attr) in a comparison, del on a slice/
    index of it, pop/popleft/clear called on it, re-assignment of the
    attribute outside __init__ (trim/reset), or deque(maxlen=...)."""
    init = next(
        (n for n in cls.body
         if isinstance(n, ast.FunctionDef) and n.name == "__init__"),
        None,
    )
    init_nodes = {id(n) for n in ast.walk(init)} if init else set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in (
                "pop", "popleft", "clear"
            ) and _is_self_attr(f.value, attr):
                return True
            if isinstance(f, ast.Name) and f.id == "len" and node.args \
                    and _is_self_attr(node.args[0], attr):
                return True
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and \
                        _is_self_attr(t.value, attr):
                    return True
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if _is_self_attr(t, attr):
                    v = node.value
                    if isinstance(v, ast.Call) and \
                            call_name(v).endswith("deque") and any(
                                kw.arg == "maxlen" for kw in v.keywords):
                        return True
                    if id(node) not in init_nodes:
                        # Re-assignment OUTSIDE __init__: a trim/reset
                        # path.  Assignments inside __init__ (however
                        # many branches) only initialize.
                        return True
    return False


def _is_self_attr(node: ast.AST, attr: str) -> bool:
    return (
        isinstance(node, ast.Attribute) and node.attr == attr
        and isinstance(node.value, ast.Name) and node.value.id == "self"
    )


def _bounds_findings(sf: SourceFile) -> list[Finding]:
    out: list[Finding] = []
    qn = qualnames(sf.tree)

    # deque() without maxlen anywhere in a bounds-governed module —
    # keyed by the enclosing scope, so vetting one deque never
    # suppresses a future one elsewhere in the file.
    for scope, node in walk_scoped(sf.tree):
        if isinstance(node, ast.Call) and \
                call_name(node).endswith("deque") and \
                not any(kw.arg == "maxlen" for kw in node.keywords):
            out.append(Finding(
                "determinism", sf.path, node.lineno, scope,
                "unbounded-deque",
                "deque() without maxlen in an obs/serve path — "
                "give it an explicit cap",
            ))
    for node in ast.walk(sf.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        appended: dict[str, int] = {}
        for n in ast.walk(node):
            if isinstance(n, ast.Call) and isinstance(
                n.func, ast.Attribute
            ) and n.func.attr == "append" and isinstance(
                n.func.value, ast.Attribute
            ) and isinstance(n.func.value.value, ast.Name) and \
                    n.func.value.value.id == "self":
                appended.setdefault(n.func.value.attr, n.lineno)
        for attr, line in sorted(appended.items(), key=lambda kv: kv[1]):
            if not _class_bound_evidence(node, attr):
                out.append(Finding(
                    "determinism", sf.path, line,
                    qn.get(id(node), node.name),
                    f"unbounded-accumulator:{attr}",
                    f"self.{attr}.append(...) with no visible cap "
                    "(no maxlen/len-check/pop/clear/trim) in an "
                    "obs/serve class — open-loop runs make this an "
                    "OOM with a delay fuse (EXACT_SAMPLE_CAP "
                    "discipline)",
                ))
    return out


def _determinism_pass(files: Sequence[SourceFile]) -> list[Finding]:
    out: list[Finding] = []
    for sf in files:
        rel = pkg_path(sf.path)
        if rel in CLOCK_MODULES:
            out.extend(_clock_findings(sf))
        if rel.startswith(BOUNDS_PREFIXES) or rel in BOUNDS_FILES:
            out.extend(_bounds_findings(sf))
    return out


DETERMINISM_PASS = AnalysisPass(
    pass_id="determinism",
    doc="no naked clocks/RNG in controller/sampler modules (inject "
        "clock=/rng=); every obs/serve accumulator carries an explicit "
        "cap",
    run=_determinism_pass,
)
