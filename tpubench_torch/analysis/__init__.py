"""The invariant-analysis plane (``check``), a copy of ``tpubench``'s
over ``tpubench_torch/``.

AST-based static analysis mechanizing the recurring review findings —
flight-op lifecycle, thread hygiene, slab-lease balance, determinism &
bounds, declarative catalog-drift guards, and a static lock-order
graph.  See :mod:`tpubench_torch.analysis.core` for the framework; the
vetted allowlist is ``allowlist.json`` beside it, every entry with its
justification.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence

from tpubench_torch.analysis.core import (  # noqa: F401  (public API)
    ALLOWLIST_SCHEMA,
    CheckConfigError,
    DEFAULT_ALLOWLIST,
    Finding,
    REPO_ROOT,
    Report,
    SCHEMA,
    SourceFile,
    load_allowlist,
    load_tree,
    run_check,
)
from tpubench_torch.analysis.drift import (  # noqa: F401
    DRIFT_GUARDS,
    DriftSkip,
    run_drift_guard,
)


def run_cli_check(json_out: bool = False,
                  paths: Optional[Sequence[str]] = None,
                  root: str = REPO_ROOT,
                  allowlist_path: Optional[str] = None,
                  with_drift: bool = True,
                  keep: Optional[list] = None) -> int:
    """``check`` entry: 0 clean, 1 findings/stale allowlist, 2 analyzer
    misconfiguration. ``keep``, where given, receives the :class:`Report`
    (its per-pass ``seconds`` included)."""
    try:
        report = run_check(
            root=root, paths=paths,
            allowlist_path=allowlist_path or DEFAULT_ALLOWLIST,
            with_drift=with_drift,
        )
    except CheckConfigError as e:
        print(f"check: config error: {e}", file=sys.stderr)
        return 2
    except Exception:  # noqa: BLE001 — exit-code contract: 2 = broken
        # checker, never 1 (= findings) — CI must be able to tell a
        # dirty tree from a crashed analyzer (e.g. a drift guard's
        # surface file missing in a vendored install).
        import traceback

        traceback.print_exc()
        print("check: internal error (see traceback)", file=sys.stderr)
        return 2
    if keep is not None:
        keep.append(report)
    if json_out:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render())
    return report.exit_code
