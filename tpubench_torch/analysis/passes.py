"""Pass registry: the five invariant planes behind ``check``."""

from __future__ import annotations

from tpubench_torch.analysis.core import REPO_ROOT, AnalysisPass
from tpubench_torch.analysis.determinism import DETERMINISM_PASS
from tpubench_torch.analysis.drift import make_drift_pass
from tpubench_torch.analysis.lifecycle import FLIGHT_PASS, RESOURCE_PASS
from tpubench_torch.analysis.lockorder import LOCK_ORDER_PASS
from tpubench_torch.analysis.threads import THREAD_PASS

STATIC_PASSES: tuple[AnalysisPass, ...] = (
    FLIGHT_PASS,
    THREAD_PASS,
    RESOURCE_PASS,
    DETERMINISM_PASS,
    LOCK_ORDER_PASS,
)


def all_passes(with_drift: bool = True,
               repo_root: str = REPO_ROOT) -> list[AnalysisPass]:
    passes = list(STATIC_PASSES)
    if with_drift:
        passes.append(make_drift_pass(repo_root))
    return passes
