"""QoS serve plane: per-tenant scheduling for the open-loop traffic
workload (``serve``; a copy of ``tpubench/serve/``).

:mod:`qos` holds the scheduling primitives — tenant population
expansion, the priority admission queue (the native executor's runnable-queue
admission cap generalized with a priority order and deadline-aware
shedding), and the scorecard math (per-class SLO attainment, Jain
fairness, knee detection). The workload driver lives in
:mod:`tpubench_torch.workloads.serve`.
"""

from tpubench_torch.serve.qos import (  # noqa: F401
    AdmissionQueue,
    Request,
    ShedError,
    Tenant,
    build_tenants,
    find_knee,
    jain_index,
)
