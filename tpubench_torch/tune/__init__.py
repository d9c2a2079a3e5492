"""Adaptive ingest autotuner (``tpubench/tune``): the online controller
that turns the read path's static knobs (worker fan-out, staging depth,
hedge delay) into controlled variables with a measurement loop and a p99
guardrail."""

from tpubench_torch.tune.controller import (  # noqa: F401
    ACTUATED,
    Knob,
    RecorderSampler,
    TuneController,
)
