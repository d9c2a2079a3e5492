"""``tpubench_torch probe`` against ``tpubench probe``: ``analyze_sweep`` on
seeded synthetic sweeps (exact), and the result's schema from a CPU run
of both (``cycles=2``, no sleep). Rates are not compared: they measure
the machine.

Known difference, held here: the port's host arrays are page-locked on
CUDA (the staging ring copies from page-locked slots); the reference
copies from pageable numpy arrays.
"""

import numpy as np
import pytest
import torch

from tpubench_torch.config import BenchConfig
from tpubench_torch.workloads import probe


def _sweeps() -> list:
    rng = np.random.default_rng(11)
    keys = ["2MB", "8MB", "16MB", "32MB"]
    out = [
        {}, {"2MB": 0.0, "8MB": 0.0},
        {"2MB": 1.0, "8MB": 4.0, "16MB": 4.0, "32MB": 4.0},  # 2MB at 1/4: physics
        {"2MB": 0.5, "8MB": 4.0, "16MB": 4.0, "32MB": 4.0},  # 2MB under 1/6: stall
        {"2MB": 3.0, "8MB": 1.0, "16MB": 4.0, "32MB": 4.0},  # 8MB under 1/3
        {"16MB": 2.0, "32MB": 2.5},  # no 2MB/8MB cells
    ]
    for _ in range(40):
        vals = rng.choice([0.0, 0.1, 0.5, 1.0, 2.0, 4.0, 8.0], size=4)
        out.append({k: float(v) for k, v in zip(keys, vals)})
    return out


def test_analyze_sweep_matches_reference():
    from tpubench.workloads.probe import analyze_sweep as jax_analyze

    for sweep in _sweeps():
        assert probe.analyze_sweep(dict(sweep)) == jax_analyze(dict(sweep)), sweep
    assert probe.analyze_sweep(_sweeps()[2]) == ([], 4.0)
    assert probe.analyze_sweep(_sweeps()[3]) == (["2MB"], None)


def test_probe_schema_matches_reference_on_the_cpu(jax_cpu_devices):
    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.workloads.probe import run_probe as jax_probe

    ref = jax_probe(JaxBenchConfig(), cycles=2, sleep_s=0).to_dict()
    port = probe.run_probe(BenchConfig(), cycles=2, sleep_s=0,
                           device="cpu").to_dict()
    assert set(port) == set(ref)
    assert set(port["extra"]) == set(ref["extra"])
    for key in ("slow_start", "size_sweep_gbps"):
        assert set(port["extra"][key]) == set(ref["extra"][key]), key
    assert len(port["extra"]["cycle_samples_gbps"]) == 2
    assert port["bytes_total"] == ref["bytes_total"]
    assert port["extra"]["note"] == ref["extra"]["note"]
    assert port["n_chips"] == ref["n_chips"] == 1
    assert port["extra"]["device"] == "cpu"
    assert port["gbps"] == port["extra"]["peak_gbps"] > 0


def test_host_arrays_are_page_locked_only_for_cuda(monkeypatch):
    pinned = []

    def pin(self):
        pinned.append(self.numel())
        return self

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin)
    x = probe.host_array(2 * 1024 * 1024, torch.device("cpu"))
    assert pinned == [] and x.shape == (16384, 128) and x.dtype == torch.uint8
    probe.host_array(2 * 1024 * 1024, torch.device("cuda"))
    assert pinned == [2 * 1024 * 1024]
    # Seeded by size, as the reference's arrays are.
    from tpubench.workloads.probe import _mk

    assert np.array_equal(x.numpy(), _mk(2 * 1024 * 1024))


def test_probe_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.run_probe(BenchConfig(), cycles=1, sleep_s=0)
