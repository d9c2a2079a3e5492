"""``multichip-sweep`` of the port (``tpubench_torch.dist.sweep``) against
``tests/test_multichip_sweep.py``: the ring-algebra check catches a
violation, in both packages alike, and a small sweep (one child of two
gloo ranks, small shards) verifies every pod-ingest row and passes the
check. The reference's test of its committed artifact has no
counterpart: the port's sweep writes under the results directory and
never the committed ``MULTICHIP_SWEEP.json``."""

import json
from pathlib import Path

import pytest

from tpubench_torch import cli
from tpubench_torch.dist import sweep
from tpubench_torch.dist.sweep import check_ring_algebra, run_sweep

REPO = Path(__file__).resolve().parents[1]
ROWS = {
    "all_gather": [
        {"devices": 4, "shard_bytes": 100, "ici_bytes_moved": 1200},
        {"devices": 4, "shard_bytes": 100, "ici_bytes_moved": 999},
    ],
    "psum": [
        {"devices": 2, "shard_bytes": 100, "ici_bytes_moved": 200},
    ],
    "reduce_scatter": [
        {"devices": 1, "shard_bytes": 128, "ici_bytes_moved": 0},
    ],
}


def test_check_ring_algebra_catches_violation():
    from tpubench.dist.sweep import check_ring_algebra as ref

    bad = check_ring_algebra(ROWS)
    assert len(bad) == 1 and "999" in bad[0]
    assert bad == ref(ROWS)
    assert check_ring_algebra({"gather": ROWS["psum"]}) == [
        "gather: unknown collective"]


def test_run_sweep_small_pod(tmp_path):
    """One child of two gloo ranks: pod-ingest verifies at both
    collectives, every stage is timed, the collectives' rows obey the
    ring algebra, and the rows say where they ran."""
    out = tmp_path / "m.json"
    result = run_sweep(sizes=(2,), shard_mb=0.5, reps=1, out_path=str(out),
                       device="cpu")
    assert result["ring_algebra_ok"], result["ring_algebra_violations"]
    assert json.loads(out.read_text()) == result
    assert "gloo on cpu" in result["platform"]
    (entry,) = result["pod_ingest"]
    assert (entry["devices"], entry["backend"], entry["device"]) == (
        2, "gloo", "cpu")
    assert entry["launches"] == {"land": 0, "checksum": 0}
    for key in ("pod_ingest_all_gather", "pod_ingest_ring"):
        pi = entry[key]
        assert pi["verified"] is True and pi["errors"] == 0
        assert pi["object_size"] == 2 * 512 * 1024
        for stage in ("fetch_seconds", "stage_seconds", "gather_seconds"):
            assert pi[stage] > 0
        assert pi["ici_bytes_moved"] == pi["shard_bytes"] * 2 * 1
    assert set(result["collectives"]) == {
        "all_gather", "ring", "reduce_scatter", "psum"}
    assert [r["devices"] for r in result["collectives"]["psum"]] == [2]


def test_cli_default_artifact_is_not_the_committed_one(tmp_path, monkeypatch):
    """The artifact goes under ``--results-dir``; naming the committed
    ``MULTICHIP_SWEEP.json`` is refused before any child runs."""
    seen = []
    monkeypatch.setattr(sweep, "run_sweep",
                        lambda *a, **k: seen.append((a, k)) or {})
    assert cli.main(["multichip-sweep", "--sizes", "2", "--device", "cpu",
                     "--results-dir", str(tmp_path)]) == 0
    assert seen[0][1]["out_path"] == str(tmp_path / sweep.ARTIFACT)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="committed artifact"):
        run_sweep(sizes=(2,), out_path=str(REPO / "MULTICHIP_SWEEP.json"),
                  device="cpu")
