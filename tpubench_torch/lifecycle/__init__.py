"""Storage-lifecycle plane — a copy of ``tpubench/lifecycle`` (device-free;
``workloads/ckpt.py`` adds the staging onto the card):

* :mod:`.manifest` — the sharded-checkpoint layout (objects + crc32s) save
  and restore agree on, in ``tpubench``'s format;
* :mod:`.upload` — the resumable multi-part upload driver (parts, flight
  phases, part latency, resumed-part accounting) and the crc32 readback;
* :mod:`.delta` — per-shard dirty tracking and ``ifGenerationMatch``-CAS
  delta saves (the drill's periodic saves);
* :mod:`.storm` — the open-loop metadata storm engine of ``meta-storm``.
"""

from tpubench_torch.lifecycle.delta import DeltaTracker, delta_save  # noqa: F401
from tpubench_torch.lifecycle.manifest import (  # noqa: F401
    CkptManifest,
    build_manifest,
    manifest_name,
    read_manifest,
    shard_content,
    shard_object_name,
)
from tpubench_torch.lifecycle.storm import (  # noqa: F401
    MetaOp,
    build_storm_schedule,
    run_storm,
)
from tpubench_torch.lifecycle.upload import (  # noqa: F401
    readback_crc32,
    upload_object,
)


def format_lifecycle_scorecard(lc: dict) -> str:
    """Human rendering of ``extra["lifecycle"]`` — shared by the CLI
    (printed live) and ``report`` (re-rendered from the result file);
    ``tpubench``'s text line for line, every op's branch included (a
    ``meta_storm`` document of ``tpubench`` renders here too)."""
    op = lc.get("op", "?")
    lines = [f"  lifecycle [{op}]:"]
    if op == "save":
        lines.append(
            f"    save goodput={lc.get('goodput_gbps', 0.0):.4f} GB/s  "
            f"objects={lc.get('objects', 0)}  "
            f"bytes={lc.get('bytes', 0)}  parts={lc.get('parts', 0)}"
        )
        part = lc.get("part_latency") or {}
        if part:
            lines.append(
                f"    part p50={part.get('p50_ms', 0.0):.2f} ms  "
                f"p99={part.get('p99_ms', 0.0):.2f} ms  "
                f"(n={part.get('count', 0)})"
            )
        lines.append(
            f"    resumed_parts={lc.get('resumed_parts', 0)}  "
            f"corrupt_finalizes={lc.get('corrupt_finalizes', 0)}  "
            f"verified={lc.get('verified')}"
        )
    elif op == "restore":
        lines.append(
            f"    time-to-restore={lc.get('time_to_restore_s', 0.0):.3f} s  "
            f"goodput={lc.get('goodput_gbps', 0.0):.4f} GB/s  "
            f"objects={lc.get('objects', 0)}  bytes={lc.get('bytes', 0)}"
        )
        lines.append(
            f"    fetch={lc.get('fetch_seconds', 0.0):.3f} s  "
            f"stage={lc.get('stage_seconds', 0.0):.3f} s  "
            f"staged={lc.get('staged')}  "
            f"shards/object={lc.get('shards_per_object', 1)}  "
            f"verified={lc.get('verified')}"
        )
    elif op == "meta_storm":
        pts = (lc.get("sweep") or {}).get("points")
        if pts:
            lines.append("    offered_rps  achieved_rps   p50_ms   p99_ms")
            for p in pts:
                lines.append(
                    f"    {p.get('offered_rps', 0.0):>11.1f}"
                    f"  {p.get('achieved_rps', 0.0):>12.1f}"
                    f"  {p.get('p50_ms') if p.get('p50_ms') is not None else float('nan'):>7.2f}"
                    f"  {p.get('p99_ms') if p.get('p99_ms') is not None else float('nan'):>7.2f}"
                )
            knee = (lc.get("sweep") or {}).get("knee")
            lines.append(
                f"    knee: {knee}" if knee is not None
                else "    knee: not reached in this sweep"
            )
        else:
            lines.append(
                f"    ops={lc.get('ops', 0)}  "
                f"offered={lc.get('offered_rps', 0.0):.1f} rps  "
                f"achieved={lc.get('achieved_rps', 0.0):.1f} rps  "
                f"errors={lc.get('errors', 0)}"
            )
            lat = lc.get("latency") or {}
            if lat:
                lines.append(
                    f"    op p50={lat.get('p50_ms', 0.0):.2f} ms  "
                    f"p99={lat.get('p99_ms', 0.0):.2f} ms"
                )
            for k, s in (lc.get("by_kind") or {}).items():
                lines.append(
                    f"      {k}: n={s.get('count', 0)} "
                    f"p50={s.get('p50_ms', 0.0):.2f} ms "
                    f"p99={s.get('p99_ms', 0.0):.2f} ms"
                )
    return "\n".join(lines)
