"""Live cross-host journal aggregation + the ``top`` dashboard (a copy of
``tpubench/obs/live.py``: the same journals give the same frame).

The flight journals are per-host, atomically-rewritten JSON docs
(``.p<idx>`` suffixes, optionally ``.gz``) that stream during a run —
on the telemetry session's tick. This module tails them as the run goes
(cross-host aggregation while the run is in flight, not post-mortem): re-read whichever files changed, merge the
docs, and fold them into one rolling view — goodput GB/s(/chip),
per-phase p50/p99, cache hit ratio, staging efficiency, hedge/breaker/
tune event counts, and per-host straggler attribution.

``top`` renders that view as a curses-free ANSI frame
(``--once`` prints a single plain frame for tests/CI); everything here
is device-free so the dashboard can run on a machine that never
touches a GPU.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time
from typing import Optional

from tpubench_torch.obs.flight import (
    JOURNAL_FORMAT,
    PHASES,
    goodput_summary,
    read_journal_text,
    record_span_ns,
    timeline_summary,
)


def discover_journal_paths(bases: list[str]) -> list[str]:
    """Expand base journal paths into the per-host file set: each base
    plus its ``.p<idx>`` siblings (the multi-host suffix convention),
    existing files only, deduplicated, stable order."""
    seen: dict[str, None] = {}
    for base in bases:
        candidates = [base]
        # foo.json -> foo.json.p1 …; foo.json.gz -> foo.json.gz.p1 is
        # not written (the suffix rides BEFORE nothing — hosts suffix
        # the configured path itself), so glob on the base.
        candidates.extend(sorted(glob.glob(glob.escape(base) + ".p*")))
        for c in candidates:
            if os.path.exists(c) and not c.endswith(".tmp"):
                seen[c] = None
    return list(seen)


def read_journal_doc(path: str) -> Optional[dict]:
    """Tolerant single-doc read for the tailer: a missing, empty,
    truncated or non-journal file returns None (the poll just shows the
    host as not-reporting-yet) — a live dashboard must survive every
    partial state a crashing writer can leave behind."""
    try:
        raw = read_journal_text(path)
        doc = json.loads(raw)
    except Exception:  # noqa: BLE001 — any partial state = not yet
        return None
    if not isinstance(doc, dict) or doc.get("format") != JOURNAL_FORMAT:
        return None
    return doc


class LiveAggregator:
    """Poll-based merge of streaming per-host journals.

    Each ``poll()`` re-reads only files whose (mtime, size) changed,
    keeps the latest good doc per path (a torn mid-rewrite read keeps
    the previous view alive), and returns the merged rolling view."""

    def __init__(self, bases: list[str], window_s: float = 10.0):
        self.bases = list(bases)
        self.window_s = window_s
        self._stamp: dict[str, tuple] = {}
        self._docs: dict[str, dict] = {}

    def poll(self) -> dict:
        for path in discover_journal_paths(self.bases):
            try:
                st = os.stat(path)
                stamp = (st.st_mtime_ns, st.st_size)
            except OSError:
                continue
            if self._stamp.get(path) == stamp:
                continue
            doc = read_journal_doc(path)
            if doc is not None:
                self._docs[path] = doc
                self._docs[path]["_age_base"] = st.st_mtime
                self._stamp[path] = stamp
        return self._view()

    def _view(self) -> dict:
        docs = list(self._docs.values())
        records: list[dict] = []
        files = []
        # Per-host stamps (read, local train-ingest) sum across hosts;
        # pod workloads stamp the mesh-GLOBAL count into every host's
        # journal (chips_global), so those merge by max, never sum —
        # a 4-host 16-chip pod is 16 chips, not 64.
        host_chips = 0
        global_chips = 0
        now = time.time()
        for path, doc in self._docs.items():
            host = doc.get("host", 0)
            c = max(1, int(doc.get("n_chips", 1) or 1))
            if doc.get("chips_global"):
                global_chips = max(global_chips, c)
            else:
                host_chips += c
            files.append({
                "path": path,
                "host": host,
                "records": len(doc.get("records", ())),
                "dropped": int(doc.get("dropped", 0)),
                "rotation_dropped": int(doc.get("rotation_dropped", 0)),
                "age_s": max(0.0, now - doc.get("_age_base", now)),
                "workload": doc.get("workload", ""),
            })
            for rec in doc.get("records", ()):
                if "host" not in rec:
                    rec = {**rec, "host": host}
                records.append(rec)
        records.sort(key=lambda r: r["phases"].get("enqueue", 0))
        summ = timeline_summary(records) if records else None
        rolling = self._rolling_goodput(records)
        return {
            "files": files,
            "hosts": sorted({f["host"] for f in files}),
            "n_chips": max(1, host_chips + global_chips),
            "summary": summ,
            "rolling": rolling,
            "window_s": self.window_s,
        }

    def _rolling_goodput(self, records: list[dict]) -> dict:
        """Goodput over each host's trailing window (perf_counter
        timestamps are host-relative, so the window anchors per host at
        that host's newest record)."""
        if not records:
            return {"gbps": 0.0, "hosts": {}}
        horizon = int(self.window_s * 1e9)
        max_ts: dict = {}
        for rec in records:
            _, t1 = record_span_ns(rec)
            if t1 is not None:
                h = rec.get("host", 0)
                max_ts[h] = max(max_ts.get(h, t1), t1)
        recent = []
        for rec in records:
            _, t1 = record_span_ns(rec)
            h = rec.get("host", 0)
            if t1 is not None and t1 >= max_ts.get(h, 0) - horizon:
                recent.append(rec)
        return goodput_summary(recent)


# --------------------------------------------------------------- render -----

_RED = "\x1b[31;1m"
_BOLD = "\x1b[1m"
_DIM = "\x1b[2m"
_RESET = "\x1b[0m"
_CLEAR = "\x1b[2J\x1b[H"


def render_top(view: dict, color: bool = False) -> str:
    """One ``top`` frame from a LiveAggregator view: the merged
    rolling numbers with the straggler host highlighted. Plain ASCII
    when ``color`` is False (``--once`` / piped output)."""

    def c(code: str, s: str) -> str:
        return f"{code}{s}{_RESET}" if color else s

    files = view.get("files", [])
    summ = view.get("summary")
    lines = []
    if not files or summ is None:
        lines.append("tpubench top: waiting for journals "
                     f"({len(files)} file(s) found, no records yet)")
        return "\n".join(lines)
    dropped = sum(f["dropped"] for f in files)
    rotated = sum(f["rotation_dropped"] for f in files)
    head = (
        f"tpubench top — {len(files)} journal(s) hosts={view['hosts']} "
        f"records={summ['records']} errors={summ['errors']} "
        f"retries={summ['retries']}"
    )
    if dropped:
        head += f" dropped={dropped}"
    if rotated:
        head += f" rotated={rotated}"
    lines.append(c(_BOLD, head))
    gp = summ.get("goodput", {})
    roll = view.get("rolling", {})
    chips = view.get("n_chips", 1)
    lines.append(
        f"goodput: {gp.get('gbps', 0.0):.4f} GB/s "
        f"({gp.get('gbps', 0.0) / chips:.4f} GB/s/chip, {chips} chip(s))"
        f"   rolling({view.get('window_s', 0):.0f}s): "
        f"{roll.get('gbps', 0.0):.4f} GB/s"
    )
    pipe = summ.get("pipeline", {})
    hits, misses = pipe.get("cache_hits", 0), pipe.get("cache_misses", 0)
    bits = []
    if hits + misses:
        bits.append(f"cache hit {hits / (hits + misses):.1%}")
    coop = summ.get("coop", {})
    if coop.get("peer_requests"):
        bits.append(
            f"peer hit {coop['peer_transfers'] / coop['peer_requests']:.1%} "
            f"({coop['peer_transfers']} transfers, "
            f"{coop['peer_bytes']}B)"
        )
    if coop.get("demotions") or coop.get("restores"):
        bits.append(
            f"coop demotions={coop.get('demotions', 0)}"
            f"/restores={coop.get('restores', 0)}"
        )
    stg = summ.get("staging", {})
    if stg.get("transfers"):
        bits.append(
            f"staging transfers={stg['transfers']} "
            f"overlapped={stg['overlapped']}"
        )
    tail = summ.get("tail", {})
    if any(tail.values()):
        bits.append(
            f"hedges={tail['hedges']}(w{tail['hedge_wins']}) "
            f"stalls={tail['stalls']} breaker={tail['breaker_events']}"
        )
    tn = summ.get("tune", {})
    if tn.get("decisions"):
        bits.append(
            f"tune={tn['decisions']}d/{tn['accepts']}a/{tn['reverts']}r"
        )
    mem = summ.get("membership", {})
    if mem.get("events"):
        bits.append(
            f"membership ev={mem['events']} epoch={mem['last_epoch']} "
            f"handoff={mem['handoff_bytes']}B"
        )
    srv = summ.get("serve", {})
    if srv.get("requests") or srv.get("shed"):
        bits.append(
            f"serve req={srv['requests']} shed={srv['shed']} "
            f"dl_miss={srv['deadline_misses']}"
        )
    if pipe.get("steps"):
        bits.append(
            f"steps={pipe['steps']} "
            f"waited={pipe['steps_with_data_wait']}"
        )
    if bits:
        lines.append("  ".join(bits))
    lines.append("phase segments (ms):        p50        p99")
    for name, s in summ.get("phases", {}).items():
        lines.append(
            f"  {name:<16} {s['p50_ms']:>10.3f} {s['p99_ms']:>10.3f}"
            f"   n={s['count']}"
        )
    rows = summ.get("stragglers", {}).get("by_host", [])
    gp_hosts = gp.get("hosts", {})
    roll_hosts = roll.get("hosts", {})
    ages = {f["host"]: f["age_s"] for f in files}
    if rows:
        lines.append("hosts (slowest p99 first; * = straggler):")
        for i, r in enumerate(rows):
            h = r["host"]

            def _g(d, key=h):
                e = d.get(key) or d.get(str(key)) or {}
                return e.get("gbps", 0.0)

            straggler = i == 0 and len(rows) > 1
            mark = "*" if straggler else " "
            row = (
                f"{mark} host={h!s:<4} n={r['count']:<6} "
                f"p50={r['p50_ms']:9.3f}  p99={r['p99_ms']:9.3f}  "
                f"tail_share={r['tail_share']:.2f}  "
                f"rolling={_g(roll_hosts):.4f} GB/s  "
                f"age={ages.get(h, 0.0):.1f}s"
            )
            lines.append(c(_RED, row) if straggler else row)
    return "\n".join(lines)


def run_top(bases: list[str], interval_s: float = 2.0, once: bool = False,
            window_s: float = 10.0, color: Optional[bool] = None,
            iterations: Optional[int] = None) -> int:
    """The ``top`` loop: poll, render, repeat. ``--once``
    prints one plain frame and exits (the CI/tests mode); interactive
    mode clears the screen per frame and exits on Ctrl-C."""
    agg = LiveAggregator(bases, window_s=window_s)
    if color is None:
        color = (not once) and sys.stdout.isatty()
    n = 0
    try:
        while True:
            frame = render_top(agg.poll(), color=color)
            if once:
                print(frame)
                return 0
            sys.stdout.write(_CLEAR + frame + "\n")
            sys.stdout.flush()
            n += 1
            if iterations is not None and n >= iterations:
                return 0
            time.sleep(interval_s)
    except KeyboardInterrupt:
        return 0
