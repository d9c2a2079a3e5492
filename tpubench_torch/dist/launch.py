"""Local ranks: one process per card of this host, started, watched and
ended together.

``tpubench``'s one process meshes every chip it sees (``make_mesh``
defaults to ``jax.devices()``, ``tpubench/dist/reassemble.py:61-64``), and
a pod of H hosts is H such processes (``--num-processes H --process-id h
--coordinator c``). NCCL takes one rank per GPU, so the port's
counterpart is one process per visible card: :func:`launch` runs a
command of the CLI on host h as L rank processes of ``python -m
tpubench_torch.cli <argv>``; local rank l is global rank h·L + l of a
world of H·L, on ``cuda:l`` (``bringup.rank_device``). The launcher gives
each rank its place (:class:`Member`) in the environment, and a rank
takes it from there alone: the argv it runs is the host's, whose
``--num-processes``/``--process-id`` name the host, not the rank. The
ranks meet at the host's ``--coordinator`` (host 0's local rank 0 serves
it), or, on one host, at a free loopback port. ``CUDA_VISIBLE_DEVICES``
picks the cards, as ``TPU_VISIBLE_CHIPS`` picks the chips.

:func:`run_ranks` is the part every multi-process runner shares
(``cli.main``, ``dist/sweep.py``'s pod sizes, ``scripts/coop_pod.py``):
it starts one process a rank, each in a session of its own, sends each
rank's output to its log (and a chosen rank's also to this process's
stdout and stderr), and when one rank fails or the deadline passes it
kills the others, which would otherwise wait in a collective. Every
process it started, and everything they started, has ended when it
returns.

    python -m tpubench_torch.cli pod-ingest ...   # on a host of 4 cards:
                                                  # 4 ranks, one per card
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

_PACKAGE_ROOT = Path(__file__).resolve().parents[2]
# Set in every rank that :func:`launch` starts: its place in the pod (the
# command's result is global rank 0's alone, ``cli.finish``, and each rank
# prints its rank line).
LOCAL_RANKS_ENV = "TPUBENCH_LOCAL_RANKS"
RANK_ENV = "TPUBENCH_RANK"
WORLD_ENV = "TPUBENCH_WORLD_SIZE"
RENDEZVOUS_ENV = "TPUBENCH_RENDEZVOUS"
# Seconds a launched command's ranks may run (one deadline for all).
DEADLINE_ENV = "TPUBENCH_LAUNCH_DEADLINE_S"
DEFAULT_DEADLINE_S = 24 * 3600.0
RANK_LOG_DIR = "rank_logs"


def launched_ranks() -> int:
    """The rank count of the :func:`launch` that started this process; 0
    in a process it did not start."""
    return int(os.environ.get(LOCAL_RANKS_ENV) or 0)


@dataclass(frozen=True)
class Member:
    """A process's place in its pod: global ``rank`` of ``world``, one of
    the ``local_ranks`` its host runs, and the rendezvous ``address``
    (host:port)."""

    rank: int
    world: int
    local_ranks: int = 1
    address: str = ""

    @property
    def local_rank(self) -> int:
        """The rank's index on its host (its card, ``cuda:local_rank``)."""
        return self.rank % self.local_ranks

    @property
    def host(self) -> int:
        """The host's index (``--process-id``)."""
        return self.rank // self.local_ranks

    @property
    def hosts(self) -> int:
        """The pod's host count (``--num-processes``)."""
        return self.world // self.local_ranks


def member(dist_cfg) -> Member:
    """This process's :class:`Member`: from the environment :func:`launch`
    gave it, and only from there, when it started this process; else one
    process on its host, rank ``process_id`` of ``num_processes``."""
    env = os.environ
    if env.get(RANK_ENV):
        return Member(int(env[RANK_ENV]), int(env[WORLD_ENV]),
                      int(env[LOCAL_RANKS_ENV]), env[RENDEZVOUS_ENV])
    return Member(dist_cfg.process_id, max(1, dist_cfg.num_processes),
                  address=dist_cfg.coordinator_address)


@dataclass
class Ranks:
    """What :func:`run_ranks` saw: each rank's exit code (negative: the
    signal that ended it), pid and log, the rank whose failure ended the
    run (None if none failed) and whether the deadline did."""

    rcs: list
    pids: list
    logs: list
    first_failed: Optional[int] = None
    timed_out: bool = False
    failed: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.timed_out and all(rc == 0 for rc in self.rcs)

    def tail(self, rank: int, nbytes: int = 2000) -> str:
        """The last ``nbytes`` of rank ``rank``'s log."""
        try:
            with open(self.logs[rank], "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def exit_code(self) -> int:
        """0 when every rank exited 0; else the first failed rank's code
        (128 + the signal for a killed one), 124 at the deadline."""
        if self.ok:
            return 0
        if self.first_failed is None:
            return 124
        rc = self.rcs[self.first_failed]
        return 128 - rc if rc < 0 else rc


def _tee(src, sinks) -> None:
    """Copy ``src`` line by line into every sink until it closes."""
    for line in iter(src.readline, b""):
        for s in sinks:
            try:
                s.write(line)
                s.flush()
            except (OSError, ValueError):
                pass
    src.close()


class _Text:
    """A binary sink over a text stream (``sys.stdout`` may be replaced,
    as ``redirect_stdout`` does, by one without a buffer)."""

    def __init__(self, stream):
        self.stream = stream

    def write(self, data: bytes) -> None:
        self.stream.write(data.decode(errors="replace"))

    def flush(self) -> None:
        self.stream.flush()


def _kill_session(pid: int) -> None:
    """SIGKILL to the session a rank leads: the rank and whatever it
    started (a compiler, a server)."""
    try:
        os.killpg(pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def run_ranks(cmds: Sequence[Sequence[str]], logs: Sequence[str], *,
              envs: Optional[Sequence[dict]] = None,
              passthrough: Sequence[int] = (),
              deadline_s: float = DEFAULT_DEADLINE_S,
              poll_s: float = 0.05) -> Ranks:
    """Run ``cmds[r]`` as rank r for every r, its stdout and stderr into
    ``logs[r]`` (a rank in ``passthrough`` also onto this process's
    stdout and stderr), until all have exited, one has failed or
    ``deadline_s`` has passed; then kill what still runs. Returns the
    :class:`Ranks`; raises nothing for a failed rank."""
    n = len(cmds)
    envs = list(envs) if envs is not None else [None] * n
    procs: list = []
    files: list = []
    threads: list = []
    out = Ranks(rcs=[None] * n, pids=[], logs=[str(p) for p in logs])
    deadline = time.monotonic() + deadline_s
    prev_term = None
    if threading.current_thread() is threading.main_thread():
        # A SIGTERM to this process must end its ranks too.
        def _term(signum, frame):
            raise SystemExit(128 + signum)

        prev_term = signal.signal(signal.SIGTERM, _term)
    try:
        for r, cmd in enumerate(cmds):
            os.makedirs(os.path.dirname(out.logs[r]) or ".", exist_ok=True)
            log = open(out.logs[r], "wb")
            files.append(log)
            tee = r in passthrough
            p = subprocess.Popen(
                list(cmd), env=envs[r], start_new_session=True,
                stdin=subprocess.DEVNULL,
                stdout=subprocess.PIPE if tee else log,
                stderr=subprocess.PIPE if tee else subprocess.STDOUT,
            )
            procs.append(p)
            out.pids.append(p.pid)
            if tee:
                for src, dst in ((p.stdout, sys.stdout), (p.stderr, sys.stderr)):
                    t = threading.Thread(target=_tee, args=(src, [log, _Text(dst)]),
                                         daemon=True, name=f"rank{r}-tee")
                    t.start()
                    threads.append(t)
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                out.first_failed = bad[0]
                break
            if all(c is not None for c in codes):
                break
            if time.monotonic() > deadline:
                out.timed_out = True
                break
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                _kill_session(p.pid)
        for p in procs:
            p.wait()
            _kill_session(p.pid)  # what a finished rank left behind
        for t in threads:
            t.join(timeout=5.0)
        for f in files:
            f.close()
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    out.rcs = [p.returncode for p in procs]
    out.failed = [r for r, rc in enumerate(out.rcs) if rc != 0]
    return out


def child_env() -> dict:
    """This process's environment with the package root on
    ``PYTHONPATH`` and unbuffered output (a rank's lines reach its log as
    it prints them)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH", "")) if p)
    env["PYTHONUNBUFFERED"] = "1"
    return env


def rank_env(m: Member) -> dict:
    """:func:`child_env` with ``m``, the place of the rank it is for."""
    env = child_env()
    env[RANK_ENV] = str(m.rank)
    env[WORLD_ENV] = str(m.world)
    env[LOCAL_RANKS_ENV] = str(m.local_ranks)
    env[RENDEZVOUS_ENV] = m.address
    return env


def members(ranks: int, pod=None) -> list:
    """The :class:`Member` of each of the ``ranks`` rank processes this
    host launches: with ``pod`` (a ``DistConfig``) of ``num_processes`` H
    > 1, host ``process_id`` h's ranks h·ranks … h·ranks + ranks - 1 of
    H·ranks at its ``coordinator_address``; else the whole group, at a
    free loopback port."""
    from tpubench_torch.dist.bringup import free_port

    hosts = pod.num_processes if pod is not None else 1
    if hosts > 1:
        host, address = pod.process_id, pod.coordinator_address
    else:
        host, address = 0, f"127.0.0.1:{free_port()}"
    return [Member(host * ranks + r, hosts * ranks, ranks, address)
            for r in range(ranks)]


def launch(argv: Sequence[str], ranks: int, results_dir: str = "results",
           deadline_s: Optional[float] = None, pod=None) -> int:
    """Run ``python -m tpubench_torch.cli <argv>`` as ``ranks`` rank
    processes on this host; the command's exit code (0 only if every rank
    exited 0), each in the place :func:`members` gives it. Local rank 0's
    output passes through; every rank's output is also in
    ``<results_dir>/rank_logs/<cmd>-<time>-<pid>/rank<global rank>.log``.
    ``deadline_s`` (default ``$TPUBENCH_LAUNCH_DEADLINE_S`` or 24 h)
    bounds every rank."""
    if ranks < 2:
        raise ValueError(f"launch: {ranks} rank(s); run one in process")
    if deadline_s is None:
        deadline_s = float(os.environ.get(DEADLINE_ENV) or DEFAULT_DEADLINE_S)
    ms = members(ranks, pod)
    log_dir = os.path.join(
        results_dir, RANK_LOG_DIR,
        f"{argv[0]}-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}")
    cmd = [sys.executable, "-m", "tpubench_torch.cli", *argv]
    print(f"launch: ranks {ms[0].rank}-{ms[-1].rank} of {ms[0].world} "
          f"(host {ms[0].host} of {ms[0].hosts}), one a card; rank logs "
          f"under {log_dir}", file=sys.stderr, flush=True)
    res = run_ranks(
        [cmd] * ranks,
        [os.path.join(log_dir, f"rank{m.rank}.log") for m in ms],
        envs=[rank_env(m) for m in ms],
        passthrough=(0,), deadline_s=deadline_s,
    )
    if not res.ok:
        failed = res.first_failed
        why = (f"the deadline ({deadline_s:g} s) passed" if res.timed_out
               else f"rank {ms[failed].rank} exited {res.rcs[failed]}")
        print(f"launch: {why}; exit codes {res.rcs}", file=sys.stderr)
        for r in res.failed:
            if r != 0:  # local rank 0's output was shown as it ran
                print(f"--- rank {ms[r].rank} ({res.logs[r]}) ---\n"
                      f"{res.tail(r)}", file=sys.stderr)
    return res.exit_code()
