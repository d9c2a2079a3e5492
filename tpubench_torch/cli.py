"""tpubench_torch CLI: the ``read`` subcommand of ``tpubench`` on PyTorch
and CUDA, plus ``info`` (what the port would run on).

    python -m tpubench_torch.cli read --protocol fake --workers 2 \\
        --read-call-per-worker 2 --object-size 5242903 \\
        --staging device_put --validate --device cpu --results-dir /tmp/r

The other clients read from a server (``--endpoint``, ``--bucket``,
``--object-name-prefix``) or a directory (``--protocol local --dir``):
``--protocol http`` (HTTP/1.1; ``--native-receive``, ``--http2``,
``--fetch-executor native``) and ``--protocol grpc`` (``--native-receive``).

``read`` writes the same result JSON as ``tpubench read`` and prints its
path on the last line. It runs on CUDA unless ``--device cpu`` is given;
without a GPU it then exits nonzero instead of carrying on on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpubench_torch.config import BenchConfig
from tpubench_torch.metrics.report import RunResult, write_result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpubench_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info", help="print the device capability report")
    p = sub.add_parser("read", help="root read benchmark (main.go)")
    p.add_argument("--config", help="JSON config file (tpubench --save-config)")
    p.add_argument("--protocol", choices=("http", "grpc", "local", "fake"),
                   help="storage protocol: http (JSON API), grpc (storage "
                        "v2, wire client), local (files under --dir), fake "
                        "(in-process store)")
    p.add_argument("--endpoint",
                   help="storage endpoint: http(s)://host:port for http, "
                        "insecure://host:port (h2c) or host:port (TLS) for "
                        "grpc")
    p.add_argument("--dir", help="root directory of the local protocol")
    p.add_argument("--native-receive", action="store_true",
                   help="C++ receive: http bodies stream from the socket "
                        "into the staging slot; grpc ReadObject lands in a "
                        "native buffer (pooled keep-alive connections)")
    p.add_argument("--http2", action="store_true",
                   help="every http GET over the native HTTP/2 client (the "
                        "reference's ForceAttemptHTTP2 branch, "
                        "main.go:76-80); h2c on http, TLS+ALPN on https")
    p.add_argument("--tls-ca-file",
                   help="CA bundle to trust for TLS endpoints (test "
                        "endpoints with a private CA)")
    p.add_argument("--tls-insecure-skip-verify", action="store_true",
                   help="skip TLS certificate verification (self-signed "
                        "test endpoints only)")
    p.add_argument("--bucket", help="GCS bucket name")
    p.add_argument("--object-name-prefix", dest="object_name_prefix",
                   help="object i is <prefix><i>")
    p.add_argument("--fetch-executor",
                   choices=("python", "native", "native-reactor",
                            "native-threads"),
                   help="python = worker-thread pool; native = C++ reactor "
                        "executor (slot-range GETs land in the staging "
                        "slots); native-reactor/native-threads pin a shape")
    p.add_argument("--workers", type=int)
    p.add_argument("--read-call-per-worker", type=int, dest="read_calls")
    p.add_argument("--object-size", type=int, help="bytes (fake backend)")
    p.add_argument("--granule-bytes", type=int, help="fetch granule bytes")
    p.add_argument("--staging", choices=("none", "device_put", "pallas"),
                   help="device_put = copy ring; pallas = landing-kernel ring")
    p.add_argument("--validate", action="store_true",
                   help="device checksum of the landed bytes (copy ring)")
    p.add_argument("--depth", type=int, help="in-flight staging depth")
    p.add_argument("--no-double-buffer", action="store_true",
                   help="fully synchronous staging (depth 1)")
    p.add_argument("--slot-bytes", type=int,
                   help="staging slot target (capped by the host budget)")
    p.add_argument("--results-dir")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def build_config(args) -> BenchConfig:
    if args.config:
        with open(args.config) as f:
            cfg = BenchConfig.from_json(f.read())
    else:
        cfg = BenchConfig()
    w, s = cfg.workload, cfg.staging
    for attr, dest in (
        ("workers", "workers"), ("read_calls", "read_calls_per_worker"),
        ("object_size", "object_size"), ("granule_bytes", "granule_bytes"),
        ("bucket", "bucket"), ("object_name_prefix", "object_name_prefix"),
        ("fetch_executor", "fetch_executor"),
    ):
        v = getattr(args, attr)
        if v is not None:
            setattr(w, dest, v)
    t = cfg.transport
    if args.protocol:
        t.protocol = args.protocol
    if args.endpoint:
        t.endpoint = args.endpoint
    if args.dir:
        w.dir = args.dir
    if args.native_receive:
        t.native_receive = True
    if args.http2:
        t.http2 = True
    if args.tls_ca_file:
        t.tls_ca_file = args.tls_ca_file
    if args.tls_insecure_skip_verify:
        t.tls_insecure_skip_verify = True
    if args.staging:
        s.mode = args.staging
    if args.depth is not None:
        if args.depth < 1:
            raise SystemExit(f"--depth {args.depth}: must be >= 1")
        s.depth = args.depth
    if args.no_double_buffer:
        s.double_buffer = False
    if args.validate:
        s.validate_checksum = True
    if args.slot_bytes is not None:
        s.slot_bytes = args.slot_bytes
    if args.results_dir:
        cfg.obs.results_dir = args.results_dir
    return cfg


def read(cfg: BenchConfig, device="cuda", backend=None) -> RunResult:
    """The ``read`` command: stage through the ring ``cfg.staging.mode``
    selects, onto ``device``."""
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    return run_read(
        cfg, backend=backend, device=device,
        sink_factory=make_sink_factory(cfg, device=device),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "info":
        from tpubench_torch.device import capability_report

        print(json.dumps(capability_report()))
        return 0
    cfg = build_config(args)
    res = read(cfg, device=args.device)
    print(res.format())
    if "staging" in res.extra:
        from tpubench_torch.staging.stats import format_staging_block

        print(format_staging_block(res.extra["staging"]))
    path = write_result(res, cfg.obs.results_dir)
    print(f"result: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
