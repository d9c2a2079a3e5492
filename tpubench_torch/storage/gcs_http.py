"""GCS JSON-API backend — the part of ``tpubench/storage/gcs_http.py``'s
``GcsHttpBackend`` that the native fetch executor needs: endpoint
parsing, the request parts the engine sends (path, headers), and ``stat``
(one metadata GET over ``http.client``, plain or TLS) to size each
object before the timed window.

Not ported yet (ROADMAP A.2), and refused with ``NotImplementedError``:
``open_read`` (the Python-pool route over http) and token sources (a
Google endpoint needs credentials); ``config.refuse_unported`` refuses
``transport.http2`` and ``transport.key_file`` before a backend opens.
An endpoint that is not a Google one is anonymous, as in ``tpubench``.
"""

from __future__ import annotations

import http.client
import json
import ssl
import urllib.parse
from typing import Optional

from tpubench_torch.config import TransportConfig
from tpubench_torch.storage.base import ObjectMeta, StorageError

DEFAULT_ENDPOINT = "https://storage.googleapis.com"

# Status codes the GCS client treats as transient (storage/invoke.go upstream
# semantics: 408, 429, 5xx).
_TRANSIENT = {408, 429, 500, 502, 503, 504}


class GcsHttpBackend:
    """Request construction and ``stat`` for one bucket at one endpoint;
    shared by every worker (it holds no connection between calls)."""

    def __init__(self, bucket: str, transport: Optional[TransportConfig] = None):
        self.bucket = bucket
        self.transport = transport or TransportConfig()
        t = self.transport
        endpoint = t.endpoint or DEFAULT_ENDPOINT
        if "googleapis.com" in endpoint:
            raise NotImplementedError(
                "GCS token sources (default credentials, transport.key_file) "
                "are not ported to tpubench_torch yet (ROADMAP A.2: "
                "http/grpc/local backends); give a non-Google "
                "transport.endpoint"
            )
        u = urllib.parse.urlsplit(endpoint)
        self._scheme = u.scheme
        self._host = u.hostname or "storage.googleapis.com"
        self._port = u.port or (443 if self._scheme == "https" else 80)
        self._ctx = None
        if self._scheme == "https":
            self._ctx = ssl.create_default_context(cafile=t.tls_ca_file or None)
            if t.tls_insecure_skip_verify:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE

    @property
    def scheme(self) -> str:
        return self._scheme

    def native_request_parts(self, name: str) -> tuple:
        """(host, port, path, header-block) for a native-engine GET of
        ``name``. Called per request, as in ``tpubench``, where it keeps
        bearer tokens fresh."""
        headers = "".join(
            f"{k}: {v}\r\n"
            for k, v in self._headers().items()
            if k.lower() != "host"  # the engine sets Host itself
        )
        return self._host, self._port, self._opath(name) + "?alt=media", headers

    def _headers(self) -> dict[str, str]:
        return {
            "User-Agent": self.transport.user_agent,
            "Host": f"{self._host}:{self._port}",
        }

    def _opath(self, name: str) -> str:
        return (
            f"/storage/v1/b/{urllib.parse.quote(self.bucket, safe='')}"
            f"/o/{urllib.parse.quote(name, safe='')}"
        )

    def _connection(self) -> http.client.HTTPConnection:
        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._host, self._port, context=self._ctx, timeout=60
            )
        return http.client.HTTPConnection(self._host, self._port, timeout=60)

    def stat(self, name: str) -> ObjectMeta:
        path = self._opath(name)
        conn = self._connection()
        try:
            conn.request("GET", path, headers=self._headers())
            resp = conn.getresponse()
            payload = resp.read()
        except (http.client.HTTPException, OSError) as e:
            raise StorageError(f"GET {path}: {e}", transient=True) from e
        finally:
            conn.close()
        if resp.status not in (200, 206):
            raise StorageError(
                f"GET {path} -> {resp.status}: "
                f"{payload[:200].decode('utf-8', 'replace')}",
                transient=resp.status in _TRANSIENT,
                code=resp.status,
            )
        meta = json.loads(payload)
        return ObjectMeta(
            meta["name"], int(meta["size"]), int(meta.get("generation", 0))
        )

    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        raise NotImplementedError(
            "reads over http through the Python worker pool are not ported "
            "to tpubench_torch yet (ROADMAP A.2: http/grpc/local backends); "
            "use fetch_executor='native'"
        )

    def close(self) -> None:
        pass
