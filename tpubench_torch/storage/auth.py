"""Token sources (``tpubench/storage/auth.py``, reference ``auth.go``).

Reference order: service-account key file if given
(``newTokenSourceFromPath``, auth.go:28-51), else Application Default
Credentials (``google.DefaultTokenSource``, auth.go:55-68), with the
full-control GCS scope (auth.go:60). Both come from ``google.auth``,
imported only inside :class:`GoogleTokenSource`: a run against a test
server's endpoint is anonymous and never reaches it. On a machine
without ``google-auth`` a Google endpoint fails when the source is built,
with the ``ImportError``, as in ``tpubench``.
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Protocol

GCS_SCOPE = "https://www.googleapis.com/auth/devstorage.full_control"  # auth.go:60


class TokenSource(Protocol):
    def token(self) -> Optional[str]:
        """A bearer token, or None for an unauthenticated transport."""
        ...


class AnonymousTokenSource:
    """For test servers and local paths: no Authorization header."""

    def token(self) -> Optional[str]:
        return None


class GoogleTokenSource:
    """ADC or a service-account key file, refreshed when the credentials
    are no longer valid."""

    def __init__(self, key_file: str = ""):
        import google.auth  # only a Google endpoint needs it

        if key_file:
            from google.oauth2 import service_account

            self._creds = service_account.Credentials.from_service_account_file(
                key_file, scopes=[GCS_SCOPE]
            )
        else:
            self._creds, _ = google.auth.default(scopes=[GCS_SCOPE])
        self._lock = threading.Lock()

    def token(self) -> Optional[str]:
        with self._lock:
            if not self._creds.valid:
                import google.auth.transport.requests

                self._creds.refresh(google.auth.transport.requests.Request())
            return self._creds.token


def make_token_source(key_file: str, endpoint: str) -> TokenSource:
    """An endpoint that is not Google's is anonymous, whatever the key
    file says (hermetic runs)."""
    if endpoint and "googleapis.com" not in endpoint:
        return AnonymousTokenSource()
    return GoogleTokenSource(key_file)


class StaticTokenSource:
    """A fixed token until ``ttl_s`` passes (tests)."""

    def __init__(self, tok: str, ttl_s: float = 3600.0):
        self._tok = tok
        self._exp = time.monotonic() + ttl_s

    def token(self) -> Optional[str]:
        return self._tok if time.monotonic() < self._exp else None
