"""Minimal Kubernetes REST client: CRUD, PATCH, and chunked watch streams.

Plays the role client-go's rest.Client plays for the reference controller
(every `clientset.*` call in `pkg/cluster.go:91-291` and
`pkg/client/clientset/versioned/typed/paddlepaddle/v1/trainingjob.go:44-153`
is an HTTPS round trip built by machinery like this). Stdlib-only:
`http.client` + `ssl` + `json`.

Connections are per-request — simple, thread-safe, and proxy-free; watch
streams hold their connection open and yield decoded events line by line
(the apiserver emits one JSON watch event per newline-delimited chunk).

A copy of the JAX package's ``edl_tpu/k8s/client.py`` with the imports
pointing at this package.
"""

from __future__ import annotations

import http.client
import json
import socket
import urllib.parse
from typing import Any, Dict, Iterator, Optional, Tuple

from edl_tpu_torch.k8s.config import KubeConfig

#: media types the apiserver distinguishes PATCH flavors by.
MERGE_PATCH = "application/merge-patch+json"
STRATEGIC_PATCH = "application/strategic-merge-patch+json"
JSON = "application/json"


class ApiError(Exception):
    """Non-2xx apiserver response, carrying the Status body when present."""

    def __init__(self, status: int, reason: str, body: Any = None):
        self.status = status
        self.reason = reason
        self.body = body
        message = reason
        if isinstance(body, dict) and body.get("message"):
            message = body["message"]
        super().__init__(f"{status} {message}")

    @property
    def not_found(self) -> bool:
        return self.status == 404

    @property
    def conflict(self) -> bool:
        return self.status == 409

    @property
    def gone(self) -> bool:  # watch resourceVersion too old → relist
        return self.status == 410


class ApiClient:
    """One apiserver endpoint, dialed with a :class:`KubeConfig`."""

    def __init__(self, config: KubeConfig, timeout: float = 30.0):
        self.config = config
        self.timeout = timeout
        parsed = urllib.parse.urlsplit(config.host)
        self._https = parsed.scheme == "https"
        self._netloc = parsed.netloc
        self._base_path = parsed.path.rstrip("/")

    # -- connection plumbing ---------------------------------------------------

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        if self._https:
            return http.client.HTTPSConnection(
                self._netloc, timeout=timeout, context=self.config.ssl_context()
            )
        return http.client.HTTPConnection(self._netloc, timeout=timeout)

    def _url(self, path: str, params: Optional[Dict[str, Any]] = None) -> str:
        url = self._base_path + path
        if params:
            filtered = {k: v for k, v in params.items() if v is not None}
            if filtered:
                url += "?" + urllib.parse.urlencode(filtered)
        return url

    def _issue(
        self,
        method: str,
        path: str,
        body: Optional[dict],
        params: Optional[Dict[str, Any]],
        content_type: str,
        timeout: float,
    ) -> Tuple[http.client.HTTPConnection, http.client.HTTPResponse]:
        conn = self._connect(timeout)
        headers = {"Accept": JSON, **self.config.auth_headers()}
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = content_type
        try:
            conn.request(method, self._url(path, params), body=payload, headers=headers)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException):
            conn.close()
            raise
        return conn, resp

    @staticmethod
    def _decode(resp: http.client.HTTPResponse) -> Any:
        raw = resp.read()
        if not raw:
            return None
        try:
            return json.loads(raw)
        except json.JSONDecodeError:
            return raw.decode(errors="replace")

    # -- request surface -------------------------------------------------------

    def request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        params: Optional[Dict[str, Any]] = None,
        content_type: str = JSON,
    ) -> Any:
        conn, resp = self._issue(method, path, body, params, content_type, self.timeout)
        try:
            data = self._decode(resp)
            if resp.status >= 300:
                raise ApiError(resp.status, resp.reason or "", data)
            return data
        finally:
            conn.close()

    def get(self, path: str, params: Optional[Dict[str, Any]] = None) -> Any:
        return self.request("GET", path, params=params)

    def post(self, path: str, body: dict) -> Any:
        return self.request("POST", path, body=body)

    def put(self, path: str, body: dict) -> Any:
        return self.request("PUT", path, body=body)

    def patch(self, path: str, body: dict, content_type: str = MERGE_PATCH) -> Any:
        return self.request("PATCH", path, body=body, content_type=content_type)

    def delete(
        self, path: str, params: Optional[Dict[str, Any]] = None,
        body: Optional[dict] = None,
    ) -> Any:
        return self.request("DELETE", path, body=body, params=params)

    # -- watch -----------------------------------------------------------------

    def watch(
        self,
        path: str,
        params: Optional[Dict[str, Any]] = None,
        timeout_seconds: float = 300.0,
    ) -> Iterator[dict]:
        """Stream watch events: yields ``{"type": ..., "object": {...}}``.

        The socket read timeout is padded past the server-side
        ``timeoutSeconds`` so a quiet-but-healthy stream is ended by the
        server's graceful close, not a client-side socket error. Ends
        normally at stream close; callers loop with the last seen
        resourceVersion (informer relist/rewatch semantics,
        ref: `pkg/controller.go:79-108`).
        """
        params = dict(params or {})
        params["watch"] = "true"
        params.setdefault("timeoutSeconds", int(timeout_seconds))
        conn, resp = self._issue(
            "GET", path, None, params, JSON, timeout_seconds + 30.0
        )
        try:
            if resp.status >= 300:
                raise ApiError(resp.status, resp.reason or "", self._decode(resp))
            buffer = b""
            while True:
                try:
                    chunk = resp.read1(65536)
                except (socket.timeout, TimeoutError):
                    return
                if not chunk:
                    return
                buffer += chunk
                while b"\n" in buffer:
                    line, buffer = buffer.split(b"\n", 1)
                    line = line.strip()
                    if not line:
                        continue
                    event = json.loads(line)
                    if event.get("type") == "ERROR":
                        obj = event.get("object", {}) or {}
                        raise ApiError(
                            int(obj.get("code", 500)),
                            obj.get("reason", "watch error"),
                            obj,
                        )
                    yield event
        finally:
            conn.close()
