"""Cluster credential loading: kubeconfig files and in-cluster serviceaccounts.

The reference builds its REST config with client-go's two standard paths
(`cmd/edl/edl.go:31-36`): ``rest.InClusterConfig()`` when no
``--kubeconfig`` flag is given, else ``clientcmd.BuildConfigFromFlags``. This
module reimplements both on the stdlib: YAML kubeconfig parsing with contexts,
bearer tokens, basic auth, client certificates (file or inline base64 data),
and the in-cluster serviceaccount mount.

A copy of the JAX package's ``edl_tpu/k8s/config.py`` with the imports
pointing at this package.
"""

from __future__ import annotations

import base64
import os
import ssl
import tempfile
from dataclasses import dataclass, field
from typing import Optional

#: default serviceaccount mount (the same well-known path client-go uses).
SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ConfigError(Exception):
    """Credential material missing or malformed."""


@dataclass
class KubeConfig:
    """Everything needed to dial one apiserver.

    ``token_file`` (when set) is re-read on every request so rotated
    serviceaccount tokens keep working across long controller runs.
    """

    host: str  # base URL, e.g. "https://10.0.0.1:6443"
    token: Optional[str] = None
    token_file: Optional[str] = None
    username: Optional[str] = None
    password: Optional[str] = None
    ca_cert_path: Optional[str] = None
    ca_cert_data: Optional[str] = None  # PEM text
    client_cert_path: Optional[str] = None
    client_key_path: Optional[str] = None
    verify_tls: bool = True
    namespace: str = "default"
    #: temp files backing inline cert data; held so they outlive the config.
    _tempfiles: list = field(default_factory=list, repr=False)

    # -- constructors ----------------------------------------------------------

    @classmethod
    def in_cluster(cls, sa_dir: str = SERVICEACCOUNT_DIR) -> "KubeConfig":
        """Serviceaccount credentials from the pod filesystem
        (ref: rest.InClusterConfig, `cmd/edl/edl.go:32`)."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise ConfigError(
                "KUBERNETES_SERVICE_HOST not set; not running inside a cluster"
            )
        token_file = os.path.join(sa_dir, "token")
        if not os.path.exists(token_file):
            raise ConfigError(f"serviceaccount token missing at {token_file}")
        ns_file = os.path.join(sa_dir, "namespace")
        namespace = "default"
        if os.path.exists(ns_file):
            with open(ns_file) as f:
                namespace = f.read().strip() or "default"
        ca = os.path.join(sa_dir, "ca.crt")
        if ":" in host and not host.startswith("["):  # bare IPv6
            host = f"[{host}]"
        return cls(
            host=f"https://{host}:{port}",
            token_file=token_file,
            ca_cert_path=ca if os.path.exists(ca) else None,
            namespace=namespace,
        )

    @classmethod
    def from_kubeconfig(
        cls, path: Optional[str] = None, context: Optional[str] = None
    ) -> "KubeConfig":
        """Parse a kubeconfig file (ref: BuildConfigFromFlags, `edl.go:34-36`).

        Honors ``$KUBECONFIG`` and falls back to ``~/.kube/config``; selects
        ``context`` or the file's ``current-context``.
        """
        import yaml

        path = path or os.environ.get("KUBECONFIG") or os.path.expanduser(
            "~/.kube/config"
        )
        if not os.path.exists(path):
            raise ConfigError(f"kubeconfig not found at {path}")
        with open(path) as f:
            doc = yaml.safe_load(f) or {}

        def by_name(section: str, name: str) -> dict:
            for entry in doc.get(section) or []:
                if entry.get("name") == name:
                    return entry.get(section.rstrip("s"), {}) or {}
            raise ConfigError(f"kubeconfig has no {section!r} entry named {name!r}")

        ctx_name = context or doc.get("current-context")
        if not ctx_name:
            raise ConfigError("kubeconfig has no current-context and none was given")
        ctx = by_name("contexts", ctx_name)
        cluster = by_name("clusters", ctx["cluster"])
        user = by_name("users", ctx["user"]) if ctx.get("user") else {}

        cfg = cls(
            host=cluster.get("server", "").rstrip("/"),
            namespace=ctx.get("namespace", "default"),
            verify_tls=not cluster.get("insecure-skip-tls-verify", False),
        )
        if not cfg.host:
            raise ConfigError(f"cluster {ctx['cluster']!r} has no server URL")

        cfg.ca_cert_path = cluster.get("certificate-authority")
        if cluster.get("certificate-authority-data"):
            cfg.ca_cert_data = base64.b64decode(
                cluster["certificate-authority-data"]
            ).decode()

        cfg.token = user.get("token")
        if user.get("tokenFile"):
            cfg.token_file = user["tokenFile"]
        cfg.username = user.get("username")
        cfg.password = user.get("password")
        cfg.client_cert_path = user.get("client-certificate")
        cfg.client_key_path = user.get("client-key")
        # Inline cert data must land in files: ssl.load_cert_chain takes paths.
        if user.get("client-certificate-data"):
            cfg.client_cert_path = cfg._materialize(
                user["client-certificate-data"], "client.crt"
            )
        if user.get("client-key-data"):
            cfg.client_key_path = cfg._materialize(user["client-key-data"], "client.key")
        return cfg

    def _materialize(self, b64data: str, suffix: str) -> str:
        # delete=True + a live handle in _tempfiles: the path stays valid for
        # ssl.load_cert_chain while the config lives, and close (explicit, GC,
        # or interpreter exit) unlinks it — key material never outlives us.
        tf = tempfile.NamedTemporaryFile(mode="wb", suffix=f"-{suffix}")
        tf.write(base64.b64decode(b64data))
        tf.flush()
        self._tempfiles.append(tf)
        return tf.name

    # -- request-time material -------------------------------------------------

    def bearer_token(self) -> Optional[str]:
        if self.token_file:
            try:
                with open(self.token_file) as f:
                    return f.read().strip()
            except OSError as e:
                raise ConfigError(f"cannot read token file {self.token_file}: {e}")
        return self.token

    def auth_headers(self) -> dict:
        tok = self.bearer_token()
        if tok:
            return {"Authorization": f"Bearer {tok}"}
        if self.username is not None:
            cred = base64.b64encode(
                f"{self.username}:{self.password or ''}".encode()
            ).decode()
            return {"Authorization": f"Basic {cred}"}
        return {}

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        """Build the TLS context for an https host; None for plain http."""
        if not self.host.startswith("https"):
            return None
        ctx = ssl.create_default_context()
        if not self.verify_tls:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        else:
            if self.ca_cert_path:
                ctx.load_verify_locations(cafile=self.ca_cert_path)
            elif self.ca_cert_data:
                ctx.load_verify_locations(cadata=self.ca_cert_data)
        if self.client_cert_path:
            ctx.load_cert_chain(self.client_cert_path, self.client_key_path)
        return ctx
