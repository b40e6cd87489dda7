"""Discovery helpers: the `k8s_tools.py` equivalent.

The reference derives rank and endpoints from K8s API polling — sorted pod
names, index-of-self (`docker/k8s_tools.py:108-163`), 5 s sleep loops
(`:70-78`). Here the coordinator is the single source of truth: ranks are
leased at register time (dense, re-packed on churn), world size is live
membership, and waiting is a blocking RPC, not a sleep loop.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from edl_tpu_torch.coordinator.client import CoordinatorClient, CoordinatorError


def parse_endpoint(endpoint: str, default_port: int = 7164) -> Tuple[str, int]:
    """Split "host:port" (the EDL_COORDINATOR_ENDPOINT format)."""
    if ":" in endpoint:
        host, port = endpoint.rsplit(":", 1)
        return host, int(port)
    return endpoint, default_port


def coordinator_client(
    endpoint: str, worker: str = "", connect_timeout: float = 10.0
) -> CoordinatorClient:
    host, port = parse_endpoint(endpoint)
    return CoordinatorClient(host=host, port=port, worker=worker,
                             connect_timeout=connect_timeout)


def wait_coordinator(endpoint: str, timeout: float = 300.0) -> CoordinatorClient:
    """Block until the coordinator answers ping (ref: wait_pods_running's
    poll-5s loop, `docker/k8s_tools.py:70-78`, minus the sleeps)."""
    host, port = parse_endpoint(endpoint)
    deadline = time.monotonic() + timeout
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            c = CoordinatorClient(host=host, port=port, connect_timeout=2.0)
            if c.ping():
                return c
            c.close()
        except (CoordinatorError, OSError) as e:
            last = e
        time.sleep(0.2)
    raise CoordinatorError(f"coordinator at {endpoint} never became ready: {last}")


def fetch_rank(client: CoordinatorClient) -> int:
    """This worker's dense rank (ref: fetch_id = index of own pod in the
    sorted name list, `docker/k8s_tools.py:127-151` — which silently reuses
    ranks when pods churn; leased ranks cannot collide)."""
    return int(client.register()["rank"])


def fetch_world(client: CoordinatorClient) -> int:
    return int(client.register()["world"])


def wait_members(client: CoordinatorClient, count: int, timeout: float = 300.0) -> int:
    """Block until at least ``count`` workers registered; returns the world
    size (ref: the launcher's wait-for-pservers/trainers barriers,
    `docker/paddle_k8s:128-130`)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        world = len(client.members())
        if world >= count:
            return world
        time.sleep(0.2)
    raise CoordinatorError(f"only {len(client.members())}/{count} members after {timeout}s")
