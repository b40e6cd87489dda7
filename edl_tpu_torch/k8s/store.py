"""K8sJobStore: the TrainingJob CRD client + informer.

Production implementation of the ``JobStore`` surface
(`edl_tpu/controller/store.py`), equivalent to the reference's generated typed
client + shared informer (`pkg/client/clientset/versioned/
typed/paddlepaddle/v1/trainingjob.go:33-153`, `pkg/client/informers/
externalversions/factory.go:43-117`) driving `cache.NewInformer`
(`pkg/controller.go:79-108`):

- CRUD against ``/apis/edl.tpu/v1/.../trainingjobs`` (the CRD installed by
  `deploy/crd.yaml`), status writes through the ``/status`` subresource
  (ref: UpdateStatus, `trainingjob.go:102-115`).
- A single background list+watch loop maintaining a local cache and fanning
  add/update/delete events out to registered watchers; 410 Gone triggers a
  relist with diff-based event replay (informer resync semantics).

Errors map onto the in-memory store's contract: missing objects raise
``KeyError`` so the controller/updater code runs unchanged on either backend.

A copy of the JAX package's ``edl_tpu/k8s/store.py`` with the imports
pointing at this package.
"""

from __future__ import annotations

import copy
import logging
import threading
import time
from typing import Dict, List, Optional

from edl_tpu_torch.api.types import TrainingJob, TrainingJobStatus
from edl_tpu_torch.controller.store import Watcher
from edl_tpu_torch.k8s.client import ApiClient, ApiError

log = logging.getLogger("edl_tpu_torch.k8s.store")

GROUP_VERSION = "edl.tpu/v1"
PLURAL = "trainingjobs"


def to_crd(job: TrainingJob) -> dict:
    body = job.to_dict()
    body["apiVersion"] = GROUP_VERSION
    body["kind"] = "TrainingJob"
    return body


def from_crd(obj: dict) -> TrainingJob:
    return TrainingJob.from_dict(obj)


class K8sJobStore:
    """TrainingJob CRUD + watch over the CRD REST API."""

    def __init__(
        self,
        api: ApiClient,
        namespace: Optional[str] = None,
        watch_timeout_seconds: float = 300.0,
    ):
        self.api = api
        self.namespace = namespace or api.config.namespace or "default"
        self.watch_timeout_seconds = watch_timeout_seconds
        self._lock = threading.RLock()
        self._watchers: List[Watcher] = []
        self._cache: Dict[str, TrainingJob] = {}  # ns/name -> last seen
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- paths -----------------------------------------------------------------

    def _path(self, name: str = "", namespace: Optional[str] = None) -> str:
        ns = namespace or self.namespace
        path = f"/apis/{GROUP_VERSION}/namespaces/{ns}/{PLURAL}"
        return f"{path}/{name}" if name else path

    @property
    def _all_ns_path(self) -> str:
        return f"/apis/{GROUP_VERSION}/{PLURAL}"

    @property
    def _watch_path(self) -> str:
        """The informer's scope: the managed namespace only. A controller
        watching all namespaces but materializing workloads into its own
        (K8sCluster is namespace-scoped) would adopt foreign jobs and drop
        their pods in the wrong place."""
        return self._path()

    @staticmethod
    def _key(name: str, namespace: str) -> str:
        return f"{namespace}/{name}"

    # -- CRUD (ref: typed/paddlepaddle/v1/trainingjob.go:44-153) ---------------

    def create(self, job: TrainingJob) -> TrainingJob:
        try:
            out = self.api.post(self._path(namespace=job.namespace), to_crd(job))
        except ApiError as e:
            if e.conflict:
                raise KeyError(
                    f"trainingjob {job.namespace}/{job.name} already exists"
                ) from e
            raise
        return from_crd(out)

    def get(self, name: str, namespace: str = "default") -> TrainingJob:
        try:
            return from_crd(self.api.get(self._path(name, namespace)))
        except ApiError as e:
            if e.not_found:
                raise KeyError(f"trainingjob {namespace}/{name} not found") from e
            raise

    def list(self, namespace: Optional[str] = None) -> List[TrainingJob]:
        path = self._all_ns_path if namespace is None else self._path(
            namespace=namespace
        )
        return [from_crd(o) for o in self.api.get(path).get("items", [])]

    def update(self, job: TrainingJob) -> TrainingJob:
        """Replace spec/labels; status is a subresource and survives untouched
        (a merge patch cannot write it through the main resource)."""
        try:
            out = self.api.patch(
                self._path(job.name, job.namespace),
                {
                    "metadata": {"labels": dict(job.labels)},
                    "spec": job.spec.to_dict(),
                },
            )
        except ApiError as e:
            if e.not_found:
                raise KeyError(
                    f"trainingjob {job.namespace}/{job.name} not found"
                ) from e
            raise
        return from_crd(out)

    def update_status(
        self, name: str, status: TrainingJobStatus, namespace: str = "default"
    ) -> TrainingJob:
        body = to_crd(TrainingJob(name=name, namespace=namespace, status=status))
        last: Optional[ApiError] = None
        for attempt in range(4):
            try:
                out = self.api.patch(
                    self._path(name, namespace) + "/status",
                    {"status": body["status"]},
                )
                return from_crd(out)
            except ApiError as e:
                if e.not_found:
                    raise KeyError(
                        f"trainingjob {namespace}/{name} not found"
                    ) from e
                if not e.conflict:
                    raise
                # 409 on the status subresource: a concurrent writer moved
                # the rv between our read and write. A merge patch carries
                # no rv, so the retry applies our intent to the fresh
                # object — the standard controller-side conflict loop.
                last = e
                time.sleep(0.02 * (attempt + 1))
        raise last  # conflicts 4x in a row: surface it

    def delete(self, name: str, namespace: str = "default") -> TrainingJob:
        try:
            existing = self.get(name, namespace)
            self.api.delete(self._path(name, namespace))
        except ApiError as e:
            if e.not_found:
                raise KeyError(f"trainingjob {namespace}/{name} not found") from e
            raise
        return existing

    # -- watch / informer ------------------------------------------------------

    def watch(self, watcher: Watcher, replay: bool = True) -> None:
        """Register a watcher; replays the current cache (after a synchronous
        initial list on first use) as on_add, then streams live events."""
        with self._lock:
            first = self._thread is None
            if first:
                self._initial_list()
            self._watchers.append(watcher)
            snapshot = (
                [copy.deepcopy(j) for j in self._cache.values()] if replay else []
            )
            if first:
                self._thread = threading.Thread(
                    target=self._run, name="edl-k8s-informer", daemon=True
                )
                self._thread.start()
        for job in snapshot:
            watcher.on_add(job)

    def unwatch(self, watcher: Watcher) -> None:
        with self._lock:
            self._watchers = [w for w in self._watchers if w is not watcher]

    def stop(self) -> None:
        self._stop.set()

    def _notify(self, kind: str, job: TrainingJob) -> None:
        with self._lock:
            watchers = list(self._watchers)
        for w in watchers:
            try:
                getattr(w, f"on_{kind}")(copy.deepcopy(job))
            except Exception:
                log.exception("watcher %s failed on %s", w, kind)

    # -- informer internals ----------------------------------------------------

    def _initial_list(self) -> None:
        data = self.api.get(self._watch_path)
        self._resource_version = (data.get("metadata", {}) or {}).get(
            "resourceVersion", ""
        )
        self._cache = {
            self._key(j.name, j.namespace): j
            for j in (from_crd(o) for o in data.get("items", []))
        }

    def _relist(self) -> None:
        """List from scratch and emit the diff vs the cache (post-410 resync)."""
        data = self.api.get(self._watch_path)
        fresh = {
            self._key(j.name, j.namespace): j
            for j in (from_crd(o) for o in data.get("items", []))
        }
        with self._lock:
            self._resource_version = (data.get("metadata", {}) or {}).get(
                "resourceVersion", ""
            )
            old = self._cache
            self._cache = fresh
        for key, job in fresh.items():
            if key not in old:
                self._notify("add", job)
            elif job.to_dict() != old[key].to_dict():
                self._notify("update", job)
        for key, job in old.items():
            if key not in fresh:
                self._notify("del", job)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                for event in self.api.watch(
                    self._watch_path,
                    params={"resourceVersion": self._resource_version},
                    timeout_seconds=self.watch_timeout_seconds,
                ):
                    if self._stop.is_set():
                        return
                    self._handle(event)
                # normal stream end → rewatch from last seen version
            except ApiError as e:
                if e.gone:
                    try:
                        self._relist()
                    except Exception:
                        log.exception("informer relist failed")
                        self._stop.wait(1.0)
                else:
                    log.warning("watch failed (%s); retrying", e)
                    self._stop.wait(1.0)
            except Exception as e:
                log.warning("watch stream error (%s); retrying", e)
                self._stop.wait(1.0)

    def _handle(self, event: dict) -> None:
        obj = event.get("object", {}) or {}
        rv = (obj.get("metadata", {}) or {}).get("resourceVersion")
        if rv:
            with self._lock:
                self._resource_version = rv
        kind = event.get("type")
        if kind == "BOOKMARK":
            # rv-progress marker (metadata-only object): advance the
            # cursor — already done above — and deliver nothing.
            return
        job = from_crd(obj)
        key = self._key(job.name, job.namespace)
        if kind == "ADDED":
            with self._lock:
                known = key in self._cache
                self._cache[key] = job
            # A re-watch can replay an ADDED for an object the cache already
            # has; deliver it as an update so consumers stay idempotent.
            self._notify("update" if known else "add", job)
        elif kind == "MODIFIED":
            with self._lock:
                self._cache[key] = job
            self._notify("update", job)
        elif kind == "DELETED":
            with self._lock:
                self._cache.pop(key, None)
            self._notify("del", job)
