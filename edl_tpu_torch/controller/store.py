"""TrainingJob store with watch semantics.

The analog of the reference's typed CRD client + shared informer + fake
clientset stack (`pkg/client/clientset/versioned/typed/paddlepaddle/v1/
trainingjob.go:33-153`, `pkg/client/informers/externalversions/factory.go:43-117`,
`pkg/client/clientset/versioned/fake/clientset_generated.go:32-69`): typed
CRUD + status writeback over an in-memory object map, with registered watchers
receiving add/update/delete callbacks synchronously — the delivery contract
`cache.NewInformer` gives the reference controller (`pkg/controller.go:79-108`).

A Kubernetes-backed implementation would satisfy the same ``JobStore``
protocol via the CRD REST API; everything above this interface (controller,
updaters, autoscaler) is oblivious to which one it runs on.

A copy of the JAX package's ``edl_tpu/controller/store.py`` with the
imports pointing at this package.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Dict, List, Optional, Protocol

from edl_tpu_torch.api.types import TrainingJob, TrainingJobStatus


class Watcher(Protocol):
    """Informer-style event sink (ref: cache.ResourceEventHandler)."""

    def on_add(self, job: TrainingJob) -> None: ...

    def on_update(self, job: TrainingJob) -> None: ...

    def on_del(self, job: TrainingJob) -> None: ...


class FuncWatcher:
    """Adapter: build a Watcher from plain callables (any may be None)."""

    def __init__(
        self,
        on_add: Optional[Callable[[TrainingJob], None]] = None,
        on_update: Optional[Callable[[TrainingJob], None]] = None,
        on_del: Optional[Callable[[TrainingJob], None]] = None,
    ):
        self._add, self._update, self._del = on_add, on_update, on_del

    def on_add(self, job: TrainingJob) -> None:
        if self._add:
            self._add(job)

    def on_update(self, job: TrainingJob) -> None:
        if self._update:
            self._update(job)

    def on_del(self, job: TrainingJob) -> None:
        if self._del:
            self._del(job)


class JobStore:
    """In-memory TrainingJob apiserver: CRUD + status subresource + watch.

    Objects are deep-copied on the way in and out (the k8s client convention),
    so a caller mutating its copy cannot corrupt the stored object — status
    changes flow only through ``update_status``, spec changes through
    ``update``.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._jobs: Dict[str, TrainingJob] = {}
        self._watchers: List[Watcher] = []

    @staticmethod
    def _key(name: str, namespace: str) -> str:
        return f"{namespace}/{name}"

    # -- watch ----------------------------------------------------------------

    def watch(self, watcher: Watcher, replay: bool = True) -> None:
        """Register a watcher; with ``replay`` it receives on_add for every
        existing job first (informer initial-list semantics)."""
        with self._lock:
            self._watchers.append(watcher)
            existing = [copy.deepcopy(j) for j in self._jobs.values()] if replay else []
        for job in existing:
            watcher.on_add(job)

    def unwatch(self, watcher: Watcher) -> None:
        """Deregister; a stopped consumer must not keep receiving events."""
        with self._lock:
            self._watchers = [w for w in self._watchers if w is not watcher]

    def _notify(self, kind: str, job: TrainingJob) -> None:
        for w in list(self._watchers):
            getattr(w, f"on_{kind}")(copy.deepcopy(job))

    # -- CRUD (ref: typed/paddlepaddle/v1/trainingjob.go:33-153) ---------------

    def create(self, job: TrainingJob) -> TrainingJob:
        with self._lock:
            key = self._key(job.name, job.namespace)
            if key in self._jobs:
                raise KeyError(f"trainingjob {key} already exists")
            self._jobs[key] = copy.deepcopy(job)
            stored = copy.deepcopy(self._jobs[key])
        self._notify("add", stored)
        return stored

    def get(self, name: str, namespace: str = "default") -> TrainingJob:
        with self._lock:
            key = self._key(name, namespace)
            if key not in self._jobs:
                raise KeyError(f"trainingjob {key} not found")
            return copy.deepcopy(self._jobs[key])

    def list(self, namespace: Optional[str] = None) -> List[TrainingJob]:
        with self._lock:
            return [
                copy.deepcopy(j)
                for j in self._jobs.values()
                if namespace is None or j.namespace == namespace
            ]

    def update(self, job: TrainingJob) -> TrainingJob:
        """Replace the spec/metadata; the stored status is preserved
        (status is a subresource, ref: UpdateStatus :102-115)."""
        with self._lock:
            key = self._key(job.name, job.namespace)
            if key not in self._jobs:
                raise KeyError(f"trainingjob {key} not found")
            kept_status = self._jobs[key].status
            stored = copy.deepcopy(job)
            stored.status = kept_status
            self._jobs[key] = stored
            out = copy.deepcopy(stored)
        self._notify("update", out)
        return out

    def update_status(
        self, name: str, status: TrainingJobStatus, namespace: str = "default"
    ) -> TrainingJob:
        with self._lock:
            key = self._key(name, namespace)
            if key not in self._jobs:
                raise KeyError(f"trainingjob {key} not found")
            self._jobs[key].status = copy.deepcopy(status)
            out = copy.deepcopy(self._jobs[key])
        self._notify("update", out)
        return out

    def delete(self, name: str, namespace: str = "default") -> TrainingJob:
        with self._lock:
            key = self._key(name, namespace)
            if key not in self._jobs:
                raise KeyError(f"trainingjob {key} not found")
            job = self._jobs.pop(key)
        self._notify("del", job)
        return job
