"""Kubernetes backend for the control plane.

The reference controller talks to kube-apiserver through the generated
clientset (`pkg/client/clientset/versioned/typed/paddlepaddle/
v1/trainingjob.go:33-153`) and `client-go` REST machinery. This package is the
from-scratch equivalent, built on the stdlib only (no `kubernetes`
client package is needed):

- :mod:`edl_tpu_torch.k8s.config`  — kubeconfig / in-cluster credential loading
  (ref: `cmd/edl/edl.go:31-36` rest.InClusterConfig | BuildConfigFromFlags).
- :mod:`edl_tpu_torch.k8s.client`  — minimal REST client: CRUD + PATCH + chunked
  watch streams against the apiserver.
- :mod:`edl_tpu_torch.k8s.cluster` — ``K8sCluster``: the real ``ClusterProvider``
  (node/pod scans à la `pkg/cluster.go:176-242`, role creation as
  Deployments/Jobs, `spec.parallelism` patch as the scale actuator).
- :mod:`edl_tpu_torch.k8s.store`   — ``K8sJobStore``: TrainingJob CRD client +
  informer-style list/watch with status-subresource writeback
  (ref: `pkg/client/.../trainingjob.go:102-115`, `pkg/controller.go:79-108`).

Copies of the JAX package's ``edl_tpu/k8s/`` with the imports pointing at
this package. One difference: the accelerator's node resource is
``nvidia.com/gpu`` (`cluster.ACCELERATOR_RESOURCE`), not ``google.com/tpu``.
"""

from edl_tpu_torch.k8s.client import ApiClient, ApiError
from edl_tpu_torch.k8s.cluster import K8sCluster
from edl_tpu_torch.k8s.config import KubeConfig
from edl_tpu_torch.k8s.store import K8sJobStore

__all__ = [
    "ApiClient",
    "ApiError",
    "K8sCluster",
    "K8sJobStore",
    "KubeConfig",
]
