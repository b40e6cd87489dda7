"""What the entries share: cloud-mode bring-up on the coordinator, and the
device each process trains on."""

from __future__ import annotations

import os
from typing import Optional, Tuple


def cloud_bring_up(ctx, backend: str, device: Optional[str]) -> Tuple[object, object, object]:
    """Cloud mode (``EDL_COORDINATOR_ENDPOINT`` set): the coordinator
    client, the process group's identity and this rank's device.

    The worker's name is the pod's (``EDL_POD_NAME``) when the pod sets
    one, so a relaunched entry takes over its predecessor's membership and
    leases; else ``<job>-worker-<pid>``, as the JAX package's entries name
    it. The process group is formed at every world size, 1 included
    (`runtime.distributed.distributed_init`), with ``backend`` (``auto``:
    ``nccl`` when the world fits one rank a card, else ``gloo``). Without
    ``device`` a rank trains on the card ``rank % device_count`` and makes
    it current."""
    import torch

    from edl_tpu_torch.launcher.discovery import wait_coordinator
    from edl_tpu_torch.runtime.distributed import distributed_init, expected_world

    client = wait_coordinator(ctx.coordinator_endpoint)
    client.worker = os.environ.get("EDL_POD_NAME") or f"{ctx.job_name}-worker-{os.getpid()}"
    if backend == "auto":
        # NCCL takes one rank a card; ranks that share one (or the CPU) use gloo
        own_card = (device != "cpu" and torch.cuda.is_available()
                    and expected_world(ctx, client) <= torch.cuda.device_count())
        backend = "nccl" if own_card else "gloo"
    ident = distributed_init(ctx, client, backend=backend)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu to "
                               "train on the CPU")
        index = ident.process_id % torch.cuda.device_count()
        torch.cuda.set_device(index)
        device = f"cuda:{index}"
    return client, ident, device
