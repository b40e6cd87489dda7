"""Fault-tolerant elastic fit_a_line trainer: the port of
`examples/fit_a_line/train_elastic.py`.

Run as ``python -m edl_tpu_torch.examples.fit_a_line.train_elastic``. The
``EDL_*`` env protocol points at the coordinator; shards are leased and
membership changes trigger checkpoint-restore rescale. The JAX entry takes
no arguments; the port adds ``--device`` (default: the card; ``cpu`` asks
for the CPU) and the CTR entry's ``--dist-backend``.

- cloud (``EDL_COORDINATOR_ENDPOINT`` set): the process group is formed
  from the coordinator (`examples._common.cloud_bring_up`) and a
  `MultiHostWorker` trains in lockstep with its peers;
- local (no env set): an in-process coordinator seeded with 8 shards and
  an `ElasticWorker`.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

from edl_tpu_torch.examples._common import cloud_bring_up
from edl_tpu_torch.launcher.launch import LaunchContext
from edl_tpu_torch.models import fit_a_line
from edl_tpu_torch.runtime import (ElasticConfig, ElasticWorker, MultiHostWorker,
                                   SyntheticShardSource)
from edl_tpu_torch.runtime.data import shard_names
from edl_tpu_torch.runtime.train_loop import TrainerConfig


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="fit_a_line elastic training")
    parser.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo", "auto"),
                        help="torch.distributed backend of the process group "
                             "(cloud mode); auto: nccl when every rank has a card "
                             "of its own, else gloo")
    parser.add_argument("--device", default=None,
                        help="device to train on (default: the card; 'cpu' asks "
                             "for the CPU)")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    ctx = LaunchContext.from_env()
    model = fit_a_line.MODEL
    source = SyntheticShardSource(model, batch_size=256, batches_per_shard=20)

    ident = None
    device = args.device
    if os.environ.get("EDL_COORDINATOR_ENDPOINT"):
        client, ident, device = cloud_bring_up(ctx, args.dist_backend, device)
    else:  # hermetic demo mode
        from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

        # Single local worker: lease expiry can only duplicate work, so
        # leases and membership outlast any first-step stall.
        coord = InProcessCoordinator(task_lease_sec=300.0,
                                     heartbeat_ttl_sec=300.0)
        coord.add_tasks(ctx.data_shards or shard_names("uci", 8))
        client = coord.client("worker-0")
        ctx.checkpoint_dir = ctx.checkpoint_dir or tempfile.mkdtemp(prefix="edl-fit-")

    cfg = ElasticConfig(
        checkpoint_dir=ctx.checkpoint_dir,
        checkpoint_interval=ctx.checkpoint_interval,
        trainer=TrainerConfig(optimizer="sgd", learning_rate=1e-2),
    )
    if ident is not None:  # lockstep rounds + warm-restart rescale
        worker = MultiHostWorker(model, client, source, cfg, device=device)
    else:
        worker = ElasticWorker(model, client, source, cfg, device=device)
    metrics = worker.run()
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
