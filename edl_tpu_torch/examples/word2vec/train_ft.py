"""Fault-tolerant elastic word2vec trainer — the reference's flagship demo:
the port of `examples/word2vec/train_ft.py`.

Run as ``python -m edl_tpu_torch.examples.word2vec.train_ft``. The 5-gram
model trained with Adam at 3e-3 and a `StepProfiler`, whose ``profile_*``
keys join the printed summary. The JAX entry takes no arguments; the port
adds ``--device`` (default: the card; ``cpu`` asks for the CPU) and the CTR
entry's ``--dist-backend``.

- cloud (``EDL_COORDINATOR_ENDPOINT`` set): the process group is formed
  from the coordinator (`examples._common.cloud_bring_up`) and a
  `MultiHostWorker` trains in lockstep with its peers, the embedding table
  row-sharded over ``data`` (`models.word2vec`); a rescale is exit 75 and
  the launcher's relaunch at the new world;
- local (no env set): an in-process coordinator seeded with 8 shards and
  an `ElasticWorker` on the one device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

from edl_tpu_torch.examples._common import cloud_bring_up
from edl_tpu_torch.launcher.launch import LaunchContext
from edl_tpu_torch.models import word2vec
from edl_tpu_torch.runtime import (ElasticConfig, ElasticWorker, MultiHostWorker,
                                   SyntheticShardSource)
from edl_tpu_torch.runtime.data import shard_names
from edl_tpu_torch.runtime.train_loop import TrainerConfig
from edl_tpu_torch.tools import StepProfiler


def parse_args(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(description="word2vec elastic training")
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
    model = word2vec.MODEL
    source = SyntheticShardSource(model, batch_size=512, batches_per_shard=10)

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
        coord.add_tasks(ctx.data_shards or shard_names("imikolov", 8))
        client = coord.client("worker-0")
        ctx.checkpoint_dir = ctx.checkpoint_dir or tempfile.mkdtemp(prefix="edl-w2v-")

    prof = StepProfiler(warmup=1)
    cfg = ElasticConfig(
        checkpoint_dir=ctx.checkpoint_dir,
        checkpoint_interval=ctx.checkpoint_interval,
        # ref uses Adam(lr=3e-3) for this model (train_ft.py:102-104)
        trainer=TrainerConfig(optimizer="adam", learning_rate=3e-3),
    )
    if ident is not None:  # lockstep rounds + warm-restart rescale
        worker = MultiHostWorker(model, client, source, cfg, device=device, profiler=prof)
    else:
        worker = ElasticWorker(model, client, source, cfg, device=device, profiler=prof)
    metrics = worker.run()
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
