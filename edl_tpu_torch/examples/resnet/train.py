"""ResNet-50 elastic image-classification trainer: the port of
`examples/resnet/train.py`.

Run as ``python -m edl_tpu_torch.examples.resnet.train [train|infer]``.
``train`` runs an `ElasticWorker` over coordinator-leased shards
(checkpoint-restore rescale); ``infer`` restores the checkpoint and
classifies a held-out batch (seed 99). Defaults use the TINY config (32
px, width 8, 10 classes); ``--imagenet`` selects ResNet-50 at 224 px with
1000 classes. The argparse surface is the JAX entry's plus ``--device``
(default: the card; ``cpu`` asks for the CPU).

- cloud (``EDL_COORDINATOR_ENDPOINT`` set): the coordinator's client and an
  `ElasticWorker`, as the JAX entry runs (no process group);
- local: an in-process coordinator seeded with 6 shards.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch

from edl_tpu_torch.launcher.launch import LaunchContext
from edl_tpu_torch.models import resnet
from edl_tpu_torch.runtime import ElasticConfig, ElasticWorker, SyntheticShardSource
from edl_tpu_torch.runtime.data import shard_names
from edl_tpu_torch.runtime.train_loop import TrainerConfig

#: where ``train`` then ``infer`` meet without flags (the port's checkpoint
#: format, so not the JAX entry's directory)
DEFAULT_MODEL_DIR = "edl-torch-resnet-ckpt"


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="ResNet elastic training")
    p.add_argument("mode", nargs="?", default="train", choices=["train", "infer"])
    p.add_argument("--imagenet", action="store_true",
                   help="full ResNet-50/224px/1000-class configuration")
    p.add_argument("--depth", type=int, default=50, choices=sorted(resnet._STAGES))
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--batches-per-shard", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--model-dir", default=None)
    p.add_argument("--device", default=None,
                   help="device to run on (default: the card; 'cpu' asks for the CPU)")
    return p.parse_args(argv)


def make_model(args):
    if args.imagenet:
        cfg = resnet.ResNetConfig(depth=args.depth)
    else:
        cfg = resnet.ResNetConfig(
            depth=args.depth, num_classes=resnet.TINY.num_classes,
            image_size=resnet.TINY.image_size, width=resnet.TINY.width,
            gn_groups=resnet.TINY.gn_groups,
        )
    return resnet.make_model(cfg)


def train(args) -> None:
    ctx = LaunchContext.from_env()
    # Launcher-provided durable dir (EDL_CHECKPOINT_DIR) wins over the
    # fixed temp-dir fallback (fixed so a flagless `train` then `infer`
    # round-trips), like the sibling elastic entries.
    model_dir = (args.model_dir or ctx.checkpoint_dir
                 or os.path.join(tempfile.gettempdir(), DEFAULT_MODEL_DIR))
    model = make_model(args)
    source = SyntheticShardSource(model, batch_size=args.batch_size,
                                  batches_per_shard=args.batches_per_shard)

    if os.environ.get("EDL_COORDINATOR_ENDPOINT"):
        from edl_tpu_torch.launcher.discovery import wait_coordinator

        client = wait_coordinator(ctx.coordinator_endpoint)
        client.worker = (os.environ.get("EDL_POD_NAME")
                         or f"{ctx.job_name}-worker-{os.getpid()}")
    else:  # hermetic demo mode
        from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

        # One local worker: lease expiry can only duplicate work, so leases
        # and membership outlast any first-step stall.
        coord = InProcessCoordinator(task_lease_sec=600.0,
                                     heartbeat_ttl_sec=600.0)
        coord.add_tasks(ctx.data_shards or shard_names("imagenet", 6))
        client = coord.client("worker-0")

    cfg = ElasticConfig(
        checkpoint_dir=model_dir,
        checkpoint_interval=ctx.checkpoint_interval,
        trainer=TrainerConfig(optimizer="adam",
                              learning_rate=args.learning_rate),
    )
    worker = ElasticWorker(model, client, source, cfg, device=args.device)
    metrics = worker.run()
    print(json.dumps({**{k: round(v, 4) for k, v in metrics.items()},
                      "model_dir": model_dir}))


def infer(args) -> None:
    model_dir = (args.model_dir or os.environ.get("EDL_CHECKPOINT_DIR")
                 or os.path.join(tempfile.gettempdir(), DEFAULT_MODEL_DIR))
    from edl_tpu_torch.runtime import Checkpointer, Trainer

    model = make_model(args)
    trainer = Trainer(model, device=args.device, config=TrainerConfig())
    fresh = trainer.init_state()
    ckpt = Checkpointer(model_dir)
    if ckpt.latest_step() is None:
        raise SystemExit(f"no checkpoint under {model_dir}; run train first")
    state = ckpt.restore(fresh)
    batch = model.synthetic_batch(np.random.default_rng(99), 128)
    placed = trainer.place_batch(batch)
    with torch.no_grad():
        acc = float(resnet.accuracy(state.params, placed))
    print(json.dumps({"step": int(state.step), "accuracy": round(acc, 4)}))


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.mode == "train":
        train(args)
    else:
        infer(args)


if __name__ == "__main__":
    main()
