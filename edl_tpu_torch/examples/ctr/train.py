"""CTR deep-wide elastic trainer — the flagship workload: the port of
`examples/ctr/train.py`.

Run as ``python -m edl_tpu_torch.examples.ctr.train``: that is the
``EDL_ENTRY`` the port's launcher execs, and relaunches when the entry
exits `RESCALE_EXIT_CODE`. The argparse surface is the JAX entry's, plus
``--dist-backend`` (``nccl`` on the cards, ``gloo`` for ranks sharing one
card or the CPU, ``auto`` to pick one of them from the world the
incarnation joins, so a relaunch at another world size may change it),
``--device`` (default: the card; ``cpu`` asks for the CPU) and the LM
entry's ``--zero1`` (ZeRO-1 optimizer moments).

Modes, as in the JAX entry:

- cloud (``EDL_COORDINATOR_ENDPOINT`` set): the process group is formed
  from the coordinator (`runtime.distributed.distributed_init`) and a
  `MultiHostWorker` trains in lockstep with its peers — at world 1 too,
  since the port forms a group at every world size (the JAX entry runs an
  `ElasticWorker` when its world is 1). A rescale is exit 75 and a
  relaunch at the new world;
- local: an in-process coordinator and an `ElasticWorker`.

Data modes (ref per-trainer shard download, `train.py:221-227`):

- default: hermetic ``SyntheticShardSource`` (batches derived from shard ids);
- ``--prepare N --data-dir D``: materialize N on-disk ``.npz`` click-log
  shards (deliberately uneven row counts unless ``--even``) and exit;
- ``--data-dir D``: train from those files via ``FileShardSource``.

``--batch-size`` is each process's batch: a rank's share of the global
batch, which is the batch times the world.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

import numpy as np

from edl_tpu_torch.examples._common import cloud_bring_up
from edl_tpu_torch.launcher.launch import LaunchContext
from edl_tpu_torch.models import ctr
from edl_tpu_torch.runtime import (ElasticConfig, ElasticWorker, FileShardSource,
                                   MultiHostWorker, SyntheticShardSource, pass_tasks,
                                   write_shard)
from edl_tpu_torch.runtime.data import shard_names, shard_seed
from edl_tpu_torch.runtime.train_loop import TrainerConfig


def parse_args(argv: Optional[List[str]] = None):
    # Config surface kept close to the reference's (train.py:28-117).
    parser = argparse.ArgumentParser(description="CTR deep-wide elastic training")
    parser.add_argument("--batch-size", type=int, default=8192)
    parser.add_argument("--sparse-feature-dim", type=int, default=ctr.SPARSE_DIM)
    parser.add_argument("--learning-rate", type=float, default=0.05)
    parser.add_argument("--batches-per-shard", type=int, default=50)
    parser.add_argument("--shard-axis", default="data",
                        help="mesh axis the sparse tables shard over")
    parser.add_argument("--data-dir", default=os.environ.get("EDL_DATA_DIR", ""),
                        help="train from .npz shards under this directory")
    parser.add_argument("--prepare", type=int, default=0, metavar="N",
                        help="write N click-log shards to --data-dir and exit")
    parser.add_argument("--rows-per-shard", type=int, default=0,
                        help="base rows per prepared shard "
                             "(default: 4 x batch size)")
    parser.add_argument("--even", action="store_true",
                        help="prepare equal-size shards (default: uneven)")
    parser.add_argument("--num-passes", type=int,
                        default=os.environ.get("EDL_PASSES", "1"),
                        help="dataset epochs (ref --num_passes). Cloud mode "
                             "seeds passes launcher-side from spec.passes; "
                             "this flag drives the local twin")
    parser.add_argument("--shuffle-seed", type=int, default=None,
                        help="deterministic within-shard row shuffle "
                             "(ref paddle.reader.shuffle, train.py:124-126)")
    parser.add_argument("--prefetch", action="store_true",
                        help="load the next shard off-thread while training "
                             "(ref py_reader double buffering, train.py:120-129)")
    parser.add_argument("--wire-transport", action="store_true",
                        help="compact host->device batch codec (bf16/u8/u24)")
    parser.add_argument("--export-dir", default="",
                        help="write a serving artifact here periodically "
                             "(ref save_inference_model, train.py:169-180)")
    parser.add_argument("--export-interval", type=int, default=1000,
                        help="steps between exports (ref: every 1000 batches)")
    parser.add_argument("--infer", action="store_true",
                        help="load the --export-dir artifact and score a "
                             "held-out batch instead of training")
    parser.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo", "auto"),
                        help="torch.distributed backend of the process group "
                             "(cloud mode); auto: nccl when every rank has a card "
                             "of its own, else gloo")
    parser.add_argument("--zero1", action="store_true",
                        help="shard the optimizer moments over the data axis "
                             "(the LM entry's flag)")
    parser.add_argument("--device", default=None,
                        help="device to train on (default: the card; 'cpu' "
                             "asks for the CPU)")
    return parser.parse_args(argv)


def infer(args) -> None:
    """Serving-side half of the reference's save-then-infer flow."""
    from edl_tpu_torch.runtime import load_inference_model

    art = load_inference_model(args.export_dir, device=args.device)
    batch = art.model.synthetic_batch(np.random.default_rng(123), args.batch_size)
    logits = art.predict({k: v for k, v in batch.items()
                          if k != "label"}).float().cpu().numpy()
    prob = 1.0 / (1.0 + np.exp(-logits))
    # logloss against the held-out labels (the training objective)
    y = batch["label"].astype(np.float64)
    eps = 1e-7
    logloss = float(np.mean(
        -(y * np.log(prob + eps) + (1 - y) * np.log(1 - prob + eps))
    ))
    print(json.dumps({"step": art.step, "examples": int(logits.shape[0]),
                      "mean_ctr": round(float(prob.mean()), 4),
                      "logloss": round(logloss, 4)}))


def prepare(args) -> None:
    """Materialize deterministic click-log shards on disk.

    Shard i's rows derive from a seed of its id, so any trainer preparing
    the same dataset writes bit-identical files. Row counts are uneven by
    default — the case the lockstep padding machinery exists for.
    """
    base = args.rows_per_shard or 4 * args.batch_size
    written = {}
    for shard in shard_names("criteo", args.prepare):
        rng = np.random.default_rng(shard_seed(shard))
        rows = base if args.even else base + int(rng.integers(0, base))
        batch = ctr.synthetic_batch(rng, rows, args.sparse_feature_dim)
        write_shard(args.data_dir, shard, batch)
        written[shard] = rows
    print(json.dumps({"prepared": len(written), "rows": written,
                      "data_dir": args.data_dir}))


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    if args.prepare:
        if not args.data_dir:
            raise SystemExit("--prepare requires --data-dir")
        prepare(args)
        return
    if args.infer:
        if not args.export_dir:
            raise SystemExit("--infer requires --export-dir")
        infer(args)
        return
    ctx = LaunchContext.from_env()
    model = ctr.make_model(shard_axis=args.shard_axis,
                           sparse_dim=args.sparse_feature_dim)
    if args.data_dir:
        source = FileShardSource(root=args.data_dir, batch_size=args.batch_size,
                                 shuffle_seed=args.shuffle_seed)
    else:
        source = SyntheticShardSource(model, batch_size=args.batch_size,
                                      batches_per_shard=args.batches_per_shard)

    ident = None
    device = args.device
    if os.environ.get("EDL_COORDINATOR_ENDPOINT"):  # cloud mode (ref :192-203)
        client, ident, device = cloud_bring_up(ctx, args.dist_backend, device)
        if args.num_passes != ctx.passes:
            print(f"note: cloud mode seeds passes launcher-side "
                  f"(spec.passes={ctx.passes}); --num-passes {args.num_passes} "
                  f"has no effect here")
    else:  # local twin
        from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

        # Single local worker: lease expiry can only duplicate work, so
        # leases and membership outlast any first-step stall.
        coord = InProcessCoordinator(task_lease_sec=300.0,
                                     heartbeat_ttl_sec=300.0)
        if args.data_dir:
            shards = ctx.data_shards or source.list_shards()
        else:
            shards = ctx.data_shards or shard_names("criteo", 4)
        # Multi-pass: each pass's visit of each shard is its own lease
        # (ref --num_passes loops the dataset, docker/paddle_k8s:205-216).
        coord.add_tasks(pass_tasks(shards, args.num_passes))
        client = coord.client("worker-0")
        ctx.checkpoint_dir = ctx.checkpoint_dir or tempfile.mkdtemp(prefix="edl-ctr-")

    cfg = ElasticConfig(
        checkpoint_dir=ctx.checkpoint_dir,
        checkpoint_interval=ctx.checkpoint_interval,
        prefetch=args.prefetch,
        trainer=TrainerConfig(optimizer="adagrad",
                              learning_rate=args.learning_rate,
                              wire_transport=args.wire_transport,
                              shard_opt_state=args.zero1),
    )
    mesh_axes = {k: v for k, v in ctx.mesh_axes.items() if k != "data"} or None
    if ident is not None:
        # One mesh over every process, lockstep rounds; rescale is a
        # launcher warm restart (a process group's world is fixed at init).
        worker = MultiHostWorker(model, client, source, cfg, device=device,
                                 mesh_axes=mesh_axes)
    else:
        worker = ElasticWorker(model, client, source, cfg, device=device,
                               mesh_axes=mesh_axes)
    exporter = None
    if args.export_dir:
        from edl_tpu_torch.runtime import PeriodicExporter

        # Every rank gathers the tables with the others; rank 0 writes
        # (ref trainer-0's duty, train.py:169-180).
        exporter = PeriodicExporter(
            args.export_dir, "ctr", args.export_interval,
            config={"shard_axis": args.shard_axis,
                    "sparse_dim": args.sparse_feature_dim})

        def export(step, state):
            exporter.mesh = worker.mesh  # the current incarnation's
            exporter(step, state)

        cfg.step_callback = export
    metrics = worker.run()
    if exporter is not None:
        exporter.wait()  # surface a failed background artifact write
        metrics["exports"] = float(exporter.exports)
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
