"""Transformer LM elastic trainer: the port of `examples/lm/train.py`.

Run as ``python -m edl_tpu_torch.examples.lm.train``. The argparse surface
is the JAX entry's, plus ``--dist-backend`` and ``--device`` (see the CTR
entry). Mesh axes come from ``EDL_MESH_AXES`` (the controller's env
protocol) or ``--axes``; the port trains data-parallel (and with
``--zero1``, ZeRO-1): a ``seq``, ``model``, ``pipe`` or ``expert`` axis
above 1 raises ``NotImplementedError`` (ROADMAP.md queue A item 5). Runs
standalone (no env): spawns an in-process coordinator and trains the whole
queue on the card with an `ElasticWorker`; in cloud mode a
`MultiHostWorker` per rank.

    python -m edl_tpu_torch.examples.lm.train --seq-len 512 --remat --zero1
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

from edl_tpu_torch.examples._common import cloud_bring_up
from edl_tpu_torch.launcher.launch import LaunchContext
from edl_tpu_torch.models import transformer
from edl_tpu_torch.runtime import (ElasticConfig, ElasticWorker, MultiHostWorker,
                                   SyntheticShardSource, pass_tasks)
from edl_tpu_torch.runtime.data import shard_names
from edl_tpu_torch.runtime.train_loop import TrainerConfig


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Transformer LM elastic training")
    p.add_argument("--vocab-size", type=int, default=8192)
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--n-layers", type=int, default=4)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--d-ff", type=int, default=1024)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--batches-per-shard", type=int, default=4)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--axes", default=os.environ.get("EDL_MESH_AXES", "{}"),
                   help='non-data mesh axes, e.g. \'{"seq":2,"model":2}\'')
    p.add_argument("--remat", action="store_true",
                   help="per-block activation rematerialization")
    p.add_argument("--pipeline-schedule", default="gpipe",
                   choices=("gpipe", "1f1b"),
                   help="microbatch schedule on the pipe axis: gpipe "
                        "(default) or the O(pp)-activation 1f1b")
    p.add_argument("--microbatches", type=int, default=None,
                   help="pipeline microbatches (default: pipe size)")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer moments over the data axis")
    p.add_argument("--moe-experts", type=int, default=0,
                   help="switch-routed experts over the expert axis "
                        "(0 = dense FFN)")
    p.add_argument("--moe-aux-weight", type=float, default=0.01,
                   help="load-balance aux weight when --moe-experts > 0 "
                        "(non-pipelined meshes)")
    p.add_argument("--num-passes", type=int,
                   default=os.environ.get("EDL_PASSES", "1"))
    p.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo", "auto"),
                   help="torch.distributed backend of the process group "
                        "(cloud mode); auto: nccl when every rank has a card of "
                        "its own, else gloo")
    p.add_argument("--device", default=None,
                   help="device to train on (default: the card; 'cpu' asks "
                        "for the CPU)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    ctx = LaunchContext.from_env()
    # Drop the data axis: workers size it from the world (same rule as
    # ctr/train.py).
    axes = {k: int(v) for k, v in json.loads(args.axes).items()
            if k != "data" and int(v) > 1}
    moe = int(args.moe_experts)
    # aux loss does not thread through pipeline hop buffers — drop it, not
    # the run, when the user asked for MoE over a pipe axis
    aux = args.moe_aux_weight if (moe and "pipe" not in axes) else 0.0
    model = transformer.make_model(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, d_ff=args.d_ff,
        seq_len=args.seq_len, remat=args.remat,
        pipeline_schedule=args.pipeline_schedule,
        microbatches=args.microbatches,
        moe_experts=moe,
        moe_aux_weight=aux,
        # tokens shard over the expert axis too (the efficient layout)
        batch_axis=("data", "expert") if moe else "data",
    )
    if moe and "pipe" in axes and args.moe_aux_weight:
        print("note: load-balance aux loss disabled on pipelined meshes")
    source = SyntheticShardSource(model, batch_size=args.batch_size,
                                  batches_per_shard=args.batches_per_shard)

    ident = None
    device = args.device
    if os.environ.get("EDL_COORDINATOR_ENDPOINT"):  # cloud mode
        client, ident, device = cloud_bring_up(ctx, args.dist_backend, device)
        if int(args.num_passes) != ctx.passes:
            print(f"note: cloud mode seeds passes launcher-side "
                  f"(spec.passes={ctx.passes}); --num-passes "
                  f"{args.num_passes} has no effect here")
    else:  # local twin
        from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

        coord = InProcessCoordinator(task_lease_sec=300.0,
                                     heartbeat_ttl_sec=300.0)
        coord.add_tasks(pass_tasks(
            ctx.data_shards or shard_names("lm", args.shards),
            int(args.num_passes),
        ))
        client = coord.client("worker-0")
        ctx.checkpoint_dir = ctx.checkpoint_dir or tempfile.mkdtemp(prefix="edl-lm-")

    cfg = ElasticConfig(
        checkpoint_dir=ctx.checkpoint_dir,
        checkpoint_interval=ctx.checkpoint_interval,
        trainer=TrainerConfig(optimizer="adam",
                              learning_rate=args.learning_rate,
                              shard_opt_state=args.zero1,
                              batch_axis=model.config.batch_axis),
    )
    if ident is not None:
        worker = MultiHostWorker(model, client, source, cfg, device=device,
                                 mesh_axes=axes or None)
    else:
        worker = ElasticWorker(model, client, source, cfg, device=device,
                               mesh_axes=axes or None)
    metrics = worker.run()
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
