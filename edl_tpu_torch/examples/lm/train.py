"""Transformer LM elastic trainer: the port of `examples/lm/train.py`.

Run as ``python -m edl_tpu_torch.examples.lm.train``. The argparse surface
is the JAX entry's, plus ``--pipeline-schedule 1f1b-interleaved`` with
``--virtual-stages``, ``--dist-backend`` and ``--device`` (see the CTR
entry). Mesh axes come from ``EDL_MESH_AXES`` (the controller's env
protocol) or ``--axes``. Runs standalone (no env): spawns an in-process
coordinator and trains the whole queue on the card with an
`ElasticWorker`; in cloud mode a `MultiHostWorker` per rank.

A ``seq``, ``model``, ``pipe`` or ``expert`` axis above 1 trains on a mesh
of ranks: standalone, the entry starts one process a rank on this host
(the axes' product of them, a ``torch.distributed`` group over a
``file://`` rendezvous: gloo when the ranks share the card or run on the
CPU, NCCL when each has a card of its own), every rank trains the whole
queue's batches in order with the mesh Trainer, and rank 0 prints the
metrics. The elastic workers do not rescale such meshes yet (ROADMAP.md
queue A item 9): in cloud mode they raise.

    python -m edl_tpu_torch.examples.lm.train --seq-len 512 --remat --zero1
    python -m edl_tpu_torch.examples.lm.train --axes '{"seq": 2, "model": 2}' \
        --seq-len 512 --remat
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
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
                   choices=("gpipe", "1f1b", "1f1b-interleaved"),
                   help="microbatch schedule on the pipe axis: gpipe "
                        "(default), the O(pp)-activation 1f1b, or "
                        "1f1b-interleaved with --virtual-stages chunks a rank")
    p.add_argument("--virtual-stages", type=int, default=1,
                   help="chunks a pipe rank holds (1f1b-interleaved)")
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
        virtual_stages=args.virtual_stages,
        moe_experts=moe,
        moe_aux_weight=aux,
        # tokens shard over the expert axis too (the efficient layout)
        batch_axis=("data", "expert") if moe else "data",
    )
    if moe and "pipe" in axes and args.moe_aux_weight:
        print("note: load-balance aux loss disabled on pipelined meshes")
    source = SyntheticShardSource(model, batch_size=args.batch_size,
                                  batches_per_shard=args.batches_per_shard)
    if axes and not os.environ.get("EDL_COORDINATOR_ENDPOINT"):
        metrics = mesh_run(args, model.config, axes, ctx)
        print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))
        return

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


def mesh_run(args, config, axes, ctx) -> dict:
    """Standalone training on a mesh of ranks (see the module docstring):
    one process a rank on this host; returns rank 0's metrics."""
    import torch
    import torch.multiprocessing as mp

    world = math.prod(axes.values())
    with tempfile.TemporaryDirectory(prefix="edl-lm-mesh-") as root:
        mp.spawn(_mesh_rank, args=(world, args, config, axes, ctx.data_shards, root),
                 nprocs=world, join=True)
        return torch.load(os.path.join(root, "metrics.pt"))


def _mesh_rank(rank: int, world: int, args, config, axes, data_shards, root: str) -> None:
    """One rank of `mesh_run`: the mesh Trainer over every shard of every
    pass, in order, each rank cutting its part of each global batch."""
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from edl_tpu_torch.parallel.sharding import shard_batch
    from edl_tpu_torch.runtime.train_loop import Trainer

    device = args.device
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu to "
                               "train on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    backend = args.dist_backend
    if backend == "auto":
        backend = ("nccl" if device != "cpu" and world <= torch.cuda.device_count()
                   else "gloo")
    dist.init_process_group(backend, init_method=f"file://{root}/rendezvous",
                            world_size=world, rank=rank)
    model = transformer.make_model(config)
    source = SyntheticShardSource(model, batch_size=args.batch_size,
                                  batches_per_shard=args.batches_per_shard)
    try:
        mesh = build_mesh(MeshSpec(dict(axes)))
        trainer = Trainer(model, mesh, TrainerConfig(
            optimizer="adam", learning_rate=args.learning_rate,
            shard_opt_state=args.zero1, batch_axis=model.config.batch_axis),
            device=device)
        state = trainer.init_state()
        specs = model.batch_spec(mesh)
        shards = data_shards or shard_names("lm", args.shards)
        losses, samples, t0 = [], 0, time.perf_counter()
        for task in pass_tasks(shards, int(args.num_passes)):
            for batch in source.read(task):
                local = shard_batch(batch, mesh, trainer.config.batch_axis, specs=specs)
                state, loss = trainer.train_step(state, trainer.place_batch(local))
                losses.append(float(loss))
                samples += len(batch["tokens"])
        seconds = time.perf_counter() - t0
        if rank == 0:
            torch.save({"steps": float(len(losses)), "final_loss": losses[-1],
                        "mean_loss": sum(losses) / len(losses),
                        "samples_per_sec": samples / seconds, "seconds": seconds,
                        "world": float(world)}, os.path.join(root, "metrics.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
