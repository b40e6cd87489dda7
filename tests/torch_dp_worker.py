"""One rank of the port's multi-rank tests: ``python torch_dp_worker.py JOB RANK``.

Spawned by `spawn_ranks` (which the tests import), one process a rank: it
imports torch and ``edl_tpu_torch`` only, never JAX, forms a gloo process
group through a ``file://`` rendezvous in the test's own directory (so
concurrent test workers never share a port), runs the job's tasks in order
and saves each task's result to ``JOB.rank<R>.pt``. The tests compare the
results against the JAX package, which they run themselves.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


# -- the parent's side ---------------------------------------------------------


def spawn_ranks(tmp_path, world: int, tasks: list, timeout: float = 240.0,
                overlap=None, script=None) -> list:
    """Run ``tasks`` (a list of (task name, kwargs)) on ``world`` ranks;
    returns each rank's list of task results. ``overlap()`` (the JAX
    reference, say) runs in this process while the ranks work. Any rank
    failing fails the call with its output. ``script``: the worker file
    whose ``task_<name>`` functions run (default: this one)."""
    import torch

    job = Path(tmp_path) / "job.pt"
    torch.save({"world": world, "init": f"file://{tmp_path}/rendezvous",
                "tasks": tasks}, job)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(script or __file__), str(job), str(r)],
                              cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    extra = overlap() if overlap is not None else None
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-6000:]}"
    results = [torch.load(f"{job}.rank{r}.pt", weights_only=False) for r in range(world)]
    return results if overlap is None else (results, extra)


# -- the rank's side -----------------------------------------------------------


class StoreKV:
    """The coordinator client's KV surface over the process group's store,
    for the codec channel across processes."""

    def __init__(self, store):
        self.store = store

    def kv_put(self, key, value):
        self.store.set(key, value)

    def kv_get(self, key):
        return self.store.get(key).decode() if self.store.check([key]) else None

    def heartbeat(self):
        return {}


def _mesh(axes):
    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec(dict(axes)))


def _model(kind, kwargs):
    from edl_tpu_torch.models import ctr, transformer

    if kind == "ctr":
        return ctr.make_model(**kwargs)
    return transformer.make_model(transformer.TransformerConfig(**kwargs))


def _trainer(case, **extra):
    from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig

    mesh = _mesh(case["axes"])
    trainer = Trainer(_model(case["model"], case["model_kwargs"]), mesh=mesh,
                      config=TrainerConfig(**case["config"]), device="cpu", **extra)
    state = trainer.init_state()
    full = trainer.full_state(state)
    full["module"] = case["params"]
    return trainer, trainer.load_full_state(state, full)


def _local(trainer, batch):
    from edl_tpu_torch.parallel.sharding import shard_batch

    return trainer.place_batch(shard_batch(batch, trainer.mesh,
                                           trainer.config.batch_axis))


def _moments(trainer, state):
    """{param name: {moment name: this rank's tensor}}."""
    layout = trainer.layout_for(state.params)
    opt = state.opt_state
    return {leaf.name: {k: v.clone() for k, v in opt.state[leaf.opt_param].items()
                        if k != "step"}
            for leaf in layout.leaves}


def task_train(case):
    """Train from the case's params over its global batches; returns the
    losses, the whole params (gathered) and this rank's moments."""
    trainer, state = _trainer(case)
    losses = []
    for batch in case["batches"]:
        state, loss = trainer.train_step(state, _local(trainer, batch))
        losses.append(float(loss))
    full = trainer.full_state(state)
    return {"losses": losses, "params": full["module"],
            "moments": _moments(trainer, state),
            "zero": {leaf.name: None if leaf.zero is None else leaf.zero.dim
                     for leaf in trainer.layout_for(state.params).leaves},
            "data_plane": trainer.data_plane(state)}


def task_lookup(case):
    """One lookup of this rank's ids in its table rows, and the backward of
    this rank's cotangent: (output, table gradient)."""
    import torch

    from edl_tpu_torch.models.convert import shard_state_dict
    from edl_tpu_torch.parallel.embedding import ShardedEmbedding
    from edl_tpu_torch.parallel.sharding import shard_batch

    mesh = _mesh(case["axes"])
    emb = ShardedEmbedding(case["vocab"], case["table"].shape[1], case["shard_axis"],
                           case["batch_axis"])
    table = shard_state_dict({"t": case["table"]}, {"t": case["shard_axis"]}, mesh)["t"]
    table.requires_grad_(True)
    local = shard_batch({"ids": case["ids"], "ct": case["cotangent"]}, mesh,
                        case["batch_axis"])
    out = emb.apply(table, torch.as_tensor(local["ids"]), mesh=mesh)
    out.backward(torch.as_tensor(local["ct"]))
    return {"out": out.detach(), "grad": table.grad}


def task_export(case):
    """The case's params at world N exported once by `save_inference_model`
    and twice by a `PeriodicExporter` (every rank calls; rank 0 writes)."""
    from edl_tpu_torch.runtime.export import PeriodicExporter, save_inference_model

    trainer, state = _trainer(case)
    save_inference_model(case["dir"], "ctr", state, config=case["model_kwargs"],
                         step=1, mesh=trainer.mesh)
    periodic = PeriodicExporter(case["periodic_dir"], "ctr", interval=2,
                                config=case["model_kwargs"], versioned=True,
                                mesh=trainer.mesh)
    for step in (1, 2, 3, 4):
        periodic(step, state)
    periodic.close()
    return {"exports": periodic.exports}


def task_checkpoint(case):
    """Train, save at world N, train on; a fresh Trainer restores the save
    and trains the same batches. Returns both runs' losses and states."""
    import torch.distributed as dist

    from edl_tpu_torch.runtime.checkpoint import Checkpointer

    batches = case["batches"]
    k = case["save_after"]
    trainer, state = _trainer(case)
    ck = Checkpointer(case["dir"], trainer=trainer)
    for batch in batches[:k]:
        state, _ = trainer.train_step(state, _local(trainer, batch))
    saved = {"module": {n: t.clone() for n, t in state.params.state_dict().items()},
             "moments": _moments(trainer, state)}
    ck.save(k, state)
    ck.wait()
    dist.barrier()
    run = []
    for batch in batches[k:]:
        state, loss = trainer.train_step(state, _local(trainer, batch))
        run.append(float(loss))
    fresh, fstate = _trainer(case)
    fstate = Checkpointer(case["dir"], trainer=fresh).restore(fstate)
    restored = {"module": {n: t.clone() for n, t in fstate.params.state_dict().items()},
                "moments": _moments(fresh, fstate), "step": fstate.step}
    resumed = []
    for batch in batches[k:]:
        fstate, loss = fresh.train_step(fstate, _local(fresh, batch))
        resumed.append(float(loss))
    return {"saved": saved, "restored": restored, "run": run, "resumed": resumed,
            "run_params": state.params.state_dict(),
            "resumed_params": fstate.params.state_dict()}


def task_wire(case):
    """Codec agreement through a `KVCodecChannel` over the group's store:
    each rank's codec spec and losses; then rank 1 alone overflows the u8
    label and must raise the floor and ask for the restart."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    from edl_tpu_torch.runtime.wire import KVCodecChannel, WireRestartRequired

    kv = StoreKV(distributed_c10d._get_default_store())
    trainer, state = _trainer(case, codec_channel=KVCodecChannel(kv, epoch=0))
    losses = []
    for batch in case["batches"]:
        state, loss = trainer.train_step(state, _local(trainer, batch))
        losses.append(float(loss))
    spec = trainer._codec.to_spec()
    bad = dict(case["batches"][0])
    if dist.get_rank() == 1:
        bad["label"] = np.full_like(bad["label"], 300)
    restart = None
    try:
        trainer.place_batch(bad)
    except WireRestartRequired as e:
        restart = e.key
    dist.barrier()
    again = KVCodecChannel(kv, epoch=1)
    return {"spec": spec, "losses": losses, "restart": restart, "floor": again.floor()}


def main(job_path: str, rank: int, tasks=None) -> None:
    """One rank: the job's tasks from ``tasks`` ({name: function}; default:
    this file's ``task_<name>`` functions)."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    dist.init_process_group("gloo", init_method=job["init"], world_size=job["world"],
                            rank=rank)
    tasks = tasks or {k[5:]: f for k, f in globals().items() if k.startswith("task_")}
    try:
        results = [tasks[name](kwargs) for name, kwargs in job["tasks"]]
        torch.save(results, f"{job_path}.rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
