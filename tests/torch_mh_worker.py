"""One rank of the port's multi-process elastic tests: ``python
torch_mh_worker.py``, configured by the environment.

It imports torch and ``edl_tpu_torch`` only, never JAX: it reaches the
coordinator named by ``EDL_COORDINATOR_ENDPOINT``, forms a gloo process
group through `distributed_init` (the rendezvous port is the coordinator's
``EDL_PORT`` plus one) and runs a `MultiHostWorker` on the CPU. A
launcher can exec it as its ``EDL_ENTRY``: on a rescale it exits 75 and is
relaunched. Knobs:

- ``WORKER_NAME``: the member name (stable across relaunches, so a new
  incarnation takes over its predecessor's membership and leases); without
  it the pod's ``EDL_POD_NAME``, as a `ProcessCluster` pod sets it;
- ``MODEL``: ``fit_a_line`` (default), ``ctr_small`` (sparse dim 503) or
  ``lm`` (the transformer LM of the ``LM`` JSON's config, Adam with the
  ``TRAINER`` JSON's options);
- ``AXES``: the worker's ``mesh_axes`` (JSON); ``PLANNER=stub``: a
  ``layout_planner`` giving ``{"pipe": 2}`` at world 2 and ``{"data": 1}``
  at world 1;
- ``RESTORES``: where rank 0 appends, at each incarnation's restore, the
  step restored, the whole state it restored into and the checkpoint it read
  (one ``torch.save`` file an incarnation);
- ``BATCHES_PER_SHARD`` (default 3), ``BATCH_SIZE`` (16), ``BATCH_SLEEP``
  (seconds a batch, default 0);
- ``HOLD_AFTER``: after that many batches this incarnation reads no more
  while the coordinator KV key ``test/hold`` is ``1`` (a test holds a
  phase open until a peer has joined);
- ``CKPT_DIR``, ``CKPT_INTERVAL`` (default 1000 steps);
- ``EXPORT_DIR``/``EXPORT_INTERVAL``: a `PeriodicExporter` on every rank;
- ``RESULT``: where each incarnation appends its rank's summary (its
  member name, the shards it read in order, its losses and metrics) as one
  JSON line, and writes its rank to ``RESULT.rank`` once the process group
  is up.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


class Throttled:
    """A source whose reads are recorded, each batch optionally delayed,
    and held after ``hold_after`` batches while the KV key ``test/hold``
    reads ``1``."""

    def __init__(self, inner, sleep: float, reads: list, client=None,
                 hold_after: int = -1):
        self.inner, self.sleep, self.reads = inner, sleep, reads
        self.client, self.hold_after, self.batches = client, hold_after, 0

    def read(self, shard):
        self.reads.append(shard)
        for batch in self.inner.read(shard):
            if self.sleep:
                time.sleep(self.sleep)
            self.batches += 1
            while 0 <= self.hold_after <= self.batches and \
                    self.client.kv_get("test/hold") == "1":
                time.sleep(0.05)
            yield batch

    def batch_count(self, shard):
        return self.inner.batch_count(shard)


def stub_planner(n, ranks):
    """``{"pipe": 2}`` at two ranks, ``{"data": 1}`` at one."""
    from edl_tpu_torch.parallel.planner import Plan

    axes = (("pipe", 2),) if n == 2 else (("data", 1),)
    return Plan(chips=n, mesh_axes=axes, schedule=None, virtual_stages=1, microbatches=1,
                step_seconds=1.0, batch_axis="data", baseline_step_seconds=1.0)


def record_restores(worker, path: str, rank: int) -> None:
    """Wrap the worker's restore: rank 0 saves the step, the restored state
    gathered whole (`Trainer.full_state`, collective) and the checkpoint
    file of that step as it was read."""
    import torch

    restore = worker._restore_or_init

    def held(trainer):
        state = restore(trainer)
        full = trainer.full_state(state)
        if rank == 0 and int(state.step) > 0:
            step = int(state.step)
            saved = torch.load(os.path.join(worker.ckpt.directory, str(step), "state.pt"),
                               weights_only=True)
            torch.save({"step": step, "restored": full, "saved": saved,
                        "mesh": dict(trainer.mesh.shape)},
                       f"{path}.{os.getpid()}.pt")
        return state

    worker._restore_or_init = held


def main() -> None:
    import torch

    torch.set_num_threads(1)
    from edl_tpu_torch.launcher.discovery import wait_coordinator
    from edl_tpu_torch.launcher.launch import LaunchContext
    from edl_tpu_torch.runtime import (ElasticConfig, MultiHostWorker, PeriodicExporter,
                                       SyntheticShardSource)
    from edl_tpu_torch.runtime.distributed import distributed_init
    from edl_tpu_torch.runtime.train_loop import TrainerConfig

    ctx = LaunchContext.from_env()
    client = wait_coordinator(ctx.coordinator_endpoint)
    client.worker = os.environ.get("WORKER_NAME") or os.environ["EDL_POD_NAME"]
    ident = distributed_init(ctx, client, backend="gloo", timeout=60.0)
    Path(os.environ["RESULT"] + ".rank").write_text(str(ident.process_id))
    trainer_kw = {}
    if os.environ.get("MODEL") == "ctr_small":
        from edl_tpu_torch.models import ctr

        model = ctr.make_model(sparse_dim=503)
        ref, config, opt = "ctr", {"sparse_dim": 503}, "adagrad"
    elif os.environ.get("MODEL") == "lm":
        from edl_tpu_torch.models import transformer

        config = json.loads(os.environ["LM"])
        model, ref, opt = transformer.make_model(**config), "transformer", "adam"
        trainer_kw = json.loads(os.environ.get("TRAINER", "{}"))
    else:
        from edl_tpu_torch.models import fit_a_line

        model, ref, config, opt = fit_a_line.MODEL, "fit_a_line", None, "sgd"
    reads: list = []
    source = Throttled(SyntheticShardSource(
        model, batch_size=int(os.environ.get("BATCH_SIZE", "16")),
        batches_per_shard=int(os.environ.get("BATCHES_PER_SHARD", "3"))),
        float(os.environ.get("BATCH_SLEEP", "0")), reads,
        client=wait_coordinator(ctx.coordinator_endpoint),
        hold_after=int(os.environ.get("HOLD_AFTER", "-1")))
    exporter = None
    if os.environ.get("EXPORT_DIR"):
        exporter = PeriodicExporter(os.environ["EXPORT_DIR"], ref,
                                    int(os.environ.get("EXPORT_INTERVAL", "5")),
                                    config=config)
    worker = None

    def on_step(step, state):
        if exporter is not None:
            exporter.mesh = worker.mesh
            exporter(step, state)

    trainer_kw = {"optimizer": opt, "learning_rate": 0.05, **trainer_kw}
    cfg = ElasticConfig(checkpoint_dir=os.environ["CKPT_DIR"],
                        checkpoint_interval=int(os.environ.get("CKPT_INTERVAL", "1000")),
                        rescale_barrier_timeout=30.0, step_callback=on_step,
                        trainer=TrainerConfig(**trainer_kw))
    layout = {}
    if os.environ.get("AXES"):
        layout["mesh_axes"] = json.loads(os.environ["AXES"])
    if os.environ.get("PLANNER") == "stub":
        layout["layout_planner"] = stub_planner
    worker = MultiHostWorker(model, client, source, cfg, device="cpu", **layout)
    if os.environ.get("RESTORES"):
        record_restores(worker, os.environ["RESTORES"], ident.process_id)
    summary = {"worker": client.worker, "rank": ident.process_id,
               "world": ident.num_processes, "reads": reads}
    code = 0
    try:
        metrics = worker.run()
        if exporter is not None:
            exporter.wait()
            metrics["exports"] = float(exporter.exports)
        summary["metrics"] = metrics
    except SystemExit as e:
        code = e.code
    summary.update(exit=code, losses=worker.losses,
                   mesh=dict(worker.mesh.shape) if worker.mesh is not None else None)
    with open(os.environ["RESULT"], "a") as f:
        f.write(json.dumps(summary) + "\n")
    sys.exit(code)


if __name__ == "__main__":
    main()
