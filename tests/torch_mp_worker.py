"""One rank of the port's model-parallel tests: ``python torch_mp_worker.py JOB RANK``.

Spawned by ``torch_dp_worker.spawn_ranks(..., script=this file)``, one
process a rank, gloo over a ``file://`` rendezvous; it imports torch and
``edl_tpu_torch`` only, never JAX. Each task's result is saved for the test
to compare against the JAX package.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_dp_worker  # noqa: E402


def _mesh(axes):
    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    return build_mesh(MeshSpec(dict(axes)))


def task_ring(case):
    """The public ring over the case's mesh on the global q/k/v: this rank's
    output block, and the gradients of the global q/k/v for this rank's
    block of the cotangent (every rank's summed is the whole gradient)."""
    import torch

    from edl_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _mesh(case["axes"])
    dtype = getattr(torch, case["dtype"])
    q, k, v = (torch.tensor(case[n], dtype=dtype, requires_grad=True) for n in "qkv")
    out = ring_attention(q, k, v, mesh, causal=case["causal"], flash=case["flash"])
    ct = torch.tensor(case["ct"])
    B, S = ct.shape[:2]
    nb, ns = mesh.shape.get("data", 1), mesh.shape.get("seq", 1)
    b, s = B // nb, S // ns
    i, j = mesh.coords().get("data", 0), mesh.coords().get("seq", 0)
    block = ct[i * b:(i + 1) * b, j * s:(j + 1) * s]
    (out.float() * block).sum().backward()
    return {"out": out.detach().float(), "grads": [t.grad.float() for t in (q, k, v)],
            "block": (i, j)}


def task_train(case):
    """Train from the case's params over its global batches (each rank its
    rows and sequence chunk, `shard_batch` with the model's batch_spec);
    returns the losses, the whole params and optimizer state, the
    first step's reduced gradients gathered whole (Adam's first moment
    after one step is ``(1 - beta1) * g``; numbered as the one-device
    optimizer's params), the 1F1B stash high-water mark, ``data_plane()``,
    each leaf's ZeRO-1 dim and the largest difference of a shard-and-gather
    round trip of the case's params."""
    from edl_tpu_torch.parallel.sharding import shard_batch

    trainer, state = torch_dp_worker._trainer(case)
    mesh = trainer.mesh
    back = trainer.full_state(state)["module"]  # cut to the shards and gathered
    roundtrip = max((back[n] - t).abs().max().item() for n, t in case["params"].items())
    specs = trainer.model.batch_spec(mesh)
    losses, grads = [], None
    for batch in case["batches"]:
        local = shard_batch(batch, mesh, trainer.config.batch_axis, specs=specs)
        state, loss = trainer.train_step(state, trainer.place_batch(local))
        losses.append(float(loss))
        if grads is None:
            opt = trainer.full_state(state)["optimizer"]
            beta1 = opt["param_groups"][0]["betas"][0]
            grads = {i: per["exp_avg"] / (1 - beta1) for i, per in opt["state"].items()}
    full = trainer.full_state(state)
    layout = trainer.layout_for(state.params)
    return {"losses": losses, "params": full["module"], "optimizer": full["optimizer"],
            "roundtrip": roundtrip,
            "zero": {leaf.name: None if leaf.zero is None else leaf.zero.dim
                     for leaf in layout.leaves},
            "grads": grads, "names": [n for n, _ in state.params.named_parameters()],
            "stash": dict(state.params.pipeline_stats),
            "data_plane": trainer.data_plane(state)}


def task_export_checkpoint(case):
    """Train two steps, export the LM (every rank calls; rank 0 writes) and
    save a checkpoint; a fresh Trainer restores it: its whole state must be
    the saved one."""
    import torch.distributed as dist

    from edl_tpu_torch.runtime.checkpoint import Checkpointer
    from edl_tpu_torch.runtime.export import save_inference_model

    trainer, state = torch_dp_worker._trainer(case)
    for batch in case["batches"]:
        state, _ = trainer.train_step(state, torch_dp_worker._local(trainer, batch))
    save_inference_model(case["export_dir"], "transformer", state,
                         config=case["model_kwargs"], step=int(state.step),
                         mesh=trainer.mesh)
    ck = Checkpointer(case["ckpt_dir"], trainer=trainer)
    ck.save(int(state.step), state)
    ck.wait()
    dist.barrier()
    saved = trainer.full_state(state)
    fresh, fstate = torch_dp_worker._trainer(case)
    fstate = Checkpointer(case["ckpt_dir"], trainer=fresh).restore(fstate)
    return {"saved": saved, "restored": fresh.full_state(fstate)}


if __name__ == "__main__":
    torch_dp_worker.main(sys.argv[1], int(sys.argv[2]),
                         {k[5:]: f for k, f in globals().items() if k.startswith("task_")})
