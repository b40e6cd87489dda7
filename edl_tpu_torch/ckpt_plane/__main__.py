"""Checkpoint-plane smoke: replicate, kill, peer-restore, match the twin.

``python -m edl_tpu_torch.ckpt_plane [--device cpu]``, the port of
``python -m edl_tpu.ckpt_plane``, drives the full fallback ladder and
proves the plane is *invisible to the optimizer trajectory*:

1. TWIN — train ``TOTAL_STEPS`` straight through; record the final loss.
2. PEER — train half, replicate every owner's ZeRO slice to the plane and
   write the durable blob, then throw the live state away (the "killed
   worker"), peer-restore from coordinator memory, and finish on the
   identical batch stream. Byte-exact shards mean the final loss must
   EQUAL the twin's, and zero blob reads happen.
3. GROUP DEATH — drop every owner's shard (a whole replica group dying),
   watch ``restore`` demote to None, fall back to the blob store, finish,
   and match the twin again.

It runs on the card unless ``--device cpu`` is given. The JAX smoke trains
on a 4-device data mesh of one process; here the one process trains on its
one device (a world-1 local mesh with ZeRO-1 on), and the plane stores
``WORLD`` owners all the same, as the `ElasticWorker` does. The same
device and batches make "matches" exact float equality, not a tolerance —
any divergence is a serialization bug, not noise.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np

from edl_tpu_torch.ckpt_plane import CkptPlane, state_template
from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator
from edl_tpu_torch.models import fit_a_line
from edl_tpu_torch.parallel.mesh import local_mesh
from edl_tpu_torch.runtime.checkpoint import Checkpointer
from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig

TOTAL_STEPS = 6
KILL_AFTER = 3
WORLD = 2  # plane owners per covered checkpoint


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="checkpoint-plane smoke")
    p.add_argument("--device", default=None,
                   help="device to train on (default: the card; 'cpu' asks for "
                        "the CPU)")
    args = p.parse_args(argv)
    model = fit_a_line.MODEL
    tcfg = TrainerConfig(optimizer="adam", shard_opt_state=True)
    trainer = Trainer(model, local_mesh(), tcfg, device=args.device)

    # One batch stream, fixed up front, replayed by every run: the twin and
    # both recovery runs must see byte-identical data or "loss matches" is
    # meaningless.
    rng = np.random.default_rng(7)
    batches = [model.synthetic_batch(rng, 16) for _ in range(TOTAL_STEPS)]

    def run_steps(state, lo, hi):
        loss = None
        for i in range(lo, hi):
            state, loss = trainer.train_step(state, trainer.place_batch(batches[i]))
        return state, float(loss)

    # 1) twin: straight through
    _, twin_loss = run_steps(trainer.init_state(), 0, TOTAL_STEPS)

    coord = InProcessCoordinator()
    client = coord.client("smoke")
    client.register()
    plane = CkptPlane(client, replicas=1)
    plane.on_epoch(1, world=WORLD, rank=0)
    ckpt_dir = tempfile.mkdtemp(prefix="edl-ckpt-plane-smoke-")
    result = {"device": str(trainer.device), "twin_loss": twin_loss}
    try:
        ckpt = Checkpointer(ckpt_dir, trainer=trainer)

        # 2) train half, cover it (plane + blob), kill, peer-restore, finish
        state, _ = run_steps(trainer.init_state(), 0, KILL_AFTER)
        rep = plane.replicate_all(trainer.full_state(state), KILL_AFTER, world=WORLD)
        assert rep is not None, "replication failed"
        ckpt.save(KILL_AFTER, state)
        ckpt.wait()
        del state  # the killed worker's memory is gone

        fresh = trainer.init_state()
        got = plane.restore(state_template(trainer, fresh), trainer=trainer,
                            state=fresh, min_step=ckpt.latest_step())
        assert got is not None, "peer restore should have succeeded"
        restored, info = got
        assert info["world_at_save"] == WORLD
        _, peer_loss = run_steps(restored, KILL_AFTER, TOTAL_STEPS)
        result["peer"] = {"loss": peer_loss, "bytes": info["bytes"],
                          "source": info["source"]}

        # 3) whole replica group dies: plane demotes, blob finishes the job
        for r in range(WORLD):
            plane.drop_owner(r)
        fresh = trainer.init_state()
        assert plane.restore(state_template(trainer, fresh)) is None, \
            "group death must demote the plane to None"
        blob_state = ckpt.restore(fresh)
        _, blob_loss = run_steps(blob_state, KILL_AFTER, TOTAL_STEPS)
        result["blob_fallback"] = {"loss": blob_loss}
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    ok = (peer_loss == twin_loss) and (blob_loss == twin_loss)
    result["pass"] = ok
    print(json.dumps(result, indent=2))
    if not ok:
        print("ckpt-plane smoke FAILED: recovery diverged from the twin",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
