"""Local fit_a_line training — the single-process twin: the port of
`examples/fit_a_line/train_local.py`.

Run as ``python -m edl_tpu_torch.examples.fit_a_line.train_local``. The
UCI-housing linear regression trained by the `Trainer` with SGD, one
`Checkpointer` save a pass when ``--checkpoint-dir`` is given, one JSON
line a pass. The argparse surface is the JAX entry's plus ``--device``
(default: the card; ``cpu`` asks for the CPU). The JAX entry trains over
every local device's mesh; the port trains on its one device.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np

from edl_tpu_torch.models import fit_a_line
from edl_tpu_torch.runtime import Checkpointer, Trainer, TrainerConfig


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--passes", type=int, default=10)
    parser.add_argument("--steps-per-pass", type=int, default=50)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--device", default=None,
                        help="device to train on (default: the card; 'cpu' asks "
                             "for the CPU)")
    args = parser.parse_args(argv)

    trainer = Trainer(fit_a_line.MODEL, device=args.device,
                      config=TrainerConfig(optimizer="sgd", learning_rate=args.lr))
    state = trainer.init_state()
    ckpt = Checkpointer(args.checkpoint_dir) if args.checkpoint_dir else None
    rng = np.random.default_rng(0)

    for pass_id in range(args.passes):
        batches = (
            fit_a_line.MODEL.synthetic_batch(rng, args.batch_size)
            for _ in range(args.steps_per_pass)
        )
        state, metrics = trainer.run(state, batches)
        print(json.dumps({"pass": pass_id, **{k: round(v, 4) for k, v in metrics.items()}}))
        if ckpt is not None:  # per-pass save (ref: train_local.py:95-96)
            ckpt.save(int(state.step), state)
    if ckpt is not None:
        ckpt.wait()


if __name__ == "__main__":
    main()
