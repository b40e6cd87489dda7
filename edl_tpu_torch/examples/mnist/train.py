"""MNIST digit recognition: train / infer modes, the port of
`examples/mnist/train.py`.

Run as ``python -m edl_tpu_torch.examples.mnist.train [train|infer]``.
``train`` runs the `Trainer` with Adam and a `StepProfiler` and saves a
checkpoint; ``infer`` restores it and reports the accuracy on a held-out
batch (seed 99). The argparse surface is the JAX entry's plus ``--device``
(default: the card; ``cpu`` asks for the CPU). The checkpoint is the
port's format (`runtime.checkpoint`), so the default ``--model-dir`` is
not the JAX entry's.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from typing import List, Optional

import numpy as np
import torch

from edl_tpu_torch.models import mnist
from edl_tpu_torch.runtime import Checkpointer, Trainer, TrainerConfig
from edl_tpu_torch.tools import StepProfiler


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="MNIST conv training")
    p.add_argument("mode", nargs="?", default="train", choices=["train", "infer"])
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--model-dir", default=None,
                   help="checkpoint dir (ref: save_dirname, recognize_digits.py:119)")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the card; 'cpu' asks for the CPU)")
    return p.parse_args(argv)


def batches(model, rng, batch_size, n):
    for _ in range(n):
        yield model.synthetic_batch(rng, batch_size)


def train(args, model_dir: str) -> None:
    trainer = Trainer(
        mnist.MODEL, device=args.device,
        config=TrainerConfig(optimizer="adam", learning_rate=args.learning_rate),
    )
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    prof = StepProfiler(warmup=1)
    state, metrics = trainer.run(
        state, batches(mnist.MODEL, rng, args.batch_size, args.steps), profiler=prof
    )
    ckpt = Checkpointer(model_dir)
    ckpt.save(int(state.step), state)
    ckpt.wait()
    out = {**{k: round(v, 4) for k, v in metrics.items()},
           "step_time_p50_s": round(prof.summary().get("step_time_p50_s", 0.0), 6),
           "model_dir": model_dir}
    print(json.dumps(out))


def infer(args, model_dir: str) -> None:
    trainer = Trainer(mnist.MODEL, device=args.device, config=TrainerConfig())
    fresh = trainer.init_state()
    ckpt = Checkpointer(model_dir)
    if ckpt.latest_step() is None:
        raise SystemExit(f"no checkpoint under {model_dir}; run train first")
    state = ckpt.restore(fresh)
    batch = mnist.MODEL.synthetic_batch(np.random.default_rng(99), 512)
    placed = trainer.place_batch(batch)
    with torch.no_grad():
        acc = float(mnist.accuracy(state.params, placed))
    print(json.dumps({"step": int(state.step), "accuracy": round(acc, 4)}))


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    model_dir = args.model_dir or tempfile.gettempdir() + "/edl-torch-mnist-ckpt"
    if args.mode == "train":
        train(args, model_dir)
    else:
        infer(args, model_dir)


if __name__ == "__main__":
    main()
