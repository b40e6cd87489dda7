"""word2vec, an N-gram neural LM: the port of `edl_tpu.models.word2vec`.

A 5-gram model: embed 4 context words through a `parallel.ShardedEmbedding`
(vocab 2074 padded to 2304), concatenate, a bf16 hidden layer with ReLU,
and a bf16 projection onto the vocabulary whose logits are cast to f32
before the f32 bias; cross-entropy in f32. Built on a
`parallel.mesh.Mesh`, the table is row-sharded over ``data`` (the JAX
package's ``param_spec``) and the lookup runs across the ranks, as CTR's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model, Params, normal
from edl_tpu_torch.parallel.embedding import ShardedEmbedding

#: imikolov-style dict size
VOCAB = 2074
CONTEXT = 4  # 5-gram: 4 context words -> next word
EMBED_DIM = 32
HIDDEN = 256

_table = ShardedEmbedding(VOCAB, EMBED_DIM, "data", "data")


class Word2Vec(nn.Module):
    """Params ``table`` (2304, 32), ``hidden.w`` (128, 256) / ``.b``,
    ``out.w`` (256, 2074) / ``.b``; on a ``mesh`` the table holds this
    rank's 2304/n rows. Calling it on ``{"context", "target"}`` returns the
    mean next-word cross-entropy."""

    def __init__(self, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        fan_in = CONTEXT * EMBED_DIM
        self.mesh = mesh
        self.table = nn.Parameter(_table.init(g, device, scale=1.0 / math.sqrt(EMBED_DIM),
                                              mesh=mesh))
        self.hidden = Params(w=normal(g, (fan_in, HIDDEN), math.sqrt(2.0 / fan_in), device),
                             b=torch.zeros(HIDDEN, device=device))
        self.out = Params(w=normal(g, (HIDDEN, VOCAB), 0.01, device),
                          b=torch.zeros(VOCAB, device=device))

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Context ids (B, 4) -> next-word logits (B, VOCAB), f32."""
        bf16 = torch.bfloat16
        ctx = _table.apply(self.table, batch["context"], mesh=self.mesh)  # (B, 4, D)
        h = ctx.reshape(ctx.shape[0], -1).to(bf16)
        h = torch.relu(h @ self.hidden.w.to(bf16) + self.hidden.b.to(bf16))
        return (h @ self.out.w.to(bf16)).float() + self.out.b

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return F.cross_entropy(self.predict(batch), batch["target"].long())


def synthetic_batch(rng: np.random.Generator, batch_size: int) -> dict:
    context = (rng.zipf(1.2, size=(batch_size, CONTEXT)) % VOCAB).astype(np.int32)
    target = (rng.zipf(1.2, size=(batch_size,)) % VOCAB).astype(np.int32)
    return {"context": context, "target": target}


MODEL = Model(
    name="word2vec",
    build=lambda device=None, generator=None, mesh=None: Word2Vec(
        device=device, generator=generator, mesh=mesh),
    param_spec=lambda mesh: {"table": _table.shard_axis},
    synthetic_batch=synthetic_batch,
    label_keys=("target",),
    predict=lambda module, batch: module.predict(batch),
    # MFU numerator: hidden (128 -> 256) + softmax projection (256 -> vocab);
    # the table lookup is a gather, not matmul FLOPs
    flops_per_step=lambda bs: 3.0 * bs * (
        2 * CONTEXT * EMBED_DIM * HIDDEN + 2 * HIDDEN * VOCAB
    ),
)
