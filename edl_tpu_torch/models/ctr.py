"""CTR deep-wide DNN, the flagship: the port of `edl_tpu.models.ctr`.

Criteo-style click-through prediction: 13 dense and 26 hashed categorical
features into a sparse space of 1e6+1 ids, a deep 400-400-400 MLP over the
dense features and 26 embeddings of 10, a wide linear path over the same ids
and the dense features, and the sigmoid logloss. The two tables (deep
embeddings and wide linear weights) are `parallel.ShardedEmbedding`s,
padded to 1000192 rows: one ``table[ids]`` each on one rank, and on a
`parallel.mesh.Mesh` row-sharded over ``shard_axis`` (``"data"`` by
default, so a data-parallel mesh splits them as the JAX package's
``SHARD_AXIS`` does) and looked up through the axis's collectives. The
module returns its rank's mean loss; the Trainer averages over the batch
axes, as the JAX package's global-batch mean does.

Dtypes follow the JAX package: f32 params and tables; the MLP in bf16
(dense features and embeddings concatenated in f32, then cast; each layer a
bf16 matmul plus the bias cast to bf16, then ReLU); the deep logit cast to
f32 before its f32 bias; the wide path and the loss in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model, Params, normal
from edl_tpu_torch.parallel.embedding import ShardedEmbedding

NUM_DENSE = 13
NUM_SPARSE = 26
#: the reference's --sparse_feature_dim 1000001
SPARSE_DIM = 1000001
EMBED_DIM = 10
HIDDEN = (400, 400, 400)
#: the mesh axis the tables are row-sharded over
SHARD_AXIS = "data"


class CTRModel(nn.Module):
    """Params as in the JAX package: ``deep_table`` (V, 10), ``wide_table``
    (V, 1), ``wide_dense`` (13, 1), ``mlp.{i}.w`` (in, out) / ``.b``,
    ``out.w`` (400, 1) / ``.b``; on a ``mesh`` the tables hold this rank's
    V/n rows. Calling it on ``{"dense", "sparse", "label"}`` returns the
    mean logloss of the batch it is given."""

    def __init__(self, deep: ShardedEmbedding, wide: ShardedEmbedding, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.deep, self.wide, self.mesh = deep, wide, mesh
        self.deep_table = nn.Parameter(
            deep.init(g, device, scale=1.0 / math.sqrt(EMBED_DIM), mesh=mesh))
        self.wide_table = nn.Parameter(wide.init(g, device, scale=0.01, mesh=mesh))
        self.wide_dense = nn.Parameter(torch.zeros((NUM_DENSE, 1), device=device))
        fan_in = NUM_DENSE + NUM_SPARSE * EMBED_DIM
        mlp = []
        for width in HIDDEN:
            mlp.append(Params(w=normal(g, (fan_in, width), math.sqrt(2.0 / fan_in), device),
                              b=torch.zeros(width, device=device)))
            fan_in = width
        self.mlp = nn.ModuleList(mlp)
        self.out = Params(w=normal(g, (fan_in, 1), 0.01, device),
                          b=torch.zeros(1, device=device))

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Click logits (B,), pre-sigmoid: the serving entrypoint."""
        return _forward_impl(self, batch["dense"], batch["sparse"])

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = self.predict(batch)
        labels = batch["label"].float()
        # sigmoid binary cross-entropy in f32, the stable form
        return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                          + torch.log1p(torch.exp(-logits.abs())))


def _forward_impl(m: CTRModel, dense: torch.Tensor, sparse_ids: torch.Tensor
                  ) -> torch.Tensor:
    """Logits for a batch. dense: (B, 13) f32; sparse_ids: (B, 26) integer."""
    bf16 = torch.bfloat16
    emb = m.deep.apply(m.deep_table, sparse_ids, mesh=m.mesh)  # (B, 26, D)
    h = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=-1).to(bf16)
    for layer in m.mlp:
        h = torch.relu(h @ layer.w.to(bf16) + layer.b.to(bf16))
    deep_logit = (h @ m.out.w.to(bf16)).float() + m.out.b
    wide_sparse = m.wide.apply(m.wide_table, sparse_ids, mesh=m.mesh)  # (B, 26, 1)
    wide_logit = wide_sparse.sum(dim=(1, 2))[:, None] + dense @ m.wide_dense
    return (deep_logit + wide_logit).squeeze(-1)


def synthetic_batch(rng: np.random.Generator, batch_size: int,
                    sparse_dim: int = SPARSE_DIM) -> dict:
    """Criteo-shaped synthetic batch: gaussian dense, zipf-ish sparse ids
    (hashed feature distributions are heavy-tailed), bernoulli labels."""
    dense = rng.standard_normal((batch_size, NUM_DENSE)).astype(np.float32)
    sparse = (
        rng.zipf(1.3, size=(batch_size, NUM_SPARSE)).astype(np.int64) % sparse_dim
    ).astype(np.int32)
    label = (rng.random(batch_size) < 0.25).astype(np.int32)
    return {"dense": dense, "sparse": sparse, "label": label}


def _flops_per_step(batch_size: int) -> float:
    """Train-step model FLOPs (MFU numerator, models.base convention). The
    deep MLP dominates; table gathers and the wide path are lookups and
    tiny reductions, not matmul FLOPs."""
    dims = [NUM_DENSE + NUM_SPARSE * EMBED_DIM, *HIDDEN, 1]
    fwd = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    fwd += 2 * NUM_DENSE  # wide dense linear
    return 3.0 * fwd * batch_size


def make_model(shard_axis: str = SHARD_AXIS, batch_axis="data",
               sparse_dim: int = SPARSE_DIM) -> Model:
    """CTR with its tables' axes named and its sparse dim: e.g. a dedicated
    ``expert`` axis for the tables (the cross-axis lookup) or a smaller
    vocab for tests."""
    deep = ShardedEmbedding(sparse_dim, EMBED_DIM, shard_axis, batch_axis)
    wide = ShardedEmbedding(sparse_dim, 1, shard_axis, batch_axis)
    return Model(
        name="ctr",
        build=lambda device=None, generator=None, mesh=None: CTRModel(
            deep, wide, device=device, generator=generator, mesh=mesh),
        param_spec=lambda mesh: {"deep_table": shard_axis, "wide_table": shard_axis},
        synthetic_batch=lambda rng, bs: synthetic_batch(rng, bs, sparse_dim),
        label_keys=("label",),
        predict=lambda module, batch: module.predict(batch),
        flops_per_step=_flops_per_step,
    )


MODEL = make_model()


def forward(module: CTRModel, dense: torch.Tensor, sparse_ids: torch.Tensor
            ) -> torch.Tensor:
    """Forward pass (inference entrypoint): click logits (B,)."""
    return _forward_impl(module, dense, sparse_ids)
