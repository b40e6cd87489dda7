"""The port's embedding table against the JAX package's, on the CPU.

Padded vocab sizes are exact integers and must be equal. The one-shard
lookup and `dedup_gather`'s forward are gathers of the same f32 rows, so
they are equal exactly. `dedup_gather`'s backward sums the same f32
gradients of duplicate ids in the same sorted order on both sides: held to
rtol 1e-6 (measured: equal).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.parallel.embedding import ShardedEmbedding as JaxEmbedding
from edl_tpu.parallel.embedding import dedup_gather as jax_dedup_gather
from edl_tpu_torch.parallel.embedding import ShardedEmbedding, _round_up, dedup_gather

VOCAB, FEATURES = 1000, 4


def _fake_mesh(n_shards: int):
    """What `padded_vocab` reads of a mesh, for shard counts no CPU mesh has."""
    return types.SimpleNamespace(shape={"data": n_shards}, axis_names=("data",))


@pytest.mark.parametrize("vocab", [1000, 1000001, 2074, 256])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 12])
def test_padded_vocab_matches_jax(vocab, n_shards):
    got = ShardedEmbedding(vocab, FEATURES).padded_vocab(n_shards)
    assert got == JaxEmbedding(vocab, FEATURES).padded_vocab(_fake_mesh(n_shards))
    assert got % n_shards == 0 and got >= vocab
    assert _round_up(vocab, 256) == ShardedEmbedding(vocab, FEATURES).padded_vocab()


def test_init_is_padded_normal_times_scale():
    table = ShardedEmbedding(VOCAB, FEATURES).init(torch.Generator().manual_seed(0),
                                                   "cpu", scale=0.5)
    assert table.shape == (1024, FEATURES) and table.dtype == torch.float32
    assert 0.45 < table.std().item() < 0.55


def test_one_shard_apply_matches_jax_gather():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((1024, FEATURES)).astype(np.float32)
    ids = rng.integers(0, VOCAB, (8, 26)).astype(np.int32)
    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    want = JaxEmbedding(VOCAB, FEATURES).apply(mesh, jnp.asarray(table), jnp.asarray(ids))
    got = ShardedEmbedding(VOCAB, FEATURES).apply(torch.from_numpy(table),
                                                  torch.from_numpy(ids))
    assert got.shape == (8, 26, FEATURES)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["duplicates", "last_real_row", "empty"])
def test_dedup_gather_matches_the_jax_custom_vjp(case):
    rng = np.random.default_rng(1)
    table = rng.standard_normal((1024, FEATURES)).astype(np.float32)
    ids = {"duplicates": np.array([5, 1, 5, 5, 0, 1, 7], np.int32),
           "last_real_row": np.array([VOCAB - 1, 3, VOCAB - 1, 0], np.int32),
           "empty": np.zeros((0,), np.int32)}[case]
    cot = rng.standard_normal((len(ids), FEATURES)).astype(np.float32)

    out, vjp = jax.vjp(lambda t: jax_dedup_gather(t, jnp.asarray(ids)), jnp.asarray(table))
    (want_grad,) = vjp(jnp.asarray(cot))

    t = torch.tensor(table, requires_grad=True)
    got = dedup_gather(t, torch.from_numpy(ids))
    got.backward(torch.from_numpy(cot))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    # each id's row holds the sum of its cotangents; untouched rows stay 0
    if case != "empty":
        np.testing.assert_allclose(t.grad[ids[0]].numpy(), cot[ids == ids[0]].sum(0),
                                   rtol=1e-6)
    untouched = np.setdiff1d(np.arange(1024), ids)
    assert not t.grad[untouched].any()


@pytest.mark.parametrize("batch_axis", ["data", "expert"])
def test_lookups_across_shards_raise(batch_axis):
    """A lookup across shards runs its collectives over a mesh's process
    groups (held against the JAX lookups in `tests/test_torch_dp.py`); on
    a mesh without them it raises rather than look up one shard alone."""
    from edl_tpu_torch.parallel.mesh import Mesh

    emb = ShardedEmbedding(VOCAB, FEATURES, shard_axis="data", batch_axis=batch_axis)
    table = torch.zeros((emb.padded_vocab(2) // 2, FEATURES))
    mesh = Mesh(["data", "expert"], [2, 2], 0, 4)  # its shape only: no process group
    with pytest.raises(ValueError, match="needs the Mesh"):
        emb.apply(table, torch.zeros((2, 3), dtype=torch.int32), mesh=mesh)
