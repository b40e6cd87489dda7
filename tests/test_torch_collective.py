"""The port's data-plane arithmetic and mesh layout against the JAX package's
`edl_tpu.parallel.collective` and `edl_tpu.parallel.mesh`, on the CPU: ZeRO
shard placement, gradient buckets, the closed-form bytes on the wire, and
where each rank sits on a mesh. All of it is integer or
exact float arithmetic on the same inputs, so every value must be equal
(tolerance 0), except the seconds estimate, whose link rates the port
takes from the H100's data sheets: it is held to its own formula instead.
"""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from edl_tpu.parallel import MeshSpec, build_hierarchical_mesh, build_mesh
from edl_tpu.parallel import collective as jc
from edl_tpu.parallel.sharding import axis_size as jax_axis_size
from edl_tpu.parallel.sharding import present_axes as jax_present_axes
from edl_tpu_torch.parallel import collective as tc
from edl_tpu_torch.parallel import mesh as tmesh
from edl_tpu_torch.parallel import sharding as tsharding
from edl_tpu_torch.parallel.mesh import Mesh
from edl_tpu_torch.parallel.mesh import MeshSpec as TorchMeshSpec

SHAPES = [(8, 4096), (4096, 8), (12, 12), (6, 10, 4), (7, 9), (1,), (3, 64, 2),
          (768, 3, 12, 64), (1000192, 10), (16, 16, 16), ()]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zero_shard_dim_matches_jax(shape, n):
    assert tc.zero_shard_dim(shape, n) == jc.zero_shard_dim(shape, n)


def _rank_mesh(axes):
    """A port mesh of the axes' shape, seen from rank 0 (no process group:
    the spec needs only names and sizes)."""
    spec = TorchMeshSpec(axes)
    names = spec.ordered_axes()
    return Mesh(names, [spec.axis(n) for n in names], 0, spec.size())


@pytest.mark.parametrize("axes,batch_axis", [
    ({"data": 2}, "data"),
    ({"data": 4}, "data"),
    ({"data": 8}, "data"),
    ({"dcn": 2, "data": 2}, ("dcn", "data")),
    ({"dcn": 2, "data": 4}, ("dcn", "data")),
    ({"data": 2, "expert": 2}, "data"),
    ({"data": 4}, "expert"),  # no batch axis on the mesh
    ({"dcn": 2, "data": 2}, "data"),
], ids=str)
@pytest.mark.parametrize("shape", SHAPES[:-1], ids=str)
def test_zero_shard_spec_matches_jax(axes, batch_axis, shape):
    """The port's spec names the dim and the batch axes that JAX's
    PartitionSpec puts there."""
    spec = MeshSpec(axes)
    jmesh = build_mesh(spec, jax.devices()[:spec.size()])
    want = jc.zero_shard_spec(shape, jmesh, batch_axis)
    got = tc.zero_shard_spec(shape, _rank_mesh(axes), batch_axis)
    if want is None:
        assert got is None
        return
    (dim,) = [i for i, e in enumerate(want) if e is not None]
    entry = want[dim]
    assert got == tc.ShardSpec(dim, entry if isinstance(entry, tuple) else (entry,))
    assert isinstance(want, P)


@pytest.mark.parametrize("bucket_bytes", [1, 100, 4096, 1 << 20, 1 << 30])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_buckets_matches_jax(bucket_bytes, seed):
    sizes = np.random.default_rng(seed).integers(1, 50_000, size=37).tolist()
    want = jc.assign_buckets(sizes, bucket_bytes)
    got = tc.assign_buckets(sizes, bucket_bytes)
    assert [(b.indices, b.nbytes) for b in got] == [(b.indices, b.nbytes) for b in want]
    with pytest.raises(ValueError):
        tc.assign_buckets(sizes, 0)


@pytest.mark.parametrize("op", ["all_reduce", "reduce_scatter", "all_gather"])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_ring_bytes_matches_jax(op, n):
    assert tc.ring_bytes(1e6 + 3, n, op) == jc.ring_bytes(1e6 + 3, n, op)


TIERS = [[("data", 4)], [("dcn", 2), ("data", 4)], [("dcn", 1), ("data", 8)],
         [("dcn", 3), ("data", 2)], [("a", 2), ("b", 3), ("c", 4)], []]


@pytest.mark.parametrize("op", ["all_reduce", "reduce_scatter", "all_gather"])
@pytest.mark.parametrize("tiers", TIERS, ids=str)
def test_collective_bytes_matches_jax(op, tiers):
    assert tc.collective_bytes(123_456_789, tiers, op) == jc.collective_bytes(
        123_456_789, tiers, op)


@pytest.mark.parametrize("grad_sync", ["psum", "reduce_scatter"])
@pytest.mark.parametrize("tiers", TIERS, ids=str)
def test_zero1_step_bytes_matches_jax(grad_sync, tiers):
    got = tc.zero1_step_bytes(4e8, 3e6, tiers, grad_sync)
    assert got == jc.zero1_step_bytes(4e8, 3e6, tiers, grad_sync)
    if any(n > 1 for _, n in tiers) and grad_sync == "reduce_scatter":
        assert got["total"] < tc.zero1_step_bytes(4e8, 3e6, tiers, "psum")["total"]


def test_unknown_ops_raise_as_in_jax():
    for fn in (lambda: tc.ring_bytes(1, 2, "x"), lambda: tc.collective_bytes(1, [], "x"),
               lambda: tc.zero1_step_bytes(1, 1, [], "x")):
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("tiers", TIERS, ids=str)
def test_estimate_collective_seconds_uses_the_same_formula(tiers):
    """With the JAX package's link rates passed in, the same seconds; by
    default, the data sheets' NVLink and InfiniBand rates."""
    acct = tc.zero1_step_bytes(4e8, 3e6, tiers, "reduce_scatter")
    assert tc.estimate_collective_seconds(
        acct, jc.ICI_BYTES_PER_SEC, jc.DCN_BYTES_PER_SEC
    ) == jc.estimate_collective_seconds(acct)
    want = sum(acct[name] / (tc.INFINIBAND_BYTES_PER_SEC if name == "dcn"
                             else tc.NVLINK_BYTES_PER_SEC) for name, _ in tiers)
    assert tc.estimate_collective_seconds(acct) == pytest.approx(want, rel=1e-15)


# -- the mesh of ranks ---------------------------------------------------------
MESHES = [{"data": 4}, {"data": 2, "expert": 2}, {"dcn": 2, "data": 2},
          {"dcn": 2, "data": 2, "model": 2}, {"data": 2, "seq": 2, "model": 2},
          {"pipe": 2, "data": 2}]


@pytest.mark.parametrize("axes", MESHES, ids=str)
def test_rank_r_sits_where_jax_device_r_sits(axes):
    """Tolerance: none. The port's mesh names the JAX mesh's axes in the
    same order, and rank r's coordinates are those of JAX device r (the
    r-th of the devices the mesh was built from), hierarchy included; so
    is its index over a batch-axis tuple."""
    spec = MeshSpec(axes)
    devs = jax.devices()[:spec.size()]
    build = build_hierarchical_mesh if "dcn" in axes else build_mesh
    jmesh = build(spec, devs)
    tspec = tmesh.MeshSpec(axes)
    assert tspec.ordered_axes() == spec.ordered_axes()
    assert tmesh.AXIS_ORDER == ("dcn", "data", "pipe", "seq", "expert", "model")
    for r, dev in enumerate(devs):
        m = Mesh(tspec.ordered_axes(), [tspec.axis(a) for a in tspec.ordered_axes()], r,
                 tspec.size())
        where = np.argwhere(np.vectorize(lambda d: d == dev)(jmesh.devices))[0]
        assert m.coords() == dict(zip(jmesh.axis_names, map(int, where)))
        for batch in ("data", ("dcn", "data"), "expert"):
            have = jax_present_axes(jmesh, batch)
            assert tsharding.present_axes(m, batch) == have
            assert tsharding.axis_size(m, batch) == jax_axis_size(jmesh, batch)
            if have:
                jidx = int(np.ravel_multi_index([where[jmesh.axis_names.index(a)]
                                                 for a in have],
                                                [jmesh.shape[a] for a in have]))
                assert m.axis_index(have) == jidx


@pytest.mark.parametrize("parallelism,trainers", [({"model": 2}, 4), ({}, 1), ({"data": 2}, 3),
                                                  ({"expert": 1, "seq": 2}, 2)])
def test_mesh_spec_for_job_matches_jax(parallelism, trainers):
    assert tmesh.MeshSpec.for_job(parallelism, trainers).axes == MeshSpec.for_job(
        parallelism, trainers).axes


def test_mesh_needs_a_process_group_or_one_rank():
    """build_mesh raises without a process group; local_mesh is one rank
    that issues no collective; a lookup across shards needs the mesh."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.build_mesh(tmesh.MeshSpec({"data": 2}))
    with pytest.raises(ValueError, match="one rank"):
        tmesh.local_mesh({"data": 2})
    local = tmesh.local_mesh()
    assert (local.world, local.distributed, local.group("data")) == (1, False, None)
    batch = {"x": np.arange(8).reshape(4, 2)}
    assert tsharding.shard_batch(batch, local)["x"].shape == (4, 2)
    assert tsharding.global_batch_size(4, Mesh(["data"], [4], 0, 4)) == 16
    two = Mesh(["data"], [2], 1, 2)
    np.testing.assert_array_equal(tsharding.shard_batch(batch, two)["x"],
                                  batch["x"][2:])
