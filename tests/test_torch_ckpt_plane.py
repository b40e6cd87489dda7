"""The port's checkpoint plane (`edl_tpu_torch.ckpt_plane`) against the JAX
package's (`edl_tpu.ckpt_plane`).

The cases of ``tests/test_ckpt_plane.py`` run on the port: placement, the
shard codec, zero-blob recovery through the in-process coordinator, and the
worker integration. The blob format is numpy-level and shared: the same
leaves serialize to the same bytes in both packages (bf16 included), and a
blob either package writes is parsed and assembled by the other, across a
non-dividing world change (6 -> 4). The port's state travels as a
`Trainer.full_state` dict; restores are bit for bit.
"""

import base64
import logging

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import edl_tpu.ckpt_plane as jax_plane
from edl_tpu.models import ctr as jax_ctr
from edl_tpu.parallel import MeshSpec as JaxMeshSpec
from edl_tpu.parallel import build_mesh as jax_build_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu_torch.ckpt_plane import (CkptPlane, assemble_leaves, chunk_blob,
                                      host_leaves, leaf_slice, owner_key,
                                      parse_shard, placement_map, read_placement,
                                      replica_group, serialize_shard, state_template)
from edl_tpu_torch.coordinator import InProcessCoordinator
from edl_tpu_torch.models import ctr, fit_a_line
from edl_tpu_torch.runtime.data import SyntheticShardSource, shard_names
from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker
from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig

SPARSE = 1000


def plane_on(coord, name="w0", **kw):
    client = coord.client(name)
    client.register()
    return CkptPlane(client, **kw)


def np_leaves():
    return [
        np.arange(48, dtype=np.float32).reshape(12, 4),
        np.float32(3.5),  # scalar: owned whole by rank 0
        np.arange(35, dtype=np.int32).reshape(5, 7),  # nothing divides
        np.linspace(-3, 3, 24).astype(ml_dtypes.bfloat16).reshape(6, 4),
    ]


def trained(optimizer="adam", steps=2, seed=0):
    """A small CTR trainer (one device, the CPU) and its state after a few
    steps: every leaf kind a full state holds (tables, dense weights,
    moments, step counts)."""
    model = ctr.make_model(sparse_dim=SPARSE)
    trainer = Trainer(model, None, TrainerConfig(optimizer=optimizer,
                                                 learning_rate=0.01), device="cpu")
    state = trainer.init_state()
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch = model.synthetic_batch(rng, 16)
        state, _ = trainer.train_step(state, trainer.place_batch(batch))
    return trainer, state


def assert_full_equal(a, b):
    assert a["step"] == b["step"]
    assert a["module"].keys() == b["module"].keys()
    for k in a["module"]:
        assert torch.equal(a["module"][k], b["module"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


# -- placement -----------------------------------------------------------------


def test_replica_group_is_a_ring():
    assert replica_group(0, 4, 1) == [1]
    assert replica_group(3, 4, 2) == [0, 1]
    assert replica_group(0, 1, 3) == []
    assert replica_group(1, 3, 5) == [2, 0]


def test_placement_map_covers_every_rank():
    m = placement_map(4, 2)
    assert sorted(m) == [0, 1, 2, 3]
    for r, holders in m.items():
        assert r not in holders and len(holders) == 2


def test_publish_placement_invalidates_previous_epoch():
    coord = InProcessCoordinator()
    plane = plane_on(coord, replicas=2)
    plane.on_epoch(3, world=4, rank=0)
    doc = read_placement(plane.client, 3)
    assert doc["world"] == 4 and doc["groups"][1] == [2, 3]
    plane.on_epoch(4, world=2, rank=0)
    assert read_placement(plane.client, 3) is None
    assert read_placement(plane.client, 4)["world"] == 2


# -- shard codec ---------------------------------------------------------------


def test_leaf_slice_mirrors_zero_shard_layout():
    arr = np.arange(48, dtype=np.float32).reshape(12, 4)
    piece, dim = leaf_slice(arr, 2, 6)
    assert dim == 0
    np.testing.assert_array_equal(piece, arr[4:6])
    odd = np.arange(35).reshape(5, 7)
    whole, dim = leaf_slice(odd, 0, 6)
    assert dim is None
    np.testing.assert_array_equal(whole, odd)
    assert leaf_slice(odd, 3, 6) == (None, None)


def test_serialize_parse_chunk_roundtrip():
    blob = serialize_shard(np_leaves(), step=9, rank=1, world=6)
    manifest, payload = parse_shard(blob)
    assert manifest["step"] == 9 and manifest["world"] == 6
    assert sum(m["nbytes"] for m in manifest["leaves"]) == len(payload)
    chunks = chunk_blob(blob, chunk_bytes=16)
    assert b"".join(base64.b64decode(c) for c in chunks) == blob
    assert chunk_blob(b"") == [base64.b64encode(b"").decode("ascii")]


def test_parse_shard_rejects_blob_without_manifest():
    with pytest.raises(ValueError, match="no manifest line"):
        parse_shard(b"raw bytes only, no newline")


def test_assemble_across_non_dividing_world_change_6_to_4():
    leaves = np_leaves()
    parts = {r: parse_shard(serialize_shard(leaves, step=1, rank=r, world=6))
             for r in range(6)}
    full = assemble_leaves(parts)
    for orig, got in zip(leaves, full):
        assert np.asarray(orig).tobytes() == got.tobytes()
    for orig, got in zip(leaves, full):
        for rank in range(4):
            want, wdim = leaf_slice(np.asarray(orig), rank, 4)
            have, hdim = leaf_slice(got, rank, 4)
            assert wdim == hdim
            assert (want is None) == (have is None)
            if want is not None:
                assert want.tobytes() == have.tobytes()


# -- the format is the JAX package's -------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 6])
def test_blobs_and_chunks_are_the_jax_packages_bytes(world):
    """The same numpy leaves (an ml_dtypes bf16 leaf among them, and the
    port's own bf16 tensor's host form) serialize and chunk to the JAX
    package's bytes for every rank."""
    leaves = np_leaves()
    from edl_tpu_torch.ckpt_plane.replicator import to_numpy

    port_bf16 = to_numpy(torch.tensor(leaves[3].astype(np.float32), dtype=torch.bfloat16))
    for rank in range(world):
        want = jax_plane.serialize_shard(leaves, 5, rank, world)
        assert serialize_shard(leaves, 5, rank, world) == want
        assert serialize_shard(leaves[:3] + [port_bf16], 5, rank, world) == want
        assert chunk_blob(want, 64) == jax_plane.chunk_blob(want, 64)
        assert leaf_slice(leaves[0], rank, world)[1] == \
            jax_plane.leaf_slice(leaves[0], rank, world)[1]


def _cross(write, read, leaves):
    """Serialize at world 6 with ``write``'s package, parse and assemble
    with ``read``'s, then re-slice for world 4 with both."""
    parts = {r: read.parse_shard(write.serialize_shard(leaves, 3, r, 6))
             for r in range(6)}
    full = read.assemble_leaves(parts)
    assert len(full) == len(leaves)
    for orig, got in zip(leaves, full):
        orig = np.asarray(orig)
        assert orig.shape == got.shape and orig.tobytes() == got.tobytes()
        for r in range(4):
            a, da = write.leaf_slice(orig, r, 4)
            b, db = read.leaf_slice(got, r, 4)
            assert da == db and (a is None) == (b is None)
            if a is not None:
                assert a.tobytes() == b.tobytes()


def _jax_state_leaves():
    model = jax_ctr.make_model(sparse_dim=SPARSE)
    trainer = JaxTrainer(model, jax_build_mesh(JaxMeshSpec({"data": 1}), jax.devices()[:1]),
                         JaxConfig(optimizer="adam", learning_rate=0.01))
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    state, _ = trainer.train_step(state, trainer.place_batch(model.synthetic_batch(rng, 16)))
    return jax_plane.host_leaves(state)[0]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_blobs_cross_between_the_packages_6_to_4(direction):
    """A trained state's leaves — the JAX TrainState's, or the port's full
    state's — written by one package at world 6 are assembled by the other
    byte for byte and re-sliced alike for world 4."""
    import edl_tpu_torch.ckpt_plane as torch_plane

    if direction == "jax_to_torch":
        _cross(jax_plane, torch_plane, _jax_state_leaves())
    else:
        trainer, state = trained()
        _cross(torch_plane, jax_plane, host_leaves(trainer.full_state(state))[0])


# -- replicate / restore through the coordinator -------------------------------


def test_replicate_restore_roundtrip_is_byte_exact():
    coord = InProcessCoordinator()
    plane = plane_on(coord, chunk_bytes=4096)  # small chunks: force batching
    trainer, state = trained()
    full = trainer.full_state(state)
    info = plane.replicate_all(full, step=7, world=2)
    assert info is not None and info["chunks"] > 2
    restored, rinfo = plane.restore(full)
    assert rinfo["step"] == 7 and rinfo["source"] == "peer"
    assert_full_equal(restored, full)


@pytest.mark.parametrize("optimizer", ["adam", "adagrad", "sgd"])
def test_restore_of_world_6_shards_into_a_fresh_state(optimizer):
    """Replicated at plane-world 6, restored into a fresh Trainer's state
    (whose lazily built Adam moments do not exist yet: `state_template`
    supplies their layout): bit for bit, and the restored state steps."""
    coord = InProcessCoordinator()
    plane = plane_on(coord)
    trainer, state = trained(optimizer)
    full = trainer.full_state(state)
    assert plane.replicate_all(full, step=int(state.step), world=6) is not None
    fresh_trainer, _ = trained(optimizer, steps=0)
    fresh = fresh_trainer.init_state()
    restored, rinfo = plane.restore(state_template(fresh_trainer, fresh),
                                    trainer=fresh_trainer, state=fresh)
    assert rinfo["world_at_save"] == 6 and rinfo["step"] == int(state.step)
    assert_full_equal(fresh_trainer.full_state(restored), full)
    rng = np.random.default_rng(9)
    batch = fresh_trainer.model.synthetic_batch(rng, 16)
    _, loss_a = trainer.train_step(state, trainer.place_batch(batch))
    _, loss_b = fresh_trainer.train_step(restored, fresh_trainer.place_batch(batch))
    assert torch.equal(loss_a, loss_b)


def test_single_lost_owner_demotes_to_none(caplog):
    coord = InProcessCoordinator()
    plane = plane_on(coord)
    trainer, state = trained(steps=1)
    full = trainer.full_state(state)
    plane.replicate_all(full, step=5, world=4)
    plane.drop_owner(2)
    with caplog.at_level(logging.WARNING, logger="edl_tpu_torch.ckpt_plane"):
        assert plane.restore(full) is None
    assert any("falling back to blob restore" in r.message for r in caplog.records)


def test_whole_group_death_demotes_to_none():
    coord = InProcessCoordinator()
    plane = plane_on(coord)
    trainer, state = trained(steps=1)
    full = trainer.full_state(state)
    plane.replicate_all(full, step=5, world=3)
    for r in range(3):
        plane.drop_owner(r)
    assert plane.restore(full) is None


def test_min_step_floor_rejects_stale_plane():
    coord = InProcessCoordinator()
    plane = plane_on(coord)
    trainer, state = trained(steps=1)
    full = trainer.full_state(state)
    plane.replicate_all(full, step=5, world=2)
    assert plane.restore(full, min_step=6) is None
    _, rinfo = plane.restore(full, min_step=5)
    assert rinfo["step"] == 5


def test_duplicate_put_replay_is_idempotent():
    coord = InProcessCoordinator()
    plane = plane_on(coord, chunk_bytes=4096)
    trainer, state = trained(steps=1)
    full = trainer.full_state(state)
    plane.replicate_all(full, step=3, world=2)
    meta = plane.client.shard_meta(owner_key(0))
    reply = plane.client.shard_put(owner_key(0), 3, 0, int(meta["chunks"]), "Z0JBRA==",
                                   put_id="z0.s3.c0")
    assert reply.get("ok") and reply.get("duplicate")
    restored, _ = plane.restore(full)
    assert_full_equal(restored, full)


def test_stale_step_put_does_not_regress_latest():
    coord = InProcessCoordinator()
    plane = plane_on(coord)
    trainer, state = trained(steps=2)
    full = trainer.full_state(state)
    plane.replicate_all(full, step=9, world=2)
    old_trainer, old_state = trained(steps=1, seed=5)
    plane.replicate_all(old_trainer.full_state(old_state), step=4, world=2)
    restored, rinfo = plane.restore(full)
    assert rinfo["step"] == 9
    assert_full_equal(restored, full)


def test_ckpt_plane_rejects_zero_replicas():
    coord = InProcessCoordinator()
    with pytest.raises(ValueError, match="replicas"):
        plane_on(coord, replicas=0)


# -- worker integration --------------------------------------------------------


def test_elastic_worker_replicates_then_peer_restores(tmp_path):
    """A plane-enabled worker covers its checkpoints with peer shards; a
    successor worker restores from coordinator memory, not the blob."""
    coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    model = fit_a_line.MODEL
    admin = coord.client("admin")
    admin.add_tasks(shard_names("fit", 3))
    cfg = ElasticConfig(checkpoint_dir=str(tmp_path / "ck"), checkpoint_interval=4,
                        heartbeat_interval=0.0, peer_replicas=1,
                        trainer=TrainerConfig(optimizer="adam", learning_rate=0.05))
    source = SyntheticShardSource(model, batch_size=8, batches_per_shard=4)
    w1 = ElasticWorker(model, coord.client("trainer-0"), source, cfg, device="cpu")
    w1.run()
    meta = coord.client("probe").shard_meta(owner_key(0))
    assert meta.get("found") and meta.get("complete"), meta
    coord.client("trainer-0").leave()
    admin.add_tasks(shard_names("more", 2))
    w2 = ElasticWorker(model, coord.client("trainer-1"), source, cfg, device="cpu")
    w2.run()
    assert w2._last_restore["source"] == "peer", w2._last_restore
    assert w2._last_restore["bytes"] > 0
    assert w2.steps_done == 8


# -- the plane's smoke ---------------------------------------------------------


def test_the_smoke_gives_the_jax_smokes_three_verdicts():
    """``python -m edl_tpu_torch.ckpt_plane --device cpu`` exits 0 with the
    JAX smoke's report (``python -m edl_tpu.ckpt_plane``): the twin's loss,
    the peer restore's and the blob fallback's, each EQUAL to the twin's."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    procs = {pkg: subprocess.Popen([sys.executable, "-m", f"{pkg}.ckpt_plane", *args],
                                   cwd=root, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
             for pkg, args in (("edl_tpu_torch", ["--device", "cpu"]), ("edl_tpu", []))}
    reports = {}
    for pkg, p in procs.items():
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, (pkg, err[-4000:])
        reports[pkg] = json.loads(out[out.index("{"):])
    got, want = reports["edl_tpu_torch"], reports["edl_tpu"]
    assert got.pop("device") == "cpu"
    assert got.keys() == want.keys() and got["peer"].keys() == want["peer"].keys()
    assert got["blob_fallback"].keys() == want["blob_fallback"].keys()
    assert got["pass"] is want["pass"] is True
    assert got["peer"]["loss"] == got["blob_fallback"]["loss"] == got["twin_loss"]
    assert got["peer"]["source"] == want["peer"]["source"] == "peer"
