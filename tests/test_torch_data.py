"""The port's data path (`edl_tpu_torch.runtime.data`) against the JAX
package's, on the CPU. Tolerance: none — every comparison is exact.

- Shards written by either package's ``write_shard`` read row for row the
  same through either package's ``FileShardSource``, in file order and
  shuffled, the tail wrapped to the static batch shape; the row-count
  sidecar and the fallback without it agree.
- ``SyntheticShardSource`` gives the JAX package's batches for the same
  shard (the port's ``synthetic_batch`` draws the same arrays).
- Task ids (``pass_task``, ``split_pass``, ``pass_tasks``) and
  ``shard_seed`` are the same strings and integers.
- ``LeaseReader`` runs each scenario of the JAX package's lease tests
  (sync, prefetch, a stop mid-shard, a soft stop at a shard boundary,
  deferred completion) over the port's `InProcessCoordinator`, and the JAX
  reader runs it over the JAX coordinator: the same batches in the same
  order, the same shards completed in the same order, and the same queue
  status at the end.
"""

import numpy as np
import pytest

from edl_tpu.coordinator import InProcessCoordinator as JaxCoordinator
from edl_tpu.models import ctr as jax_ctr
from edl_tpu.models import fit_a_line as jax_fit
from edl_tpu.runtime import data as jax_data
from edl_tpu_torch.coordinator import InProcessCoordinator
from edl_tpu_torch.models import ctr, fit_a_line
from edl_tpu_torch.runtime import data

PACKAGES = {"port": (data, InProcessCoordinator, {"ctr": ctr.MODEL, "fit": fit_a_line.MODEL}),
            "jax": (jax_data, JaxCoordinator, {"ctr": jax_ctr.MODEL, "fit": jax_fit.MODEL})}


def _write(pkg, root, rows=(37, 20)):
    """Two CTR shards of uneven rows, written by ``pkg``'s write_shard."""
    mod = PACKAGES[pkg][0]
    rng = np.random.default_rng(7)
    names = mod.shard_names("ctr", len(rows))
    for name, n in zip(names, rows):
        mod.write_shard(str(root), name, ctr.MODEL.synthetic_batch(rng, n))
    return names


@pytest.mark.parametrize("shuffle", [None, 3], ids=["file_order", "shuffled"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_shards_cross_between_packages_row_for_row(tmp_path, writer, reader, shuffle):
    names = _write(writer, tmp_path)
    for task in (names[0], data.pass_task(names[1], 2)):
        got = list(PACKAGES[reader][0].FileShardSource(
            str(tmp_path), 16, shuffle_seed=shuffle).read(task))
        want = list(PACKAGES[writer][0].FileShardSource(
            str(tmp_path), 16, shuffle_seed=shuffle).read(task))
        assert len(got) == len(want) == (3 if task == names[0] else 2)
        for g, w in zip(got, want):
            assert set(g) == set(w) == {"dense", "sparse", "label"}
            for k in g:
                assert g[k].shape[0] == 16 and g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_tail_wraps_and_shuffle_keeps_rows(tmp_path):
    names = _write("jax", tmp_path, rows=(37,))
    with np.load(tmp_path / f"{names[0]}.npz") as f:
        rows = f["sparse"]
    plain = list(data.FileShardSource(str(tmp_path), 16).read(names[0]))
    np.testing.assert_array_equal(plain[2]["sparse"][:5], rows[32:37])
    np.testing.assert_array_equal(plain[2]["sparse"][5:], rows[:11])  # wrapped
    shuffled = np.concatenate([b["sparse"] for b in data.FileShardSource(
        str(tmp_path), 37, shuffle_seed=1).read(names[0])])
    assert sorted(map(tuple, shuffled)) == sorted(map(tuple, rows))
    assert not np.array_equal(shuffled, rows)


@pytest.mark.parametrize("sidecar", [True, False])
def test_rows_batch_count_and_listing_match(tmp_path, sidecar):
    names = _write("port", tmp_path)
    if not sidecar:
        for n in names:
            (tmp_path / f"{n}.npz.meta.json").unlink()
    src = data.FileShardSource(str(tmp_path), 16)
    jsrc = jax_data.FileShardSource(str(tmp_path), 16)
    assert src.list_shards() == jsrc.list_shards() == names
    assert [src.rows(n) for n in names] == [jsrc.rows(n) for n in names] == [37, 20]
    assert [src.batch_count(n) for n in names] == [3, 2]
    with pytest.raises(ValueError):
        data.write_shard(str(tmp_path), "bad", {"a": np.zeros(3), "b": np.zeros(4)})


def test_synthetic_source_task_ids_and_seeds_match():
    src = data.SyntheticShardSource(ctr.MODEL, batch_size=8, batches_per_shard=3)
    jsrc = jax_data.SyntheticShardSource(jax_ctr.MODEL, batch_size=8, batches_per_shard=3)
    for task in ("s/part-00004", "s/part-00004#p3"):
        for g, w in zip(src.read(task), jsrc.read(task), strict=True):
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
    assert src.batch_count("x") == 3
    shards = data.shard_names("d", 3)
    assert shards == jax_data.shard_names("d", 3)
    assert data.pass_tasks(shards, 3) == jax_data.pass_tasks(shards, 3)
    for task in data.pass_tasks(shards, 3) + ["a#pb", "a#p"]:
        assert data.split_pass(task) == jax_data.split_pass(task)
        assert data.shard_seed(task) == jax_data.shard_seed(task)


# -- LeaseReader, scenario by scenario against the JAX package's ------------------


def _scenario(pkg, name):
    """Run one lease scenario with ``pkg``'s coordinator, source and reader.
    Returns what the two packages must agree on."""
    mod, coordinator, models = PACKAGES[pkg]
    coord = coordinator(task_lease_sec=30.0)
    c = coord.client("r1")
    c.register()
    c.add_tasks(mod.shard_names("t", 3))
    source = mod.SyntheticShardSource(models["fit"], batch_size=8, batches_per_shard=3)
    count = [0]
    kw = {"sync": {}, "prefetch": dict(prefetch=True),
          "stop": dict(stop_check=lambda: count[0] >= 4),
          "stop_prefetch": dict(prefetch=True, stop_check=lambda: count[0] >= 4),
          "soft_stop": dict(soft_stop_check=lambda: count[0] >= 2),
          "soft_stop_prefetch": dict(prefetch=True, soft_stop_check=lambda: count[0] >= 2),
          "defer": dict(defer_completion=True)}[name]
    reader = mod.LeaseReader(c, source, **kw)
    seen = []
    for batch in reader:
        seen.append(batch["x"].copy())
        count[0] += 1
    status = {k: c.status()[k] for k in ("queued", "leased", "done")}
    held = reader.take_consumed()
    for task in held:
        c.complete_task(task)
    after = mod.LeaseReader(c, source)  # whatever is left, replays included
    rest = [b["x"].copy() for b in after]
    return dict(seen=seen, completed=reader.completed, held=held, status=status,
                interrupted=reader.interrupted, drained=reader.drained,
                exhausted=reader.exhausted, rest=rest, rest_done=after.completed)


@pytest.mark.parametrize("name", ["sync", "prefetch", "stop", "stop_prefetch",
                                  "soft_stop", "soft_stop_prefetch", "defer"])
def test_lease_reader_matches_the_jax_reader(name):
    got, want = _scenario("port", name), _scenario("jax", name)
    for key in ("completed", "held", "status", "interrupted", "drained",
                "exhausted", "rest_done"):
        assert got[key] == want[key], (key, got[key], want[key])
    for key in ("seen", "rest"):
        assert len(got[key]) == len(want[key])
        for g, w in zip(got[key], want[key]):
            np.testing.assert_array_equal(g, w)
    # every batch of the 3 shards is trained once, or twice if replayed
    assert len(got["seen"]) + len(got["rest"]) >= 9
    if name.startswith("stop"):
        assert got["interrupted"] == "t/part-00001" and got["status"]["leased"] == 0
    if name.startswith("soft_stop"):
        assert got["drained"] and len(got["seen"]) + len(got["rest"]) == 9
    if name == "defer":
        assert got["status"] == {"queued": 0, "leased": 3, "done": 0}
        assert got["held"] == data.shard_names("t", 3)
