"""Data parallelism and ZeRO-1 over ``torch.distributed``: the port's mesh
Trainer on gloo ranks against the JAX Trainer on a CPU mesh of the same
shape, from the same numpy params (`models.convert`) and batches.

Each test spawns one set of ranks (`torch_dp_worker.spawn_ranks`: one
process a rank, no JAX in them) that runs several cases, while this process
runs the JAX references. Meshes: ``{"data": 2}``, ``{"data": 4}``,
``{"dcn": 2, "data": 2}`` (batch axes ``("dcn", "data")``) and ``{"data": 2,
"expert": 2}`` (CTR's tables over ``expert``: the cross-axis lookup).

Tolerances (the one-device parity bounds of `tests/test_torch_train_loop.py`,
since the mesh splits the same f32 sums and bf16 matmuls in other places):

- losses: rel 1e-3 against JAX; every rank returns the same global loss,
  exactly;
- params after Adam: 2 * steps * lr absolute (a gradient that is rounding
  noise on both sides can step either way each time); Adam's mu and nu on
  each rank: relative norm error 5e-2 per leaf (measured at most 3.1e-2);
- CTR under adagrad at its lr 0.05: each leaf's total update, and each
  rank's accumulator less its 0.1 start, to a relative norm error of 0.15.
  The MLP's bf16 weight gradients are rounded to bf16 on each rank before
  the cross-rank sum (the JAX partitioner sums them first): 2.3e-3 a step
  from one state, which three steps of lr 0.05 amplify to at most 8.4e-2
  in the clipped cases (1.2e-2 unclipped);
- the moments' placement: a ZeRO-1 leaf's moments on rank r have the shape
  and values of JAX device r's shard; a table's moments are the table's
  own rows on the rank (JAX's jitted init leaves them on one device and
  ZeRO-1 then splits them over the batch axes, which is the same rows in
  the same-axis lookup and other rows of the same tensor across axes);
- ``psum`` against ``reduce_scatter`` at world 2 (each sum is of two
  terms, so the order cannot matter): params equal, tolerance 0;
- the lookups: outputs equal (each row has one owner; the others add
  zeros), table gradients, summed over the ranks that hold the same rows,
  to rel 1e-6 (duplicate ids add in another order);
- ``data_plane()``: the JAX Trainer's keys, and the same bytes, exactly.
"""

import threading

import jax
import numpy as np
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from edl_tpu.models import ctr as jax_ctr
from edl_tpu.models import transformer as jax_tf
from edl_tpu.parallel import MeshSpec, build_hierarchical_mesh, build_mesh
from edl_tpu.parallel.embedding import ShardedEmbedding as JaxEmbedding
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu_torch.models.convert import params_from_jax, tree_params_from_jax
from torch_dp_worker import spawn_ranks

LM = dict(vocab_size=64, d_model=64, n_layers=2, n_heads=4, d_ff=128, seq_len=16,
          flash=False)
CTR_SPARSE = 1000
STEPS = 3
LOSS_RTOL = 1e-3
MOMENT_REL_NORM = 5e-2
ADAGRAD_REL_NORM = 0.15
ADAM = dict(optimizer="adam", learning_rate=1e-3)
ADAGRAD = dict(optimizer="adagrad", learning_rate=0.05)


def _jax_mesh(axes):
    spec = MeshSpec(dict(axes))
    devs = jax.devices()[:spec.size()]
    return (build_hierarchical_mesh if "dcn" in axes else build_mesh)(spec, devs)


def _to_torch(kind):
    return params_from_jax if kind == "lm" else tree_params_from_jax


class Case:
    """One configuration: the JAX Trainer on its mesh, the case the ranks
    run, and the comparison of their results."""

    def __init__(self, kind, model_kw, cfg, axes, batch=16):
        self.kind, self.cfg = kind, cfg
        self.tables = ("deep_table", "wide_table") if kind == "ctr" else ()
        self.table_axis = model_kw.get("shard_axis", "data")
        jmodel = (jax_ctr.make_model(**model_kw) if kind == "ctr"
                  else jax_tf.make_model(jax_tf.TransformerConfig(**model_kw)))
        self.jtrainer = JaxTrainer(jmodel, _jax_mesh(axes), JaxConfig(**cfg))
        self.jstate = self.jtrainer.init_state(jax.random.PRNGKey(0))
        self.init = _to_torch(kind)(jax.device_get(self.jstate.params))
        self.batches = [jmodel.synthetic_batch(np.random.default_rng(s), batch)
                        for s in range(STEPS)]
        self.rank_case = dict(model=kind, model_kwargs=model_kw, config=cfg,
                              axes=axes, params=self.init, batches=self.batches)

    def run_jax(self):
        self.jlosses = []
        for b in self.batches:
            self.jstate, loss = self.jtrainer.train_step(self.jstate,
                                                         self.jtrainer.place_batch(b))
            self.jlosses.append(float(loss))
        self.jfinal = _to_torch(self.kind)(jax.device_get(self.jstate.params))

    def jax_moments(self, r):
        """{torch moment name: ({param name: JAX's whole moment}, {param name:
        JAX device r's shard of it})}."""
        dev = self.jtrainer.mesh.devices.flat[r]
        (st,) = [s for s in jax.tree_util.tree_leaves(
            self.jstate.opt_state,
            is_leaf=lambda x: hasattr(x, "mu") or hasattr(x, "sum_of_squares"))
            if hasattr(s, "mu") or hasattr(s, "sum_of_squares")]
        trees = ({"exp_avg": st.mu, "exp_avg_sq": st.nu} if hasattr(st, "mu")
                 else {"sum_of_squares": st.sum_of_squares})

        def on_device(x):
            mine = [s for s in x.addressable_shards if s.device == dev]
            return np.asarray(mine[0].data if mine else x)

        to_torch = _to_torch(self.kind)
        return {k: (to_torch(jax.tree_util.tree_map(np.asarray, t)),
                    to_torch(jax.tree_util.tree_map(on_device, t)))
                for k, t in trees.items()}

    def expected_moment(self, r, name, zero_dim, whole, on_device):
        """What rank r should hold of a moment: a ZeRO-1 leaf's is JAX
        device r's shard; a table's, the table's own rows on this rank
        (JAX's jitted init leaves the table moments on one device, so its
        ZeRO-1 reshards them over the batch axes: the same rows in the
        same-axis lookup, other rows of the same tensor across axes);
        any other leaf's, the whole moment."""
        if zero_dim is not None:
            assert on_device.shape != whole.shape, (r, name, "JAX holds it whole")
            return on_device
        if name in self.tables:
            axes = list(self.jtrainer.mesh.axis_names)
            coords = dict(zip(axes, np.unravel_index(
                r, [self.jtrainer.mesh.shape[a] for a in axes])))
            n = self.jtrainer.mesh.shape[self.table_axis]
            rows = whole.shape[0] // n
            i = coords[self.table_axis]
            return whole[i * rows:(i + 1) * rows]
        return whole

    def check(self, results):
        """``results``: this case's result on every rank."""
        got = results[0]
        np.testing.assert_allclose(got["losses"], self.jlosses, rtol=LOSS_RTOL)
        for r, res in enumerate(results):
            assert res["losses"] == got["losses"], r
        adam = self.cfg["optimizer"] == "adam"
        lr = self.cfg["learning_rate"]
        for name, want in self.jfinal.items():
            have = got["params"][name]
            assert have.shape == want.shape, name
            if adam:
                np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=0,
                                           atol=2 * STEPS * lr, err_msg=name)
            else:
                step_t, step_j = have - self.init[name], want - self.init[name]
                if step_j.norm() == 0:
                    assert step_t.norm() == 0, name
                else:
                    assert _rel(step_t, step_j) <= ADAGRAD_REL_NORM, name
        sharded = 0
        for r, res in enumerate(results):
            for moment, (whole, on_device) in self.jax_moments(r).items():
                for name in whole:
                    want = self.expected_moment(r, name, res["zero"][name], whole[name],
                                                on_device[name])
                    have = res["moments"][name][moment]
                    assert tuple(have.shape) == tuple(want.shape), (r, name, moment)
                    sharded += have.numel() < whole[name].numel()
                    if moment == "sum_of_squares":
                        have, want = have - 0.1, want - 0.1
                    if want.norm() == 0:
                        assert have.norm() == 0, (r, name, moment)
                    else:
                        bound = MOMENT_REL_NORM if adam else ADAGRAD_REL_NORM
                        assert _rel(have, want) <= bound, (r, name, moment)
        if self.cfg.get("shard_opt_state"):
            assert sharded, "no moment was sharded"
        want_plane = self.jtrainer.data_plane(self.jstate.params)
        plane = got["data_plane"]
        assert set(plane) == set(want_plane)
        for key in ("grad_sync", "grad_accum_microbatches", "sharded_bytes",
                    "replicated_bytes", "grad_bytes_per_step", "param_bytes_per_step",
                    "bytes_per_step", "per_tier_bytes"):
            assert plane[key] == want_plane[key], key
        assert [tuple(t) for t in plane["tiers"]] == [tuple(t) for t in want_plane["tiers"]]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def _lookup_case(axes, shard_axis, batch_axis, seed):
    rng = np.random.default_rng(seed)
    vocab, features = 1000, 4
    table = rng.standard_normal((1024, features)).astype(np.float32)
    ids = rng.integers(0, vocab, (8, 3)).astype(np.int32)
    ids[0] = ids[1]  # duplicate rows across ranks
    ct = rng.standard_normal((8, 3, features)).astype(np.float32)
    return dict(axes=axes, vocab=vocab, shard_axis=shard_axis, batch_axis=batch_axis,
                table=table, ids=ids, cotangent=ct)


def _check_lookup(case, results):
    """Each rank's output rows and table gradient rows against JAX's."""
    jmesh = _jax_mesh(case["axes"])
    emb = JaxEmbedding(case["vocab"], case["table"].shape[1], case["shard_axis"],
                       case["batch_axis"])
    table = jax.device_put(case["table"], NamedSharding(jmesh, emb.table_spec()))
    ids = jax.device_put(case["ids"], NamedSharding(jmesh, P(case["batch_axis"])))
    out, vjp = jax.vjp(lambda t: emb.apply(jmesh, t, ids), table)
    (grad,) = vjp(jax.numpy.asarray(case["cotangent"]))
    out, grad = np.asarray(out), np.asarray(grad)
    shape = dict(jmesh.shape)
    names = list(jmesh.axis_names)
    summed = {}
    for r, res in enumerate(results):
        coords = dict(zip(names, np.unravel_index(r, [shape[a] for a in names])))
        b = out.shape[0] // shape[case["batch_axis"]]
        i = coords[case["batch_axis"]]
        np.testing.assert_array_equal(res["out"].numpy(), out[i * b:(i + 1) * b])
        s = int(coords[case["shard_axis"]])
        summed[s] = summed.get(s, 0) + res["grad"].numpy()
    # a rank's table gradient is its own ids' part; the ranks holding the
    # same rows add up to JAX's (the Trainer all-reduces over those ranks)
    rows = grad.shape[0] // shape[case["shard_axis"]]
    for s, g in summed.items():
        np.testing.assert_allclose(g, grad[s * rows:(s + 1) * rows], rtol=1e-6, atol=1e-6)


def _spawn(tmp_path, world, cases, lookups=()):
    tasks = [("train", c.rank_case) for c in cases] + [("lookup", c) for c in lookups]

    def jax_side():
        for c in cases:
            c.run_jax()

    results, _ = spawn_ranks(tmp_path, world, tasks, overlap=jax_side)
    return results


def test_world_2(tmp_path):
    """{"data": 2}: CTR (same-axis lookup, adagrad) in both grad_sync modes
    with clipping; the small LM (Adam) in both modes with 2 microbatches;
    the same-axis lookup."""
    ctr = dict(sparse_dim=CTR_SPARSE)
    zero = dict(shard_opt_state=True)
    axes = {"data": 2}
    cases = [
        Case("ctr", ctr, dict(ADAGRAD, grad_sync="psum", grad_clip_norm=1.0, **zero), axes),
        Case("ctr", ctr, dict(ADAGRAD, grad_sync="reduce_scatter", grad_clip_norm=1.0,
                              **zero), axes),
        Case("lm", LM, dict(ADAM, grad_sync="psum", grad_accum_microbatches=2, **zero),
             axes, batch=8),
        Case("lm", LM, dict(ADAM, grad_sync="reduce_scatter", grad_accum_microbatches=2,
                            **zero), axes, batch=8),
    ]
    lookup = _lookup_case(axes, "data", "data", 0)
    results = _spawn(tmp_path, 2, cases, [lookup])
    for i, case in enumerate(cases):
        case.check([res[i] for res in results])
    for a, b in ((0, 1), (2, 3)):  # psum against reduce_scatter
        pa, pb = results[0][a]["params"], results[0][b]["params"]
        for name in pa:
            assert torch.equal(pa[name], pb[name]), name
    _check_lookup(lookup, [res[len(cases)] for res in results])


def test_world_4_hierarchy_and_cross_axis(tmp_path):
    """Four ranks: {"data": 4} (the LM with clipping under reduce_scatter,
    CTR under psum with 2 microbatches, no ZeRO); {"dcn": 2, "data": 2}
    (the LM over ("dcn", "data")); {"data": 2, "expert": 2} (CTR's tables
    over expert, the cross-axis lookup, under reduce_scatter with
    clipping); and both lookups across shards."""
    ctr = dict(sparse_dim=CTR_SPARSE)
    zero = dict(shard_opt_state=True)
    dcn_lm = dict(LM, batch_axis=("dcn", "data"))
    cases = [
        Case("lm", LM, dict(ADAM, grad_sync="reduce_scatter", grad_clip_norm=1.0, **zero),
             {"data": 4}, batch=8),
        Case("ctr", ctr, dict(ADAGRAD, grad_sync="psum", grad_accum_microbatches=2),
             {"data": 4}),
        Case("lm", dcn_lm, dict(ADAM, batch_axis=("dcn", "data"), **zero),
             {"dcn": 2, "data": 2}, batch=8),
        Case("ctr", dict(ctr, shard_axis="expert", batch_axis="data"),
             dict(ADAGRAD, grad_sync="reduce_scatter", grad_clip_norm=1.0, **zero),
             {"data": 2, "expert": 2}),
    ]
    lookups = [_lookup_case({"data": 4}, "data", "data", 1),
               _lookup_case({"data": 2, "expert": 2}, "expert", "data", 2)]
    results = _spawn(tmp_path, 4, cases, lookups)
    for i, case in enumerate(cases):
        case.check([res[i] for res in results])
    for j, lookup in enumerate(lookups):
        _check_lookup(lookup, [res[len(cases) + j] for res in results])


def test_distributed_init_through_the_in_process_coordinator(tmp_path):
    """Two trainers settle their identities through one
    `InProcessCoordinator` (rank 0's address under the JAX package's
    epoch-scoped key); then one forms a gloo process group at world 1
    through `distributed_init`, and the mesh Trainer over it steps CTR
    bit for bit as the one-device Trainer does (tolerance 0), in both
    grad_sync modes."""
    import torch.distributed as dist

    from edl_tpu.runtime import distributed as jax_distributed
    from edl_tpu_torch.coordinator import InProcessCoordinator
    from edl_tpu_torch.launcher.launch import LaunchContext
    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.parallel.mesh import MeshSpec as TorchMeshSpec
    from edl_tpu_torch.parallel.mesh import build_mesh as torch_build_mesh
    from edl_tpu_torch.runtime import distributed
    from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig

    assert distributed.PG_ADDRESS_KEY == jax_distributed.JAX_COORD_KEY
    assert distributed.EXPECTED_WORLD_KEY == jax_distributed.EXPECTED_WORLD_KEY
    coord = InProcessCoordinator(heartbeat_ttl_sec=600)
    ctx = LaunchContext(num_trainers=2, port=7000)
    idents = {}

    def settle(name):
        idents[name] = distributed.derive_identity(ctx, coord.client(name), timeout=60,
                                                   host="127.0.0.1")

    threads = [threading.Thread(target=settle, args=(f"w{i}",)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(90)
    assert sorted(i.process_id for i in idents.values()) == [0, 1]
    assert {(i.num_processes, i.init_method) for i in idents.values()} == {
        (2, "tcp://127.0.0.1:7001")}
    assert coord.kv_get(f"{distributed.PG_ADDRESS_KEY}/{coord.epoch()}") == "127.0.0.1:7001"
    assert distributed.distributed_init(ctx, None) is None

    solo = InProcessCoordinator(heartbeat_ttl_sec=600)
    ident = distributed.distributed_init(
        LaunchContext(num_trainers=1), solo.client("solo"), backend="gloo",
        init_method=f"file://{tmp_path}/pg", timeout=60)
    try:
        assert (ident.process_id, ident.num_processes) == (0, 1)
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        mesh = torch_build_mesh(TorchMeshSpec({"data": 1}))
        model = ctr.make_model(sparse_dim=CTR_SPARSE)
        batch = model.synthetic_batch(np.random.default_rng(0), 16)
        for sync in ("psum", "reduce_scatter"):
            cfg = TrainerConfig(shard_opt_state=True, grad_sync=sync, **ADAGRAD)
            on_mesh = Trainer(model, mesh=mesh, config=cfg, device="cpu")
            plain = Trainer(model, config=cfg, device="cpu")
            a, b = on_mesh.init_state(), plain.init_state()
            for _ in range(2):
                a, la = on_mesh.train_step(a, on_mesh.place_batch(batch))
                b, lb = plain.train_step(b, plain.place_batch(batch))
                assert torch.equal(la, lb), sync
            for (name, x), y in zip(a.params.state_dict().items(),
                                    b.params.state_dict().values()):
                assert torch.equal(x, y), (sync, name)
    finally:
        dist.destroy_process_group()
