"""Model parallelism of the LM: the port's mesh Trainer on gloo ranks against
the JAX Trainer on a CPU mesh of the same shape and against the port's
one-device Trainer, from the same numpy params (`models.convert`, the
interleaved storage order undone) and batches.

Each test spawns one set of ranks (`torch_dp_worker.spawn_ranks` with
`torch_mp_worker`: one process a rank, no JAX in them) that runs a few
cases, while this process runs the JAX references (a few cases a test, so
that no test holds a worker for long). The LM is small (4
layers, d_model 64, 4 heads, d_ff 128, S 64, vocab 64, batch 8) and uses
the einsum ring (``flash=False``); the flash ring is held in
`tests/test_torch_ring_attention.py`. MoE runs 4 experts at a no-drop
capacity (capacity factor 4), so the capacity per device group drops no
token on either side.

Tolerances:

- losses: relative 1e-3 against the JAX Trainer on the same mesh (the
  dp tests' bound; measured at most 5.8e-4, in the MoE cases, 3.7e-5 in
  the dense ones); relative 2e-2 against the port's one-device Trainer
  (the JAX package's own bound for a loss across mesh layouts,
  `tests/test_transformer.py:48`: the ring keeps P·V in f32 where one
  device's dense attention rounds P to bf16, and MoE's aux and capacity
  are per device group; measured at most 3.5e-4); every rank returns the
  same loss, exactly;
- params after 3 Adam steps at lr 1e-3: 2 * steps * lr absolute against
  both references. Adam moves an element by about lr a step whatever its
  gradient's size or sign, so this bound holds where each leaf lands (the
  layer order, the interleaved storage order, the gather of its shards),
  which a misplaced leaf misses by its own size (init scale 0.02), and not
  its gradient (measured at most 5.92e-3: elements whose gradient is
  rounding noise step either way); the gradients are held next;
- the first step's gradients, every leaf gathered whole on every rank
  (Adam's first moment after one step is ``(1 - beta1) * g`` on both
  sides, so no extra JAX compile is needed), as a relative norm error per
  leaf. A psum too many or too few, or a wrong 1/n, scales a leaf's
  gradient by 2 or 1/2 (an error of 1 or 0.5), where Adam's update and the
  losses barely move. Against the JAX Trainer on the same mesh: 5e-2 in
  the dense cases (measured at most 2.5e-2, ``blocks.*.bqkv``/``bin``:
  bf16 ulps); 0.5 in the MoE cases (measured at most 0.32, the router, and
  0.16 for the other leaves, the same on every mesh: the port's one-device
  module against JAX's one device reads 0.32 and 0.16 too on this batch,
  whose 512 tokens a layer include near-ties, gaps of the router's
  probabilities down to 1e-5, that the two sides' bf16 ulps of ``h`` route
  to different experts). Against the port's one-device Trainer: 0.15, a third of the
  smallest error of a psum too many or too few (measured at most 7.5e-2,
  the router of the top-2 aux case on ``{"data": 2, "expert": 2}``, whose
  aux is per device group as JAX's is; 2.2e-2 for every other leaf and
  case), so the MoE cases' boundary rule is held there;
- Adam's moments under ZeRO-1 on ``{"data": 2, "model": 2}``, gathered
  whole: relative norm error 5e-2 per leaf against JAX's (the dp tests'
  bound; measured at most 2.5e-2);
- ``data_plane()``: the JAX Trainer's bytes, exactly;
- a shard and gather round trip of the params: exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import SingleDeviceSharding

from edl_tpu.models import transformer as jax_tf
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.parallel import pipeline as jax_pipeline
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu_torch.models import transformer as torch_tf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.parallel import pipeline as torch_pipeline
from edl_tpu_torch.runtime import Trainer, TrainerConfig
from torch_dp_worker import spawn_ranks

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mp_worker.py")
LM = dict(vocab_size=64, d_model=64, n_layers=4, n_heads=4, d_ff=128, seq_len=64,
          flash=False)
MOE = dict(moe_experts=4, moe_capacity_factor=4.0)
STEPS = 3
BATCH = 8
ADAM = dict(optimizer="adam", learning_rate=1e-3)
LOSS_RTOL_JAX = 1e-3
LOSS_RTOL_ONE_DEVICE = 2e-2
PARAM_ATOL = 2 * STEPS * ADAM["learning_rate"]
GRAD_REL_NORM_JAX = 5e-2
GRAD_REL_NORM_JAX_MOE = 0.5
GRAD_REL_NORM_ONE_DEVICE = 0.15
MOMENT_REL_NORM = 5e-2


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def _jax_mesh(axes):
    spec = MeshSpec(dict(axes))
    return build_mesh(spec, jax.devices()[:spec.size()])


def _layout(kw, axes):
    """The JAX init's storage order of the stacked layers on this mesh."""
    pp, v = axes.get("pipe", 1), kw.get("virtual_stages", 1)
    if kw.get("pipeline_schedule") == "1f1b-interleaved" and v > 1 and pp > 1:
        return jax_pipeline.interleaved_layout(kw["n_layers"], pp, v)
    return None


class Case:
    """One configuration: the JAX Trainer on its mesh, the port's one-device
    Trainer, the case the ranks run, and the comparison of their results."""

    def __init__(self, axes, model_kw=None, cfg=None):
        self.axes = dict(axes)
        self.kw = dict(LM, **(model_kw or {}))
        self.cfg = dict(ADAM, **(cfg or {}))
        self.layout = _layout(self.kw, self.axes)
        jmodel = jax_tf.make_model(jax_tf.TransformerConfig(**self.kw))
        self.jtrainer = JaxTrainer(jmodel, _jax_mesh(self.axes), JaxConfig(**self.cfg))
        self.jstate = self.jtrainer.init_state(jax.random.PRNGKey(0))
        self.init = params_from_jax(jax.device_get(self.jstate.params), self.layout)
        self.batches = [jmodel.synthetic_batch(np.random.default_rng(s), BATCH)
                        for s in range(STEPS)]
        self.rank_case = dict(model="lm", model_kwargs=self.kw, config=self.cfg,
                              axes=self.axes, params=self.init, batches=self.batches)

    def run_references(self):
        self.jlosses, self.jgrads = [], None
        # the init state's layouts differ from a step's outputs' (scalars and
        # moments uncommitted on one device), so each step's state is put
        # back on them: the step compiles once, not twice
        layouts = jax.tree_util.tree_map(lambda x: x.sharding, self.jstate)
        for b in self.batches:
            state, loss = self.jtrainer.train_step(self.jstate, self.jtrainer.place_batch(b))
            self.jstate = jax.tree_util.tree_map(_on_layout, state, layouts)
            self.jlosses.append(float(loss))
            if self.jgrads is None:  # optax's first moment after one step: 0.1 * g
                self.jgrads = {n: t / 0.1 for n, t in params_from_jax(
                    jax.tree_util.tree_map(np.asarray, _adam(self.jstate).mu),
                    self.layout).items()}
        self.jfinal = params_from_jax(jax.device_get(self.jstate.params), self.layout)
        one_kw = {k: v for k, v in self.kw.items()
                  if k not in ("pipeline_schedule", "virtual_stages", "microbatches")}
        one = Trainer(torch_tf.make_model(torch_tf.TransformerConfig(**one_kw)),
                      config=TrainerConfig(**{k: v for k, v in self.cfg.items()
                                              if k in ("optimizer", "learning_rate")}),
                      device="cpu")
        state = one.init_state()
        state.params.load_state_dict(self.init)
        self.names = [n for n, _ in state.params.named_parameters()]
        self.losses, self.grads = [], None
        for b in self.batches:
            state, loss = one.train_step(state, one.place_batch(b))
            self.losses.append(float(loss))
            if self.grads is None:
                self.grads = {n: p.grad.detach().clone()
                              for n, p in state.params.named_parameters()}
        self.final = {k: v.detach().clone() for k, v in state.params.state_dict().items()}

    def check(self, results):
        got = results[0]
        for r, res in enumerate(results):
            assert res["losses"] == got["losses"], (self.axes, r)
        np.testing.assert_allclose(got["losses"], self.jlosses, rtol=LOSS_RTOL_JAX,
                                   err_msg=f"{self.axes} {self.kw}")
        np.testing.assert_allclose(got["losses"], self.losses, rtol=LOSS_RTOL_ONE_DEVICE,
                                   err_msg=f"{self.axes} {self.kw}")
        assert set(got["params"]) == set(self.jfinal) == set(self.names)
        for name in self.names:
            have = got["params"][name].numpy()
            for want in (self.jfinal[name], self.final[name]):
                assert have.shape == tuple(want.shape), name
                np.testing.assert_allclose(have, want.numpy(), rtol=0, atol=PARAM_ATOL,
                                           err_msg=f"{self.axes} {name}")
        jax_bound = GRAD_REL_NORM_JAX_MOE if self.kw.get("moe_experts") else GRAD_REL_NORM_JAX
        for r, res in enumerate(results):
            grads = {self.names[i]: g for i, g in res["grads"].items()}
            assert set(grads) == set(self.names), (self.axes, r)
            for name in self.names:
                for want, bound in ((self.jgrads[name], jax_bound),
                                    (self.grads[name], GRAD_REL_NORM_ONE_DEVICE)):
                    assert grads[name].shape == want.shape, name
                    assert _rel(grads[name], want) <= bound, (self.axes, self.kw, r, name,
                                                              _rel(grads[name], want))
        for res in results:
            assert res["roundtrip"] == 0.0, self.axes


def _on_layout(x, sharding):
    """``x`` on an init state's layout: uncommitted on the default device
    where the init left it there, else on its sharding."""
    if isinstance(sharding, SingleDeviceSharding):
        return jnp.asarray(np.asarray(x))
    return jax.device_put(x, sharding)


def _adam(jstate):
    """The JAX Trainer's optax Adam state (``mu``, ``nu``)."""
    (st,) = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return st


def _spawn(tmp_path, world, cases):
    tasks = [("train", c.rank_case) for c in cases]

    def references():
        for c in cases:
            c.run_references()

    results, _ = spawn_ranks(tmp_path, world, tasks, overlap=references, script=WORKER,
                             timeout=420)
    for i, case in enumerate(cases):
        case.check([res[i] for res in results])
    return results


def test_world_2_sequence_and_tensor(tmp_path):
    """{"seq": 2} (the ring) and {"model": 2} (the TP psums)."""
    _spawn(tmp_path, 2, [Case({"seq": 2}), Case({"model": 2})])


def test_world_2_pipelines(tmp_path):
    """{"pipe": 2} under GPipe, 1F1B at M 4 (more microbatches than its
    2n - 1 stash slots) and interleaved 1F1B (v 2, M 2): each stash within
    ``stash_slots``."""
    cases = [
        Case({"pipe": 2}),
        Case({"pipe": 2}, dict(pipeline_schedule="1f1b", microbatches=4)),
        Case({"pipe": 2}, dict(pipeline_schedule="1f1b-interleaved", virtual_stages=2,
                               microbatches=2)),
    ]
    results = _spawn(tmp_path, 2, cases)
    for i, (schedule, m, v) in ((1, ("1f1b", 4, 1)), (2, ("1f1b-interleaved", 2, 2))):
        bound = torch_pipeline.stash_slots(schedule, 2, m, v)
        stashes = [res[i]["stash"]["max_stash"] for res in results]
        assert max(stashes) <= bound, (schedule, m, stashes, bound)
    # plain 1F1B's first stage holds exactly the JAX ring buffer's entries
    assert results[0][1]["stash"]["max_stash"] == min(4, 2 * 2 - 1)


def test_world_2_experts(tmp_path):
    """MoE on {"expert": 2} (tokens whole on both ranks): top-1, and top-2
    with aux 0.01."""
    _spawn(tmp_path, 2, [Case({"expert": 2}, dict(MOE)),
                         Case({"expert": 2}, dict(MOE, moe_top_k=2, moe_aux_weight=0.01))])


def test_world_2_pipelined_aux(tmp_path):
    """The MoE aux (top-2, 0.01) under 1F1B and interleaved 1F1B on
    {"pipe": 2}."""
    aux = dict(MOE, moe_top_k=2, moe_aux_weight=0.01)
    _spawn(tmp_path, 2, [
        Case({"pipe": 2}, dict(aux, pipeline_schedule="1f1b", microbatches=2)),
        Case({"pipe": 2}, dict(aux, pipeline_schedule="1f1b-interleaved",
                               virtual_stages=2, microbatches=2)),
    ])


def test_world_4_composed_meshes(tmp_path):
    """{"seq": 2, "model": 2} with remat, {"pipe": 2, "seq": 2} under 1F1B
    and {"pipe": 2, "model": 2} under GPipe."""
    _spawn(tmp_path, 4, [
        Case({"seq": 2, "model": 2}, dict(remat=True)),
        Case({"pipe": 2, "seq": 2}, dict(pipeline_schedule="1f1b", microbatches=2)),
        Case({"pipe": 2, "model": 2}),
    ])


def test_world_4_zero1_on_a_tensor_parallel_mesh(tmp_path):
    """ZeRO-1 on {"data": 2, "model": 2}: the moments gathered whole against
    JAX's, the tensor-parallel leaves left unsharded by ZeRO as JAX's
    ``_zero_specs`` leaves them, and ``data_plane()``'s bytes."""
    zero = Case({"data": 2, "model": 2}, cfg=dict(shard_opt_state=True))
    results = _spawn(tmp_path, 4, [zero])
    got = [res[0] for res in results]
    st = _adam(zero.jstate)
    names = ["embed", "pos", "lnf", "head"] + [
        f"blocks.{i}.{n}" for i in range(LM["n_layers"]) for n in torch_tf.DENSE_LEAVES]
    for key, tree in (("exp_avg", st.mu), ("exp_avg_sq", st.nu)):
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        for i, name in enumerate(names):
            have = got[0]["optimizer"]["state"][i][key]
            assert tuple(have.shape) == tuple(want[name].shape), name
            if want[name].norm() == 0:
                assert have.norm() == 0, name
            else:
                assert _rel(have, want[name]) <= MOMENT_REL_NORM, (key, name)
    for res in got:
        assert res["zero"]["blocks.0.wqkv"] is None and res["zero"]["embed"] is not None
    plane, want_plane = got[0]["data_plane"], zero.jtrainer.data_plane(zero.jstate.params)
    for key in ("grad_sync", "sharded_bytes", "replicated_bytes", "grad_bytes_per_step",
                "param_bytes_per_step", "bytes_per_step", "per_tier_bytes"):
        assert plane[key] == want_plane[key], key


def test_world_4_experts(tmp_path):
    """MoE on {"data": 2, "expert": 2} with the tokens over both axes (the
    example's layout): top-1, and top-2 with aux."""
    tokens = dict(MOE, batch_axis=("data", "expert"))
    _spawn(tmp_path, 4, [
        Case({"data": 2, "expert": 2}, tokens, dict(batch_axis=("data", "expert"))),
        Case({"data": 2, "expert": 2}, dict(tokens, moe_top_k=2, moe_aux_weight=0.01),
             dict(batch_axis=("data", "expert"))),
    ])


def test_world_4_export_and_checkpoint(tmp_path):
    """The LM on {"pipe": 2, "model": 2} exported by the ranks loads in the
    JAX package with the ranks' params bit for bit, and a checkpoint
    restores the whole state bit for bit."""
    from edl_tpu import models as jax_models
    from edl_tpu.runtime import export as jax_export
    from edl_tpu.runtime.export import _serving_mesh

    model = torch_tf.make_model(torch_tf.TransformerConfig(**LM))
    job = dict(model="lm", model_kwargs=LM, config=ADAM, axes={"pipe": 2, "model": 2},
               params=model.build(device="cpu").state_dict(),
               batches=[model.synthetic_batch(np.random.default_rng(s), BATCH)
                        for s in range(2)],
               export_dir=str(tmp_path / "export"), ckpt_dir=str(tmp_path / "ckpt"))
    results = spawn_ranks(tmp_path, 4, [("export_checkpoint", job)], script=WORKER,
                          timeout=420)
    saved = results[0][0]["saved"]
    for res in results:
        for name, t in res[0]["saved"]["module"].items():
            assert torch.equal(t, res[0]["restored"]["module"][name]), name
        for i, per in res[0]["saved"]["optimizer"]["state"].items():
            for k, t in per.items():
                assert torch.equal(t, res[0]["restored"]["optimizer"]["state"][i][k])
    config = jax_models.resolve("transformer", LM)
    art = jax_export.load_inference_model(str(tmp_path / "export"),
                                          mesh=_serving_mesh(config))
    blocks = jax.device_get(art.params)["blocks"]
    for name, t in saved["module"].items():
        if name.startswith("blocks."):
            _, i, leaf = name.split(".")
            np.testing.assert_array_equal(np.asarray(blocks[leaf][int(i)]), t.numpy())


def test_lm_example_trains_on_model_parallel_axes(tmp_path):
    """``python -m edl_tpu_torch.examples.lm.train --axes ...`` standalone:
    one process a rank (here two, on the CPU over gloo), the interleaved
    pipeline over ``{"pipe": 2}``; it prints the metrics of the whole
    queue's steps, with a finite loss."""
    import json
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "edl_tpu_torch.examples.lm.train", "--device", "cpu",
         "--axes", '{"pipe": 2}', "--pipeline-schedule", "1f1b-interleaved",
         "--virtual-stages", "2", "--microbatches", "2", "--vocab-size", "64",
         "--d-model", "32", "--n-layers", "4", "--n-heads", "4", "--d-ff", "64",
         "--seq-len", "32", "--batch-size", "4", "--batches-per-shard", "2",
         "--shards", "2", "--num-passes", "1", "--dist-backend", "auto"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    metrics = json.loads(out.stdout.strip().splitlines()[-1])
    assert metrics["steps"] == 4 and metrics["world"] == 2
    assert np.isfinite(metrics["final_loss"])


GRID = [(L, n, v, m) for L in (4, 8, 12) for n in (1, 2, 3, 4) for v in (1, 2, 3)
        for m in (1, 2, 4, 6, 8) if L % (n * v) == 0]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "1f1b-interleaved"])
def test_schedule_arithmetic_matches_jax(schedule):
    """``bubble_fraction``, ``stash_slots`` and ``interleaved_layout`` equal
    the JAX package's over a grid of (L, n, v, M), errors included."""
    for L, n, v, m in GRID:
        for fn in ("bubble_fraction", "stash_slots"):
            try:
                want = getattr(jax_pipeline, fn)(schedule, n, m, v)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    getattr(torch_pipeline, fn)(schedule, n, m, v)
                continue
            assert getattr(torch_pipeline, fn)(schedule, n, m, v) == want, (fn, L, n, v, m)
        np.testing.assert_array_equal(torch_pipeline.interleaved_layout(L, n, v),
                                      jax_pipeline.interleaved_layout(L, n, v))


@pytest.mark.parametrize("kw,axes", [
    (dict(n_heads=6), {"model": 4}),
    (dict(d_ff=130), {"model": 4}),
    (dict(seq_len=130), {"seq": 4}),
    (dict(n_layers=3), {"pipe": 2}),
    (dict(pipeline_schedule="zigzag"), {"pipe": 2}),
    (dict(virtual_stages=0), {"pipe": 2}),
    (dict(virtual_stages=2), {"pipe": 2}),
    (dict(pipeline_schedule="1f1b-interleaved", virtual_stages=3), {"pipe": 2}),
    (dict(pipeline_schedule="1f1b-interleaved", virtual_stages=2, microbatches=3),
     {"pipe": 2}),
    (dict(moe_experts=3), {"expert": 2}),
    (dict(moe_experts=4, moe_top_k=5), {"expert": 2}),
], ids=["heads_tp", "dff_tp", "seq_sp", "layers_pp", "schedule", "v0", "v_not_interleaved",
        "layers_pp_v", "microbatches_pp", "experts_ep", "top_k"])
def test_validation_errors_match_jax(kw, axes):
    """The port's config validation raises JAX's ``_init`` errors, with the
    same messages, for the same mesh shape."""
    cfg = dict(LM, **kw)
    with pytest.raises(ValueError) as want:
        jax_tf.make_model(jax_tf.TransformerConfig(**cfg)).init(
            jax.random.PRNGKey(0), _jax_mesh(axes))
    with pytest.raises(ValueError) as got:
        torch_tf._check(torch_tf.TransformerConfig(**cfg), axes)
    assert str(got.value) == str(want.value)
