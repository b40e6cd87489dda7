"""The port's Trainer against the JAX package's, on the CPU.

Two kinds of check:

- the optimizers and ``clip_by_global_norm`` on the same f32 params and
  gradients as optax: exact formulas, to 1e-6 (adagrad, 5 steps with a
  leaf whose gradient is always 0: measured within 3 f32 ulps, 9e-8);
- the transformer trained 3 steps by each Trainer from the same weights
  (carried across by `params_from_jax`) and batch, on a one-device mesh on
  the JAX side: losses to rel 1e-3 (measured ~3e-5). The same for each
  one-device option (``wire_transport``, ``grad_accum_microbatches``,
  ``pipeline_depth``), ``flash=False`` on both sides.
- gradient accumulation with N = 4 against the JAX Trainer with N = 4
  (the small LM, ``flash=False``, and CTR at sparse dim 1000 with wire
  transport): 3 steps, losses to rel 1e-3 and each leaf's total update to a
  relative norm error of 5e-2, the CTR parity bounds of
  `tests/test_torch_ctr.py` (bf16 matmuls round in their own places on each
  side). Within the port, the accumulated gradient is exactly the f32 sum
  of the microbatch gradients from zero, in order, over N (tolerance 0).
- the whole slice: shards written by the JAX package, leased through each
  package's `InProcessCoordinator` by ``LeaseReader(prefetch=True)`` over
  ``FileShardSource(shuffle_seed=1)``, trained by each Trainer with wire
  transport and ``pipeline_depth=2`` from the same weights: losses to rel
  1e-3, and the same shards completed in the same order. Params after SGD with
  momentum and clipping: the update's relative norm error per leaf to 5e-2
  (measured ~1.1e-2, the bf16 gradients' own disagreement). Params after
  Adam: to 2 * steps * lr absolute, because Adam scales every gradient to
  about +-lr, so a leaf whose gradient is rounding noise on both sides (the
  key bias: softmax does not depend on it) can step the other way each time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from edl_tpu.coordinator import InProcessCoordinator as JaxCoordinator
from edl_tpu.models import ctr as jax_ctr
from edl_tpu.models import transformer as jax_tf
from edl_tpu.runtime import data as jax_data
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu.runtime.train_loop import _make_optimizer as jax_optimizer
from edl_tpu_torch.coordinator import InProcessCoordinator
from edl_tpu_torch.models import ctr as torch_ctr
from edl_tpu_torch.models import transformer as torch_tf
from edl_tpu_torch.models.convert import params_from_jax, tree_params_from_jax
from edl_tpu_torch.runtime import Trainer, TrainerConfig
from edl_tpu_torch.runtime import data
from edl_tpu_torch.runtime.train_loop import (OptaxAdagrad, _make_optimizer,
                                              clip_by_global_norm, split_microbatches)

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, d_ff=64, seq_len=16)
STEPS = 3
OPTIMIZERS = {
    "adam": dict(optimizer="adam", learning_rate=1e-3),
    "sgd_momentum_clip": dict(optimizer="sgd", learning_rate=0.1, momentum=0.9,
                              grad_clip_norm=0.5),
}


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam", learning_rate=1e-2),
    dict(optimizer="sgd", learning_rate=0.1),
    dict(optimizer="sgd", learning_rate=0.1, momentum=0.9),
    dict(optimizer="adam", learning_rate=1e-2, grad_clip_norm=1.0),
    dict(optimizer="sgd", learning_rate=0.1, momentum=0.9, grad_clip_norm=0.5),
], ids=["adam", "sgd", "sgd_momentum", "adam_clip", "sgd_momentum_clip"])
def test_optimizer_and_clip_match_optax(kw):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(STEPS)]

    opt = jax_optimizer(JaxConfig(**kw))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)

    cfg = TrainerConfig(**kw)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    topt = _make_optimizer(cfg, tp)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        if cfg.grad_clip_norm > 0:
            clip_by_global_norm([p.grad for p in tp], cfg.grad_clip_norm)
        topt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["adagrad", "adagrad_clip"])
def test_adagrad_matches_optax_with_a_zero_gradient_leaf(clip):
    """optax.adagrad (accumulator from 0.1, rsqrt(acc + 1e-7)), clipping
    first as optax.chain does; a leaf whose gradient is 0 keeps its value
    and its accumulator stays at 0.1."""
    steps, shapes = 5, [(4, 3), (5,), (2, 2)]
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes[:2]]
             + [np.zeros(shapes[2], np.float32)] for _ in range(steps)]
    kw = dict(optimizer="adagrad", learning_rate=0.05, grad_clip_norm=clip)

    opt = jax_optimizer(JaxConfig(**kw))
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)

    cfg = TrainerConfig(**kw)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    topt = _make_optimizer(cfg, tp)
    assert isinstance(topt, OptaxAdagrad)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        if cfg.grad_clip_norm > 0:
            clip_by_global_norm([p.grad for p in tp], cfg.grad_clip_norm)
        topt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert torch.equal(tp[2].detach(), torch.from_numpy(params[2]))
    assert torch.equal(topt.state[tp[2]]["sum_of_squares"], torch.full(shapes[2], 0.1))


def test_clip_passes_gradients_under_the_norm_unchanged():
    g = [torch.tensor([0.3, -0.4])]
    norm = clip_by_global_norm(g, 1.0)
    assert norm.item() == pytest.approx(0.5)
    assert torch.equal(g[0], torch.tensor([0.3, -0.4]))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_trainer_matches_jax_trainer(name):
    kw = OPTIMIZERS[name]
    batch = jax_tf.synthetic_batch(jax_tf.TransformerConfig(**CFG),
                                   np.random.default_rng(0), 4)

    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    jtrainer = JaxTrainer(jax_tf.make_model(jax_tf.TransformerConfig(**CFG)), mesh,
                          JaxConfig(**kw))
    jstate = jtrainer.init_state()
    init = params_from_jax(jax.device_get(jstate.params))
    jlosses = []
    jstate, jmetrics = jtrainer.run(jstate, [batch] * STEPS,
                                    on_step=lambda n, loss: jlosses.append(loss))
    jfinal = params_from_jax(jax.device_get(jstate.params))

    trainer = Trainer(torch_tf.make_model(torch_tf.TransformerConfig(**CFG)),
                      device="cpu", config=TrainerConfig(**kw))
    state = trainer.init_state()
    state.params.load_state_dict(init)
    losses = []
    state, metrics = trainer.run(state, [batch] * STEPS,
                                 on_step=lambda n, loss: losses.append(loss))

    assert set(metrics) == set(jmetrics)
    assert metrics["steps"] == STEPS and state.step == STEPS
    assert metrics["retraces"] == 0 and metrics["grad_bytes_per_step"] == 0
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert metrics["final_loss"] == pytest.approx(losses[-1])
    for leaf, p in state.params.named_parameters():
        got, want = p.detach(), jfinal[leaf]
        if kw["optimizer"] == "adam":
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=2 * STEPS * kw["learning_rate"],
                                       err_msg=leaf)
        else:
            step_j, step_t = want - init[leaf], got - init[leaf]
            err = ((step_t - step_j).norm() / step_j.norm()).item()
            assert err <= 5e-2, (leaf, err)


@pytest.mark.parametrize("override,error", [
    (dict(shard_opt_state=True), NotImplementedError),
    (dict(grad_sync="reduce_scatter"), NotImplementedError),
    (dict(grad_sync="ring"), ValueError),
    (dict(grad_accum_microbatches=0), ValueError),
])
def test_options_outside_the_slice_raise(override, error):
    model = torch_tf.make_model(torch_tf.TransformerConfig(**CFG))
    with pytest.raises(error):
        Trainer(model, device="cpu", config=TrainerConfig(**override))


@pytest.mark.parametrize("optimizer,error", [("adamw", ValueError),
                                             ("lamb", ValueError)])
def test_unported_optimizers_raise(optimizer, error):
    trainer = Trainer(torch_tf.make_model(torch_tf.TransformerConfig(**CFG)),
                      device="cpu", config=TrainerConfig(optimizer=optimizer))
    with pytest.raises(error):
        trainer.init_state()


# -- the one-device options --------------------------------------------------------

NOFLASH = dict(CFG, flash=False)
CTR_SPARSE = 1000
UPDATE_REL_NORM = 5e-2


def _mesh():
    return build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def _both(jmodel, tmodel, batches, convert, **kw):
    """Each Trainer from the same weights over ``batches``: (JAX losses,
    port losses, initial params, JAX final params, port final state)."""
    jtrainer = JaxTrainer(jmodel, _mesh(), JaxConfig(**kw))
    jstate = jtrainer.init_state()
    init = convert(jax.device_get(jstate.params))
    jlosses = []
    jstate, _ = jtrainer.run(jstate, iter(batches), on_step=lambda n, l: jlosses.append(l))
    trainer = Trainer(tmodel, device="cpu", config=TrainerConfig(**kw))
    state = trainer.init_state()
    state.params.load_state_dict(init)
    losses = []
    state, metrics = trainer.run(state, iter(batches), on_step=lambda n, l: losses.append(l))
    assert metrics["steps"] == len(batches)
    return jlosses, losses, init, convert(jax.device_get(jstate.params)), state


@pytest.mark.parametrize("override", [
    dict(wire_transport=True), dict(grad_accum_microbatches=2), dict(pipeline_depth=1)],
    ids=["wire_transport", "grad_accum_2", "pipeline_depth_1"])
def test_one_device_options_match_the_jax_trainer(override):
    """The options that raised until this slice now run, and agree with
    the JAX Trainer under the same option."""
    rng = np.random.default_rng(0)
    batches = [jax_tf.synthetic_batch(jax_tf.TransformerConfig(**NOFLASH), rng, 4)
               for _ in range(STEPS)]
    jlosses, losses, *_ = _both(
        jax_tf.make_model(jax_tf.TransformerConfig(**NOFLASH)),
        torch_tf.make_model(torch_tf.TransformerConfig(**NOFLASH)), batches,
        params_from_jax, optimizer="adam", learning_rate=1e-3, **override)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)


@pytest.mark.parametrize("name", ["lm", "ctr_wire"])
def test_grad_accum_4_matches_the_jax_trainer_with_4(name):
    rng = np.random.default_rng(1)
    if name == "lm":
        jm = jax_tf.make_model(jax_tf.TransformerConfig(**NOFLASH))
        tm = torch_tf.make_model(torch_tf.TransformerConfig(**NOFLASH))
        batches = [jax_tf.synthetic_batch(jax_tf.TransformerConfig(**NOFLASH), rng, 8)
                   for _ in range(STEPS)]
        convert, kw = params_from_jax, dict(optimizer="adam", learning_rate=1e-3)
    else:
        jm, tm = (jax_ctr.make_model(sparse_dim=CTR_SPARSE),
                  torch_ctr.make_model(sparse_dim=CTR_SPARSE))
        batches = [jm.synthetic_batch(rng, 64) for _ in range(STEPS)]
        convert = tree_params_from_jax
        kw = dict(optimizer="adagrad", learning_rate=0.05, wire_transport=True)
    jlosses, losses, init, jfinal, state = _both(jm, tm, batches, convert,
                                                 grad_accum_microbatches=4, **kw)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for leaf, p in state.params.named_parameters():
        step_t, step_j = p.detach() - init[leaf], jfinal[leaf] - init[leaf]
        if kw["optimizer"] == "adam":  # Adam scales every update to ~lr
            np.testing.assert_allclose(p.detach().numpy(), jfinal[leaf].numpy(), rtol=0,
                                       atol=2 * STEPS * kw["learning_rate"], err_msg=leaf)
        else:
            assert _rel(step_t, step_j) <= UPDATE_REL_NORM, (leaf, _rel(step_t, step_j))


@pytest.mark.parametrize("n", [3, 4])
def test_grad_accum_sums_microbatch_gradients_in_f32_then_divides_once(n):
    """Exactly the reference's arithmetic: the f32 sum from zero in
    microbatch order, divided by N once (N = 3 tells that apart from
    scaling each microbatch's loss by 1/N; N = 4 cannot, as a power of 2)."""
    model = torch_ctr.make_model(sparse_dim=CTR_SPARSE)
    batch = model.synthetic_batch(np.random.default_rng(2), 48)
    trainer = Trainer(model, device="cpu", config=TrainerConfig(
        optimizer="sgd", learning_rate=0.0, grad_accum_microbatches=n))
    state = trainer.init_state()
    placed = trainer.place_batch(batch)
    want, losses = None, []
    for mb in split_microbatches(placed, n):
        state.params.zero_grad(set_to_none=True)
        loss = state.params(mb)
        loss.backward()
        losses.append(loss.detach())
        grads = [p.grad.clone() for p in state.params.parameters()]
        want = grads if want is None else [a + g for a, g in zip(want, grads)]
    state, loss = trainer.train_step(state, placed)
    assert torch.equal(loss, torch.stack(losses).mean())
    for p, w in zip(state.params.parameters(), want):
        assert torch.equal(p.grad, w / np.float32(n))
    with pytest.raises(ValueError, match="divide"):
        split_microbatches({k: v[:47] for k, v in placed.items()}, n)


def test_the_slice_on_the_cpu_matches_the_jax_trainer(tmp_path):
    """JAX shards through leases, prefetch, wire and pipelining, both ways."""
    rng = np.random.default_rng(4)
    shards = jax_data.shard_names("train", 4)
    for name in shards:
        jax_data.write_shard(str(tmp_path), name,
                             jax_ctr.synthetic_batch(rng, 48, CTR_SPARSE))
    kw = dict(optimizer="adagrad", learning_rate=0.05, wire_transport=True,
              pipeline_depth=2)

    def lease(mod, coordinator):
        coord = coordinator(task_lease_sec=30.0)
        client = coord.client("trainer-0")
        client.register()
        client.add_tasks(shards)
        reader = mod.LeaseReader(client, mod.FileShardSource(str(tmp_path), 32,
                                                             shuffle_seed=1), prefetch=True)
        return reader, client

    jreader, jclient = lease(jax_data, JaxCoordinator)
    reader, client = lease(data, InProcessCoordinator)
    jtrainer = JaxTrainer(jax_ctr.make_model(sparse_dim=CTR_SPARSE), _mesh(), JaxConfig(**kw))
    jstate = jtrainer.init_state()
    init = tree_params_from_jax(jax.device_get(jstate.params))
    jlosses = []
    jtrainer.run(jstate, iter(jreader), on_step=lambda n, l: jlosses.append(l))
    trainer = Trainer(torch_ctr.make_model(sparse_dim=CTR_SPARSE), device="cpu",
                      config=TrainerConfig(**kw))
    state = trainer.init_state()
    state.params.load_state_dict(init)
    losses = []
    _, metrics = trainer.run(state, iter(reader), on_step=lambda n, l: losses.append(l))

    assert metrics["steps"] == len(jlosses) == 8  # 4 shards of 2 batches
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert reader.completed == jreader.completed and sorted(reader.completed) == shards
    assert reader.exhausted and jreader.exhausted
    st = client.status()
    assert (st["done"], st["leased"], st["queued"]) == (4, 0, 0)
    assert trainer._codec.to_spec() == jtrainer._codec.to_spec()
