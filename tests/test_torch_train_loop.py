"""The port's Trainer against the JAX package's, on the CPU.

Two kinds of check:

- the optimizers and ``clip_by_global_norm`` on the same f32 params and
  gradients as optax: exact formulas, to 1e-6 (adagrad, 5 steps with a
  leaf whose gradient is always 0: measured within 3 f32 ulps, 9e-8);
- the transformer trained 3 steps by each Trainer from the same weights
  (carried across by `params_from_jax`) and batch, on a one-device mesh on
  the JAX side: losses to rel 1e-3 (measured ~3e-5). Params after SGD with
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

from edl_tpu.models import transformer as jax_tf
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu.runtime.train_loop import _make_optimizer as jax_optimizer
from edl_tpu_torch.models import transformer as torch_tf
from edl_tpu_torch.models.convert import params_from_jax
from edl_tpu_torch.runtime import Trainer, TrainerConfig
from edl_tpu_torch.runtime.train_loop import (OptaxAdagrad, _make_optimizer,
                                              clip_by_global_norm)

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
    (dict(wire_transport=True), NotImplementedError),
    (dict(shard_opt_state=True), NotImplementedError),
    (dict(grad_sync="reduce_scatter"), NotImplementedError),
    (dict(grad_accum_microbatches=2), NotImplementedError),
    (dict(pipeline_depth=1), NotImplementedError),
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
