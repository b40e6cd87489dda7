"""The port's CTR model against the JAX package's, on the CPU.

JAX params are made by the JAX package on a one-device mesh at
``sparse_dim=1000`` (tables padded to 1024 rows) and carried across with
`tree_params_from_jax`; batches come from the same numpy generator. Both
sides run the MLP as bf16 matmuls over f32 params, each rounding its bf16
activations and cotangents at its own places, so:

- loss and each ``predict`` logit agree to rel 2e-2 (measured: loss equal,
  logits within 2e-7 of the largest);
- each gradient leaf, tables included, to a relative norm error of 5e-2
  (measured: at most 5.1e-3, a bias of the MLP);
- five adagrad steps of each Trainer, with and without clipping at 1.0:
  losses to rel 1e-3 (measured: at most 2.0e-4) and each leaf's total
  update to a relative norm error of 5e-2 (measured: at most 1.8e-2
  without clipping and 2.4e-2 with it; the bf16 roundings of each step
  feed the next).

`synthetic_batch` arrays must be exactly equal, and padded table rows
(1000-1023), whose gradient is 0, must keep their values bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import ctr as jax_ctr
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.runtime import Trainer as JaxTrainer, TrainerConfig as JaxConfig
from edl_tpu_torch.models import ctr as torch_ctr
from edl_tpu_torch.models.convert import tree_params_from_jax
from edl_tpu_torch.runtime import Trainer, TrainerConfig

SPARSE_DIM = 1000
BATCH = 64
STEPS = 5
LOSS_RTOL = 2e-2
GRAD_REL_NORM = 5e-2


def _mesh():
    return build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])


def _batch(seed: int = 0):
    return jax_ctr.synthetic_batch(np.random.default_rng(seed), BATCH, SPARSE_DIM)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def test_synthetic_batch_matches_jax():
    for sparse_dim in (SPARSE_DIM, torch_ctr.SPARSE_DIM):
        got = torch_ctr.synthetic_batch(np.random.default_rng(3), 32, sparse_dim)
        want = jax_ctr.synthetic_batch(np.random.default_rng(3), 32, sparse_dim)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_loss_grads_and_predict_match_jax():
    jm, mesh = jax_ctr.make_model(sparse_dim=SPARSE_DIM), _mesh()
    params = jm.init(jax.random.PRNGKey(0), mesh)
    # non-zero biases and wide weights, so their paths are checked too
    params = jax.tree_util.tree_map(
        lambda p: p + 0.01 if p.ndim == 1 or p.shape == (13, 1) else p, params)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(lambda p: jm.loss_fn(p, jb, mesh))(params)
    jlogits = jm.predict(params, {k: v for k, v in jb.items() if k != "label"}, mesh)

    module = torch_ctr.make_model(sparse_dim=SPARSE_DIM).build(device="cpu")
    module.load_state_dict(tree_params_from_jax(jax.device_get(params)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = module(tb)
    loss.backward()
    assert loss.dtype == torch.float32
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    logits = module.predict({k: v for k, v in tb.items() if k != "label"})
    assert logits.shape == (BATCH,)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=LOSS_RTOL * np.abs(np.asarray(jlogits)).max())
    want = tree_params_from_jax(jax.device_get(jg))
    assert set(want) == {n for n, _ in module.named_parameters()}
    for name, p in module.named_parameters():
        assert _rel(p.grad, want[name]) <= GRAD_REL_NORM, (name, _rel(p.grad, want[name]))
    # padded rows get no gradient
    assert not module.deep_table.grad[SPARSE_DIM:].any()


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["adagrad", "adagrad_clip"])
def test_trainer_matches_jax_trainer_with_adagrad(clip):
    kw = dict(optimizer="adagrad", learning_rate=0.05, grad_clip_norm=clip)
    batches = [_batch(seed) for seed in range(STEPS)]

    jtrainer = JaxTrainer(jax_ctr.make_model(sparse_dim=SPARSE_DIM), _mesh(), JaxConfig(**kw))
    jstate = jtrainer.init_state()
    init = tree_params_from_jax(jax.device_get(jstate.params))
    jlosses = []
    jstate, _ = jtrainer.run(jstate, batches, on_step=lambda n, loss: jlosses.append(loss))
    jfinal = tree_params_from_jax(jax.device_get(jstate.params))

    trainer = Trainer(torch_ctr.make_model(sparse_dim=SPARSE_DIM), device="cpu",
                      config=TrainerConfig(**kw))
    state = trainer.init_state()
    state.params.load_state_dict(init)
    losses = []
    state, metrics = trainer.run(state, batches, on_step=lambda n, loss: losses.append(loss))

    assert metrics["steps"] == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    for name, p in state.params.named_parameters():
        step_t, step_j = p.detach() - init[name], jfinal[name] - init[name]
        assert _rel(step_t, step_j) <= GRAD_REL_NORM, (name, _rel(step_t, step_j))
    for name in ("deep_table", "wide_table"):  # padded rows never change
        assert torch.equal(getattr(state.params, name)[SPARSE_DIM:].detach(),
                           init[name][SPARSE_DIM:])


def test_accounting_and_constants_match_jax():
    for name in ("NUM_DENSE", "NUM_SPARSE", "SPARSE_DIM", "EMBED_DIM", "HIDDEN", "SHARD_AXIS"):
        assert getattr(torch_ctr, name) == getattr(jax_ctr, name), name
    assert torch_ctr._flops_per_step(8192) == jax_ctr._flops_per_step(8192)
    assert torch_ctr.MODEL.flops_per_step(8192) == jax_ctr.MODEL.flops_per_step(8192)
    assert torch_ctr.MODEL.label_keys == jax_ctr.MODEL.label_keys


def test_full_width_tables_are_padded_to_1000192_rows():
    module = torch_ctr.MODEL.build(device="cpu")
    assert module.deep_table.shape == (1000192, torch_ctr.EMBED_DIM)
    assert module.wide_table.shape == (1000192, 1)
    dense = torch.zeros((2, torch_ctr.NUM_DENSE))
    ids = torch.tensor([[0] * 25 + [torch_ctr.SPARSE_DIM - 1]] * 2, dtype=torch.int32)
    assert torch_ctr.forward(module, dense, ids).shape == (2,)
