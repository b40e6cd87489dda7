"""The port's transformer LM against the JAX package's, on the CPU.

JAX params are made by the JAX package on a one-device mesh and carried
across with `params_from_jax`; batches are made with numpy from a seed. Both
sides run bf16 matmuls over f32 params, each rounding its bf16 activations
and cotangents at its own places, so the loss agrees to rel 2e-2 (measured
~2e-5) and each gradient leaf to a relative norm error of 5e-2 (measured
~1.4e-2: a few bf16 ulps). The f32 pieces (RMSNorm, tanh GELU, the dense
attention oracle) agree to 1e-6 / 2e-5.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu.models import transformer as jax_tf
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu.parallel.ring_attention import dense_attention as jax_dense
from edl_tpu_torch import models as torch_models
from edl_tpu_torch.models import transformer as torch_tf
from edl_tpu_torch.models.convert import BLOCK_PARAMS, params_from_jax
from edl_tpu_torch.parallel.ring_attention import _ring_attention_local, dense_attention

CFG = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=8, d_ff=64, seq_len=16)
LOSS_RTOL = 2e-2
GRAD_REL_NORM = 5e-2


def jax_setup(flash: bool, seed: int = 0, remat: bool = False):
    """(JAX model, its params on a one-device mesh, the mesh)."""
    mesh = build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])
    model = jax_tf.make_model(jax_tf.TransformerConfig(flash=flash, remat=remat, **CFG))
    return model, model.init(jax.random.PRNGKey(seed), mesh), mesh


def jax_placed(model, mesh, batch):
    return {k: jax.device_put(jnp.asarray(v), jax.sharding.NamedSharding(
        mesh, model.batch_spec(mesh)[k])) for k, v in batch.items()}


def torch_module(flash: bool, params, remat: bool = False) -> torch_tf.TransformerLM:
    module = torch_tf.TransformerLM(
        torch_tf.TransformerConfig(flash=flash, remat=remat, **CFG), device="cpu")
    module.load_state_dict(params_from_jax(jax.device_get(params)))
    return module


@pytest.mark.parametrize("flash", [True, False])
def test_loss_and_grads_match_jax(flash, remat=False):
    jm, params, mesh = jax_setup(flash, remat=remat)
    batch = jm.synthetic_batch(np.random.default_rng(0), 4)
    step = jax.jit(jax.value_and_grad(lambda p, b: jm.loss_fn(p, b, mesh)))
    jl, jg = step(params, jax_placed(jm, mesh, batch))

    module = torch_module(flash, params, remat=remat)
    loss = module({k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert loss.dtype == torch.float32
    assert loss.item() == pytest.approx(float(jl), rel=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jg))
    for name, p in module.named_parameters():
        err = ((p.grad - want[name]).norm() / want[name].norm()).item()
        assert err <= GRAD_REL_NORM, (name, err)


def test_remat_loss_and_grads_match_the_jax_remat_model():
    test_loss_and_grads_match_jax(flash=True, remat=True)


@pytest.mark.parametrize("flash", [True, False])
def test_remat_gives_the_same_loss_and_grads_and_reruns_attention(flash, monkeypatch):
    fa = importlib.import_module("edl_tpu_torch.ops.flash_attention")
    calls = []
    plain_fwd = fa._fwd_reference
    monkeypatch.setattr(fa, "_fwd_reference",
                        lambda *a, **kw: calls.append(1) or plain_fwd(*a, **kw))
    _, params, _ = jax_setup(flash=True, seed=2)
    batch = {k: torch.from_numpy(v) for k, v in torch_tf.synthetic_batch(
        torch_tf.TransformerConfig(**CFG), np.random.default_rng(1), 4).items()}
    results = {}
    for remat in (False, True):
        calls.clear()
        module = torch_module(flash, params, remat=remat)
        loss = module(batch)
        loss.backward()
        results[remat] = (loss.detach(), {n: p.grad for n, p in module.named_parameters()},
                          len(calls))
    (l0, g0, n0), (l1, g1, n1) = results[False], results[True]
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    if flash:  # the attention forward runs once a block, and again under remat
        assert (n0, n1) == (CFG["n_layers"], 2 * CFG["n_layers"])


def test_rmsnorm_and_gelu_match_jax_in_f32():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        torch_tf._rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(jax_tf._rmsnorm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(torch_tf._gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_attention_matches_jax(causal):
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((2, 24, 2, 8)).astype(np.float32) for _ in range(3))
    got = dense_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = jax_dense(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_ring_over_several_shards_raises():
    q = torch.zeros((1, 8, 1, 8))
    with pytest.raises(NotImplementedError):
        _ring_attention_local(q, q, q, n_shards=2, flash=True)


def test_accounting_and_batches_match_jax():
    jcfg = jax_tf.TransformerConfig(**CFG)
    tcfg = torch_tf.TransformerConfig(**CFG)
    assert {f.name for f in dataclasses.fields(tcfg)} == \
        {f.name for f in dataclasses.fields(jcfg)}
    assert torch_tf._flops_per_step(tcfg, 8) == jax_tf._flops_per_step(jcfg, 8)
    assert torch_tf.lm_cache_shape(tcfg) == jax_tf.lm_cache_shape(jcfg)
    assert torch_tf.lm_cache_bytes_per_token(tcfg) == jax_tf.lm_cache_bytes_per_token(jcfg)
    tb = torch_tf.synthetic_batch(tcfg, np.random.default_rng(3), 2)
    jb = jax_tf.synthetic_batch(jcfg, np.random.default_rng(3), 2)
    for key in ("tokens", "targets"):
        np.testing.assert_array_equal(tb[key], jb[key])


def test_params_from_jax_fills_every_param_with_its_shape():
    _, params, _ = jax_setup(flash=True, seed=1)
    state = params_from_jax(jax.device_get(params))
    module = torch_tf.TransformerLM(torch_tf.TransformerConfig(**CFG), device="cpu")
    assert set(state) == set(module.state_dict())
    for name, t in module.state_dict().items():
        assert state[name].shape == t.shape, name
    host = jax.device_get(params)
    np.testing.assert_array_equal(state["blocks.1.wqkv"].numpy(),
                                  np.asarray(host["blocks"]["wqkv"])[1])
    assert set(BLOCK_PARAMS) == set(host["blocks"])


@pytest.mark.parametrize("override,error", [
    (dict(moe_experts=4), NotImplementedError),
    (dict(moe_experts=2, moe_top_k=2), NotImplementedError),
    (dict(pipeline_schedule="zigzag"), ValueError),
    (dict(virtual_stages=2), ValueError),
])
def test_options_outside_the_slice_raise(override, error):
    with pytest.raises(error):
        torch_tf.make_model(torch_tf.TransformerConfig(**CFG, **override))


@pytest.mark.parametrize("axis", ["seq", "model", "pipe"])
def test_parallel_axes_above_one_raise(axis):
    with pytest.raises(NotImplementedError):
        torch_tf.TransformerLM(torch_tf.TransformerConfig(**CFG), device="cpu",
                               axes={axis: 2})


def test_zoo_get_and_resolve():
    assert torch_models.get("transformer") is torch_tf.MODEL
    model = torch_models.resolve("transformer", CFG)
    assert model.config == torch_tf.TransformerConfig(**CFG)
    with pytest.raises(KeyError):
        torch_models.get("vgg16")
