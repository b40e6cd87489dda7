"""The port's small models against the JAX package's, on the CPU, and the zoo.

JAX params are made by the JAX package on a one-device mesh and carried
across with `models.convert`; batches come from the same numpy generator.
`parity` measures the loss (relative error), the ``predict`` outputs (the
largest absolute error over the largest output) and each gradient leaf
(relative norm error). Tolerances:

- fit_a_line, all f32: 1e-5 (measured: loss 7e-8, outputs 7e-8, gradients
  8e-8).
- word2vec, bf16 matmuls over f32 params, each side rounding its bf16
  activations and cotangents at its own places: 2e-2 on the loss and
  outputs (measured 1.2e-7 and 1.2e-3) and 5e-2 on the gradients (measured
  at most 4.9e-3, the hidden bias).
- MNIST as it runs, in bf16: 2e-2 on the loss and outputs (measured: both
  equal). Its gradients are held in f32: both models run in f32 when their
  compute dtype is (the JAX package's only bf16 cast is the images', every
  later layer follows their dtype), to 1e-4 (measured: loss 2.1e-7,
  outputs 6.0e-7, gradients at most 7.7e-7). In
  bf16 the weight gradients are equal, but the JAX package adds up each
  conv bias's gradient over the batch and the map in bf16: its conv1 bias
  gradient is 4.6e-2 from the exact sum of the same bf16 cotangents, where
  the port's, summed in f32 and rounded once, is 1.9e-3 from it.

ResNet is in `test_torch_resnet.py`, the transformer in
`test_torch_transformer.py`, CTR in `test_torch_ctr.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edl_tpu import models as jax_models
from edl_tpu.parallel import MeshSpec, build_mesh
from edl_tpu_torch import models as torch_models
from edl_tpu_torch.models import mnist as torch_mnist
from edl_tpu_torch.models.convert import PARAMS_FROM_JAX

NAMES = ["fit_a_line", "mnist", "word2vec", "ctr", "resnet50", "transformer"]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).norm() / want.norm()).item()


def one_device_mesh():
    return build_mesh(MeshSpec({"data": 1}), jax.devices()[:1])


def parity(jm, tm, convert, params, batch) -> dict:
    """One forward and backward of the JAX model ``jm`` at ``params`` and of
    the port's ``tm`` at the converted params, on the same numpy ``batch``:
    {"loss": rel err, "out": max abs err / max |out|, "grads": {leaf: rel
    norm err}}."""
    mesh = one_device_mesh()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # one compile: the loss's value and gradients, and the outputs as aux
    (jl, jout), jg = jax.jit(jax.value_and_grad(
        lambda p, b: (jm.loss_fn(p, b, mesh), jm.predict(p, b, mesh)), has_aux=True))(params, jb)
    jout = np.asarray(jout)

    module = tm.build(device="cpu")
    module.load_state_dict(convert(jax.device_get(params)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = module(tb)
    loss.backward()
    assert loss.dtype == torch.float32
    out = tm.predict(module, {k: v for k, v in tb.items() if k not in tm.label_keys})
    assert out.shape == jout.shape and out.dtype == torch.float32
    want = convert(jax.device_get(jg))
    assert set(want) == {n for n, _ in module.named_parameters()}
    return {"loss": abs(loss.item() - float(jl)) / abs(float(jl)),
            "out": float(np.abs(out.detach().numpy() - jout).max() / np.abs(jout).max()),
            "grads": {n: _rel(p.grad, want[n]) for n, p in module.named_parameters()}}


def in_f32(monkeypatch, torch_module) -> None:
    """Run both sides in f32: the JAX model's bf16 cast and the port's
    compute dtype become f32 for this test."""
    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    monkeypatch.setattr(torch_module, "COMPUTE_DTYPE", torch.float32)


# (module, dtype) -> (batch, loss/output tolerance, gradient tolerance or
# None where the gradients are held in f32 instead)
CASES = {
    ("fit_a_line", "f32"): (32, 1e-5, 1e-5),
    ("word2vec", "bf16"): (32, 2e-2, 5e-2),
    ("mnist", "bf16"): (8, 2e-2, None),
    ("mnist", "f32"): (8, 1e-4, 1e-4),
}


@pytest.mark.parametrize("name,dtype", sorted(CASES), ids=lambda x: str(x))
def test_loss_grads_and_predict_match_jax(name, dtype, monkeypatch):
    batch_size, out_tol, grad_tol = CASES[name, dtype]
    if name == "mnist" and dtype == "f32":
        in_f32(monkeypatch, torch_mnist)
    jm = jax_models.resolve(name)
    params = jm.init(jax.random.PRNGKey(0), one_device_mesh())
    # non-zero biases, so their paths are checked too
    params = jax.tree_util.tree_map(lambda p: p + 0.05 if p.ndim == 1 else p, params)
    batch = jm.synthetic_batch(np.random.default_rng(0), batch_size)
    err = parity(jm, torch_models.resolve(name), PARAMS_FROM_JAX[name], params, batch)
    assert err["loss"] <= out_tol and err["out"] <= out_tol, err
    if grad_tol is not None:
        assert max(err["grads"].values()) <= grad_tol, err["grads"]


@pytest.mark.parametrize("name", ["fit_a_line", "mnist", "word2vec"])
def test_batches_and_accounting_match_jax(name):
    jm, tm = jax_models.resolve(name), torch_models.resolve(name)
    assert (tm.name, tm.label_keys) == (jm.name, jm.label_keys)
    assert tm.flops_per_step(64) == jm.flops_per_step(64)
    got = tm.synthetic_batch(np.random.default_rng(4), 16)
    want = jm.synthetic_batch(np.random.default_rng(4), 16)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_mnist_flattens_in_the_jax_order():
    """fc1 sees the (h, w, c) order of the JAX package's NHWC flatten: a
    module whose fc1 weight is 0 but for the row of (h=1, w=2, c=3) passes
    exactly that feature through."""
    module = torch_mnist.MNIST(device="cpu")
    row = (1 * 4 + 2) * 50 + 3
    with torch.no_grad():
        module.fc1.w.zero_()
        module.fc1.w[row, 0] = 1.0
        module.fc1.b.zero_()
        module.fc2.w.zero_()
        module.fc2.w[0, 0] = 1.0
        module.fc2.b.zero_()
    image = torch.from_numpy(torch_mnist.synthetic_batch(np.random.default_rng(0), 2)["image"])
    x = image.to(torch.bfloat16).permute(0, 3, 1, 2)
    feats = torch_mnist._conv_block(torch_mnist._conv_block(x, module.conv1), module.conv2)
    want = torch.relu(feats[:, 3, 1, 2]).float()
    assert torch.equal(torch_mnist.apply(module, image)[:, 0], want)


def test_registry_has_all_six_models():
    assert sorted(torch_models._REGISTRY) == sorted(NAMES)
    assert sorted(torch_models._REGISTRY) == sorted(jax_models._REGISTRY)
    assert sorted(torch_models._MODULES) == sorted(jax_models._MODULES)
    assert torch_models.get("resnet50") is torch_models.resnet.MODEL
    assert torch_models.resolve("resnet") is torch_models.resnet.MODEL
    assert torch_models.resolve("resnet", {"depth": 18}).name == "resnet18"
    with pytest.raises(TypeError):
        torch_models.resolve("mnist", {"width": 2})


@pytest.mark.parametrize("ref,config", [("vgg16", None), ("vgg", {"depth": 16})])
def test_registry_raises_for_an_unknown_model(ref, config):
    with pytest.raises(KeyError):
        torch_models.resolve(ref, config)


@pytest.mark.parametrize("name", NAMES)
def test_every_model_builds_on_the_cpu_and_raises_without_cuda(name):
    model = torch_models.get(name)
    module = model.build(device="cpu")
    assert all(p.device.type == "cpu" for p in module.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.build()


def test_mfu_fields_have_the_jax_names_and_no_peak_off_the_card(monkeypatch):
    from edl_tpu.tools import mfu as jax_mfu
    from edl_tpu_torch.tools import mfu

    model = torch_models.get("ctr")
    got = mfu.mfu_fields(model, 8192, steps_per_sec=100.0, device="cpu")
    want = jax_mfu.mfu_fields(jax_models.get("ctr"), 8192, steps_per_sec=100.0,
                              device=jax.devices("cpu")[0])
    assert set(got) == set(want)
    assert got["model_flops"] == want["model_flops"] and got["flops_method"] == "analytic"
    assert got["tflops_per_sec"] == want["tflops_per_sec"]
    assert got["mfu"] is None and got["peak_tflops"] is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert mfu.peak_tflops_per_chip("cuda:0") == 989.0
    on_card = mfu.mfu_fields(model, 8192, steps_per_sec=100.0, device="cuda:0")
    # the JAX package's rounding: MFU to 4 decimals of the unrounded rate
    assert on_card["mfu"] == round(on_card["model_flops"] * 100.0 / 1e12 / 989.0, 4)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA B200")
    assert mfu.peak_tflops_per_chip("cuda:0") is None
