"""The port's ResNet against the JAX package's, on the CPU.

Cases: `TINY` (depth 50, width 8, 10 classes) and depth 18 at the same
widths, at image sizes 32 and 36. At 36 the stride-2 layers see odd inputs
(9 and 5 pixels), where XLA's SAME pads (1, 1) and not the (0, 1) of an
even input, so both branches of `_same_pads` run. JAX params are random
draws in the JAX package's tree (shaped by ``jax.eval_shape`` of its init:
its eager init compiles op by op and is slow), carried across with
`models.convert`.

In f32 (both models follow the images' dtype after their first cast, so
with the compute dtype set to f32 they run in f32), the loss, the logits
and every gradient leaf agree to 1e-4 (measured: loss within 4.3e-7,
logits within 1.4e-6, gradients within 5.3e-6).

As the models run, in bf16, a difference of one bf16 ulp anywhere (the two
GroupNorms' f32 statistics differ in their last bits, and so round to bf16
differently now and then) grows through the blocks. The JAX package shows
the size of that against itself: scaling the images by 1 + 1e-5 moves its
logits by 3.3e-2 of the largest (depth 50, size 32) and 5.3e-3 (depth 18,
size 36), and its gradient leaves by a median 11 % (depth 18, size 32).
So in bf16 the loss is held to rel 2e-2 (measured 5.3e-3 and 1.1e-3), the
logits to 1e-1 of the largest (measured 4.8e-2 and 8.9e-3) and the head's
gradients, the last product before the loss, to a relative norm
error of 1e-1 (measured 2.6e-2 and 8.9e-3); the other bf16 gradient leaves
are rounding noise at this size and are held in f32 only.
"""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from edl_tpu.models import resnet as jax_resnet
from edl_tpu_torch.models import resnet as torch_resnet
from edl_tpu_torch.models.base import Params
from edl_tpu_torch.models.convert import tree_params_from_jax
from tests.test_torch_zoo import in_f32, one_device_mesh, parity

SHAPES = [(50, 32), (50, 36), (18, 32), (18, 36)]


def _models(depth: int, size: int):
    cfg = dataclasses.replace(jax_resnet.TINY, depth=depth, image_size=size)
    return (jax_resnet.make_model(cfg),
            torch_resnet.make_model(torch_resnet.ResNetConfig(**dataclasses.asdict(cfg))))


def random_params(jm, seed: int = 0):
    """Random f32 numpy params in the JAX model's tree: conv weights at He
    scale, the head at 0.1, GroupNorm scales 1 + 0.1 N and biases 0.1 N."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jm.init(k, one_device_mesh()), jax.random.PRNGKey(0))

    def draw(path, leaf):
        shape, name = leaf.shape, str(path[-1])
        x = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 4:
            return x * np.float32(math.sqrt(2.0 / np.prod(shape[:3])))
        if len(shape) == 2:
            return x * np.float32(0.1)
        return x * np.float32(0.1) + np.float32("scale" in name)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _parity(depth, size, batch_size=2):
    jm, tm = _models(depth, size)
    batch = jm.synthetic_batch(np.random.default_rng(0), batch_size)
    return parity(jm, tm, tree_params_from_jax, random_params(jm), batch)


@pytest.mark.parametrize("depth,size", SHAPES)
def test_loss_logits_and_grads_match_jax_in_f32(depth, size, monkeypatch):
    in_f32(monkeypatch, torch_resnet)
    err = _parity(depth, size)
    assert err["loss"] <= 1e-4 and err["out"] <= 1e-4, err
    assert max(err["grads"].values()) <= 1e-4, err["grads"]


@pytest.mark.parametrize("depth,size", [(50, 32), (18, 36)])
def test_loss_logits_and_head_grads_match_jax_in_bf16(depth, size):
    err = _parity(depth, size)
    assert err["loss"] <= 2e-2 and err["out"] <= 1e-1, err
    for leaf in ("head.w", "head.b"):
        assert err["grads"][leaf] <= 1e-1, (leaf, err["grads"][leaf])


@pytest.mark.parametrize("size,k,stride", [(224, 7, 2), (112, 3, 2), (56, 3, 2),
                                           (9, 3, 2), (5, 3, 2), (56, 3, 1),
                                           (56, 1, 2), (7, 1, 1)])
def test_same_pads_are_xla_s(size, k, stride):
    (want,) = lax.padtype_to_pads((size,), (k,), (stride,), "SAME")
    assert torch_resnet._same_pads(size, k, stride) == tuple(want)


def test_stem_and_stride_two_pads_are_asymmetric_at_224():
    assert torch_resnet._same_pads(224, 7, 2) == (2, 3)
    assert torch_resnet._same_pads(56, 3, 2) == (0, 1)


def test_group_norm_matches_jax_on_nhwc_input():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 5, 24)).astype(np.float32) * 3 + 1
    scale, bias = (rng.standard_normal(24).astype(np.float32) for _ in range(2))
    for groups in (4, 32, 5):  # 32 > 24 channels and 5 does not divide: 24 and 4 groups
        want = jax_resnet._gn(x, {"scale": scale, "bias": bias}, groups)
        got = torch_resnet._gn(torch.from_numpy(x).permute(0, 3, 1, 2),
                               Params(scale=torch.from_numpy(scale),
                                      bias=torch.from_numpy(bias)), groups)
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
        assert torch_resnet._group_count(groups, 24) == jax_resnet._group_count(groups, 24)


def test_max_pool_pads_with_minus_infinity():
    x = -torch.ones((1, 1, 4, 4))  # every value below the zero a zero pad would add
    assert torch.equal(torch_resnet._max_pool_same(x), -torch.ones((1, 1, 2, 2)))
    assert F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 3, 2).max() == 0  # the pitfall


def test_accounting_configs_and_batches_match_jax():
    assert torch_resnet.MODEL.name == jax_resnet.MODEL.name == "resnet50"
    assert dataclasses.asdict(torch_resnet.TINY) == dataclasses.asdict(jax_resnet.TINY)
    assert torch_resnet._STAGES == jax_resnet._STAGES
    for depth in (18, 34, 50, 101):
        for size in (32, 36, 224):
            kw = dict(depth=depth, image_size=size)
            assert (torch_resnet._flops_fwd_per_image(torch_resnet.ResNetConfig(**kw))
                    == jax_resnet._flops_fwd_per_image(jax_resnet.ResNetConfig(**kw)))
    assert torch_resnet.MODEL.flops_per_step(64) == jax_resnet.MODEL.flops_per_step(64)
    jm, tm = _models(18, 36)
    assert tm.name == jm.name == "resnet18"
    got = tm.synthetic_batch(np.random.default_rng(1), 3)
    want = jm.synthetic_batch(np.random.default_rng(1), 3)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_accuracy_and_forward():
    tm = torch_resnet.make_model(torch_resnet.TINY)
    module = tm.build(device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in tm.synthetic_batch(
        np.random.default_rng(0), 4).items()}
    logits = torch_resnet.forward(module, batch["image"])
    assert logits.shape == (4, 10) and logits.dtype == torch.float32
    acc = torch_resnet.accuracy(module, batch)
    assert acc.item() == (logits.argmax(-1) == batch["label"]).float().mean().item()
