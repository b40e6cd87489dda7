"""MNIST digit recognition, conv variant: the port of `edl_tpu.models.mnist`.

conv5x5(20) -> pool2 -> conv5x5(50) -> pool2 -> fc(500) -> fc(10), in bf16
over f32 params. Each conv block is a VALID 5x5 conv, its bias added in
bf16 after the conv (not inside it), ReLU, then a VALID 2x2 max pool. The
logits are cast to f32 before the f32 bias.

Layout: the JAX package runs NHWC with HWIO weights. Here the images
(B, 28, 28, 1) are viewed as NCHW with ``permute`` (channels-last in
memory, which cuDNN runs natively) and conv weights are kept OIHW
(`models.convert` transposes a JAX checkpoint's). Before ``fc1`` the
(B, 50, 4, 4) map is flattened in the JAX package's (h, w, c) order, so
``fc1.w`` means the same in both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model, Params, normal

IMAGE = 28
NUM_CLASSES = 10
#: the activations' dtype: the images are cast to it and every layer keeps
#: it, but for the logits, cast to f32 before the bias
COMPUTE_DTYPE = torch.bfloat16


def _conv_params(g, kh, kw, cin, cout, device) -> Params:
    return Params(w=normal(g, (cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cin)), device),
                  b=torch.zeros(cout, device=device))


def _conv_block(x: torch.Tensor, layer: Params) -> torch.Tensor:
    x = F.conv2d(x, layer.w.to(x.dtype))
    x = torch.relu(x + layer.b.to(x.dtype)[:, None, None])
    return F.max_pool2d(x, 2, 2)


class MNIST(nn.Module):
    """Params ``conv1.w`` (20, 1, 5, 5), ``conv2.w`` (50, 20, 5, 5),
    ``fc1.w`` (800, 500), ``fc2.w`` (500, 10), each with its ``.b``; calling
    it on ``{"image", "label"}`` returns the mean cross-entropy."""

    def __init__(self, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.conv1 = _conv_params(g, 5, 5, 1, 20, device)
        self.conv2 = _conv_params(g, 5, 5, 20, 50, device)
        self.fc1 = Params(w=normal(g, (4 * 4 * 50, 500), math.sqrt(2.0 / (4 * 4 * 50)), device),
                          b=torch.zeros(500, device=device))
        self.fc2 = Params(w=normal(g, (500, NUM_CLASSES), 0.01, device),
                          b=torch.zeros(NUM_CLASSES, device=device))

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """images (B, 28, 28, 1) f32 -> logits (B, 10) f32."""
        return apply(self, batch["image"])

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return F.cross_entropy(self.predict(batch), batch["label"].long())


def apply(m: MNIST, images: torch.Tensor) -> torch.Tensor:
    """images (B, 28, 28, 1) f32 -> logits (B, 10) f32."""
    x = images.to(COMPUTE_DTYPE).permute(0, 3, 1, 2)  # NCHW view, channels last
    x = _conv_block(x, m.conv1)  # -> (B, 20, 12, 12)
    x = _conv_block(x, m.conv2)  # -> (B, 50, 4, 4)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # the JAX (h, w, c) order
    x = torch.relu(x @ m.fc1.w.to(x.dtype) + m.fc1.b.to(x.dtype))
    return (x @ m.fc2.w.to(x.dtype)).float() + m.fc2.b


def accuracy(module: MNIST, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return (apply(module, batch["image"]).argmax(-1) == batch["label"]).float().mean()


def synthetic_batch(rng: np.random.Generator, batch_size: int) -> dict:
    """Digit-shaped blobs: class k lights up a distinct quadrant pattern, so a
    real decision boundary exists and test-time accuracy is meaningful."""
    label = rng.integers(0, NUM_CLASSES, size=batch_size).astype(np.int32)
    image = rng.standard_normal((batch_size, IMAGE, IMAGE, 1)).astype(np.float32) * 0.1
    for k in range(NUM_CLASSES):
        rows = label == k
        r, c = divmod(k, 4)
        image[rows, 7 * r : 7 * r + 7, 7 * c : 7 * c + 7, :] += 1.0
    return {"image": image, "label": label}


#: MFU numerator per image: conv1 (24^2 out, 5x5x1 -> 20) + conv2 (8^2 out,
#: 5x5x20 -> 50) + fc 800 -> 500 -> 10, at 2 FLOPs per MAC
_FWD_FLOPS = (
    2 * 24 * 24 * 5 * 5 * 1 * 20
    + 2 * 8 * 8 * 5 * 5 * 20 * 50
    + 2 * 800 * 500
    + 2 * 500 * 10
)

MODEL = Model(
    name="mnist",
    build=lambda device=None, generator=None: MNIST(device=device, generator=generator),
    synthetic_batch=synthetic_batch,
    label_keys=("label",),
    predict=lambda module, batch: module.predict(batch),
    flops_per_step=lambda bs: 3.0 * _FWD_FLOPS * bs,
)
