"""ResNet image classifiers (ResNet-18/34/50/101): the port of
`edl_tpu.models.resnet`.

As in the JAX package: bf16 convs over f32 params, GroupNorm in place of
BatchNorm (f32 statistics, population variance, eps 1e-5, the output cast
back to bf16), the residual add in f32, a global average pool and an f32
head.

Layout: the JAX package runs NHWC with HWIO weights. Here the images
(B, S, S, 3) are viewed as NCHW with ``permute`` (channels-last in memory,
which cuDNN runs natively) and conv weights are kept OIHW (`models.convert`
transposes a JAX checkpoint's). GroupNorm's groups are contiguous channel
blocks in both.

Padding: XLA's SAME pads (lo, hi) = (total // 2, total - total // 2), which
is asymmetric whenever the total is odd: the 7x7 stride-2 stem at 224 pads
(2, 3) and a 3x3 stride-2 conv on an even input (0, 1). PyTorch's
``padding=`` is symmetric, so `_same_pads` computes the pads from the input
size and an asymmetric pair goes through ``F.pad`` (-inf for the max pool).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model, Params, normal

#: the activations' dtype: the images are cast to it and every layer keeps it
#: (GroupNorm's statistics, the residual add and the head run in f32)
COMPUTE_DTYPE = torch.bfloat16

#: depth -> (blocks per stage, bottleneck expansion)
_STAGES = {
    18: ((2, 2, 2, 2), 1),
    34: ((3, 4, 6, 3), 1),
    50: ((3, 4, 6, 3), 4),
    101: ((3, 4, 23, 3), 4),
}


@dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    image_size: int = 224
    width: int = 64  # stem channels; stage c = width * 2**stage * expansion
    gn_groups: int = 32

    @property
    def stages(self) -> Tuple[int, ...]:
        return _STAGES[self.depth][0]

    @property
    def expansion(self) -> int:
        return _STAGES[self.depth][1]


def _group_count(groups: int, c: int) -> int:
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def _gn(x: torch.Tensor, p: Params, groups: int) -> torch.Tensor:
    """GroupNorm over (H, W, channel group) in f32, x (B, C, H, W)."""
    g = _group_count(groups, x.shape[1])
    y = F.group_norm(x.float(), g, p.scale, p.bias, eps=1e-5)
    return y.to(x.dtype)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding along one spatial dim: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME-padded conv; x (B, C, H, W), w (O, I, kh, kw) f32, cast to x's dtype."""
    (hlo, hhi), (wlo, whi) = (_same_pads(x.shape[2], w.shape[2], stride),
                              _same_pads(x.shape[3], w.shape[3], stride))
    w = w.to(x.dtype)
    if hlo == hhi and wlo == whi:
        return F.conv2d(x, w, stride=stride, padding=(hlo, wlo))
    return F.conv2d(F.pad(x, (wlo, whi, hlo, hhi)), w, stride=stride)


def _max_pool_same(x: torch.Tensor, k: int = 3, stride: int = 2) -> torch.Tensor:
    (hlo, hhi), (wlo, whi) = (_same_pads(x.shape[2], k, stride),
                              _same_pads(x.shape[3], k, stride))
    x = F.pad(x, (wlo, whi, hlo, hhi), value=-math.inf)
    return F.max_pool2d(x, k, stride)


def _conv_weight(g, kh, kw, cin, cout, device) -> torch.Tensor:
    return normal(g, (cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cin)), device)


def _gn_params(c: int, device) -> Params:
    return Params(scale=torch.ones(c, device=device), bias=torch.zeros(c, device=device))


class Block(nn.Module):
    """A basic block (expansion 1: conv1/gn1, conv2/gn2) or a bottleneck
    (conv1-3, gn1-3), with ``proj``/``gn_proj`` when the shape changes."""

    def __init__(self, cfg: ResNetConfig, cin: int, cmid: int, stride: int,
                 g: torch.Generator, device: torch.device):
        super().__init__()
        cout = cmid * cfg.expansion
        self.cfg, self.stride = cfg, stride
        if cfg.expansion == 1:
            convs = [(3, cin, cmid), (3, cmid, cout)]
        else:
            convs = [(1, cin, cmid), (3, cmid, cmid), (1, cmid, cout)]
        for i, (k, ci, co) in enumerate(convs, 1):
            self.register_parameter(f"conv{i}", nn.Parameter(_conv_weight(g, k, k, ci, co, device)))
            self.add_module(f"gn{i}", _gn_params(co, device))
        if stride != 1 or cin != cout:
            self.proj = nn.Parameter(_conv_weight(g, 1, 1, cin, cout, device))
            self.gn_proj = _gn_params(cout, device)
        else:
            self.proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gr, s = self.cfg.gn_groups, self.stride
        shortcut = x if self.proj is None else _gn(_conv(x, self.proj, s), self.gn_proj, gr)
        if self.cfg.expansion == 1:
            y = torch.relu(_gn(_conv(x, self.conv1, s), self.gn1, gr))
            y = _gn(_conv(y, self.conv2), self.gn2, gr)
        else:
            y = torch.relu(_gn(_conv(x, self.conv1), self.gn1, gr))
            y = torch.relu(_gn(_conv(y, self.conv2, s), self.gn2, gr))
            y = _gn(_conv(y, self.conv3), self.gn3, gr)
        # residual add in f32, as in the JAX package
        return torch.relu(y.float() + shortcut.float()).to(x.dtype)


def _strides(cfg: ResNetConfig):
    """(cmid, stride) for every block, in order."""
    for stage, blocks in enumerate(cfg.stages):
        for b in range(blocks):
            yield cfg.width * 2 ** stage, 2 if (b == 0 and stage > 0) else 1


class ResNet(nn.Module):
    """Params ``stem.conv`` (width, 3, 7, 7), ``stem.gn.{scale,bias}``,
    ``blocks.{i}.*`` and ``head.w`` (C, classes) / ``.b``; calling it on
    ``{"image", "label"}`` returns the mean cross-entropy."""

    def __init__(self, cfg: ResNetConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.stem = Params(conv=_conv_weight(g, 7, 7, 3, cfg.width, device))
        self.stem.gn = _gn_params(cfg.width, device)
        blocks, cin = [], cfg.width
        for cmid, stride in _strides(cfg):
            blocks.append(Block(cfg, cin, cmid, stride, g, device))
            cin = cmid * cfg.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = Params(w=normal(g, (cin, cfg.num_classes), 0.01, device),
                           b=torch.zeros(cfg.num_classes, device=device))

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return _apply(self, batch["image"])

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return F.cross_entropy(self.predict(batch), batch["label"].long())


def _apply(m: ResNet, images: torch.Tensor) -> torch.Tensor:
    """images (B, S, S, 3) f32 -> logits (B, num_classes) f32."""
    x = images.to(COMPUTE_DTYPE).permute(0, 3, 1, 2)  # NCHW view, channels last
    x = _conv(x, m.stem.conv, stride=2)
    x = torch.relu(_gn(x, m.stem.gn, m.cfg.gn_groups))
    x = _max_pool_same(x)
    for block in m.blocks:
        x = block(x)
    x = x.float().mean(dim=(2, 3))  # global average pool
    return x @ m.head.w + m.head.b


def _synthetic_batch(cfg: ResNetConfig, rng: np.random.Generator,
                     batch_size: int) -> dict:
    """ImageNet-shaped separable data: each class adds a distinct 2-D
    frequency pattern, so loss/accuracy trends are meaningful."""
    s = cfg.image_size
    label = rng.integers(0, cfg.num_classes, size=batch_size).astype(np.int32)
    image = rng.standard_normal((batch_size, s, s, 3)).astype(np.float32) * 0.1
    t = np.linspace(0, 2 * np.pi, s, dtype=np.float32)
    # 25 x 40 = 1000 distinct (fx, fy) pairs: every class of the ImageNet
    # config gets its own pattern
    fx = 1 + (label % 25)
    fy = 1 + ((label // 25) % 40)
    pattern = (
        np.sin(fx[:, None, None] * t[None, :, None])
        * np.cos(fy[:, None, None] * t[None, None, :])
    ).astype(np.float32)
    image += pattern[..., None] * 0.7
    return {"image": image, "label": label}


def accuracy(module: ResNet, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Top-1 accuracy; the module carries its config, where the JAX
    package's ``accuracy(model, params, batch)`` reads the model's."""
    logits = _apply(module, batch["image"])
    return (logits.argmax(-1) == batch["label"]).float().mean()


def _flops_fwd_per_image(cfg: ResNetConfig) -> float:
    """Conv/matmul forward FLOPs per image (2 per MAC), walking the same
    stage topology as the module. ResNet-50 at 224 is 8.2 GFLOPs, the
    published ~4.1 GMACs. GroupNorm, ReLU and pooling are not MAC FLOPs."""
    s = -(-cfg.image_size // 2)  # stem conv, stride 2, SAME
    fl = 2.0 * s * s * 7 * 7 * 3 * cfg.width
    s = -(-s // 2)  # 3x3/2 max pool, SAME
    cin = cfg.width
    for cmid, stride in _strides(cfg):
        cout = cmid * cfg.expansion
        s_out = -(-s // stride)
        if cfg.expansion == 1:
            fl += 2.0 * s_out * s_out * 9 * cin * cmid
            fl += 2.0 * s_out * s_out * 9 * cmid * cout
        else:
            fl += 2.0 * s * s * cin * cmid  # 1x1 (stride lives in conv2)
            fl += 2.0 * s_out * s_out * 9 * cmid * cmid
            fl += 2.0 * s_out * s_out * cmid * cout
        if stride != 1 or cin != cout:
            fl += 2.0 * s_out * s_out * cin * cout
        cin, s = cout, s_out
    return fl + 2.0 * cin * cfg.num_classes  # head


def make_model(cfg: Optional[ResNetConfig] = None, **overrides) -> Model:
    cfg = cfg or ResNetConfig(**overrides)
    return Model(
        name=f"resnet{cfg.depth}",
        build=lambda device=None, generator=None: ResNet(
            cfg, device=device, generator=generator),
        synthetic_batch=lambda rng, bs: _synthetic_batch(cfg, rng, bs),
        label_keys=("label",),
        predict=lambda module, batch: module.predict(batch),
        config=cfg,
        flops_per_step=lambda bs: 3.0 * _flops_fwd_per_image(cfg) * bs,
    )


def forward(module: ResNet, images: torch.Tensor) -> torch.Tensor:
    """Inference entrypoint: logits for (B, S, S, 3) f32 images."""
    return _apply(module, images)


#: ResNet-50 / ImageNet, the BASELINE.json configuration
MODEL = make_model()

#: small config for CPU tests: 32 px, width 8, 10 classes; still exercises
#: every block variant
TINY = ResNetConfig(depth=50, num_classes=10, image_size=32, width=8,
                    gn_groups=4)
