"""fit_a_line, linear regression: the port of `edl_tpu.models.fit_a_line`.

13 housing-like features, synthetic targets ``y = x @ w* + b* + noise`` from
a fixed hidden ``w*``; all f32, mean squared error.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model, normal

NUM_FEATURES = 13

_TRUE_W = np.linspace(-1.0, 1.0, NUM_FEATURES).astype(np.float32)
_TRUE_B = 0.5


class FitALine(nn.Module):
    """Params ``w`` (13, 1) and ``b`` (1,); calling it on ``{"x", "y"}``
    returns the mean squared error."""

    def __init__(self, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.w = nn.Parameter(normal(g, (NUM_FEATURES, 1), 0.01, device))
        self.b = nn.Parameter(torch.zeros(1, device=device))

    def predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, 13) features -> (B, 1) predicted price (serving entrypoint)."""
        return batch["x"] @ self.w + self.b

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.mean((self.predict(batch) - batch["y"]) ** 2)


def synthetic_batch(rng: np.random.Generator, batch_size: int) -> dict:
    x = rng.standard_normal((batch_size, NUM_FEATURES), dtype=np.float32)
    noise = 0.01 * rng.standard_normal((batch_size, 1), dtype=np.float32)
    y = x @ _TRUE_W[:, None] + _TRUE_B + noise
    return {"x": x, "y": y.astype(np.float32)}


MODEL = Model(
    name="fit_a_line",
    build=lambda device=None, generator=None: FitALine(device=device, generator=generator),
    synthetic_batch=synthetic_batch,
    label_keys=("y",),
    predict=lambda module, batch: module.predict(batch),
    # MFU numerator (models.base convention): one (B, 13) @ (13, 1) matmul
    flops_per_step=lambda bs: 3.0 * 2 * NUM_FEATURES * bs,
)
