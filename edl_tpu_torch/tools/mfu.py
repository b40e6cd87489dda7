"""FLOPs and MFU accounting: the port of `edl_tpu.tools.mfu`.

Models carry an analytic ``flops_per_step`` (matmul/conv FLOPs only,
causal-halved attention, train = 3x forward, remat recompute excluded: the
standard MFU numerator). This module keys the card's dense bf16 peak on
``torch.cuda.get_device_name()`` and assembles the ``{model_flops,
flops_method, tflops_per_sec, peak_tflops, mfu}`` fields under the JAX
package's names. The JAX package falls back to XLA's cost analysis for a
model without a formula; the port has no such fallback and reports None.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from edl_tpu_torch.tools.peaks import H100_PEAK_BF16_TFLOPS

#: dense bf16 tensor-core peak TFLOP/s per card (NVIDIA data sheets, no
#: sparsity), by a substring of the device name, matched most specific first
_PEAK_BF16_TFLOPS = (
    ("H100 80GB HBM3", H100_PEAK_BF16_TFLOPS),  # H100 SXM
    ("H100 PCIe", 756.0),
    ("A100", 312.0),
)


def peak_tflops_per_chip(device: Any = None) -> Optional[float]:
    """The card's dense bf16 peak; None off a CUDA device or for a card the
    table does not know. ``device``: a ``torch.device``, a name or None
    (the current CUDA device, when there is one)."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAK_BF16_TFLOPS:
        if key in name:
            return peak
    return None


def flops_per_step(model: Any, batch_size: int) -> Tuple[Optional[float], str]:
    """(train-step FLOPs, method): the model's analytic formula, or None."""
    if model.flops_per_step is not None:
        return float(model.flops_per_step(batch_size)), "analytic"
    return None, "unavailable (no analytic formula)"


def mfu_fields(model: Any, batch_size: int, steps_per_sec: float, n_chips: int = 1,
               device: Any = None) -> Dict[str, Any]:
    """Per-step model FLOPs, achieved TFLOP/s a card over ``n_chips``
    cards, and MFU against the card's peak (None off the card), rounded as
    the JAX package rounds them."""
    flops, method = flops_per_step(model, batch_size)
    out: Dict[str, Any] = {"model_flops": flops, "flops_method": method}
    if flops is None or steps_per_sec <= 0:
        out.update(tflops_per_sec=None, mfu=None, peak_tflops=None)
        return out
    achieved = flops * steps_per_sec / max(1, n_chips) / 1e12
    peak = peak_tflops_per_chip(device)
    rounded = round(achieved, 3)
    out.update(
        # never round a positive rate down to 0: a tiny model's rate sits
        # below a milli-TFLOP, and 0.0 reads as "no compute ran"
        tflops_per_sec=rounded if rounded > 0 else achieved,
        peak_tflops=peak,
        mfu=round(achieved / peak, 4) if peak else None,
    )
    return out
