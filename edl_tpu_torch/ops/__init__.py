"""Hand-written Hopper kernels for the port's hot ops, with plain versions.

`flash_attention` is the port of the reference's Pallas flash-attention
kernels: CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use by
`_build` and called through ``ctypes``.
"""

from edl_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["flash_attention"]
