"""edl_tpu_torch — the port of edl_tpu to PyTorch and CUDA on NVIDIA Hopper.

The JAX package `edl_tpu` stays beside it as the reference; this package
imports neither JAX nor anything of `edl_tpu`, and keeps its own copy of
what it needs. It mirrors the reference's layout, so each counterpart sits
at the same path:

  models/    the model bundle and the transformer LM (`models.transformer`)
  ops/       hand-written CUDA kernels for Hopper and their plain versions
  parallel/  attention over the sequence axis (one shard for now)
  runtime/   the single-device Trainer

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no device named they raise.

Nothing is imported eagerly: ``import edl_tpu_torch`` loads no torch.
"""
