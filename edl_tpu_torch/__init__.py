"""edl_tpu_torch — the port of edl_tpu to PyTorch and CUDA on NVIDIA Hopper.

The JAX package `edl_tpu` stays beside it as the reference; this package
imports neither JAX nor anything of `edl_tpu`, and keeps its own copy of
what it needs. It mirrors the reference's layout, so each counterpart sits
at the same path:

  models/    the model bundle and the zoo: fit_a_line, mnist, word2vec, ctr,
             resnet and the transformer LM (with its serving steps)
  obs/       the metrics registry, span tracing and `/metrics` over HTTP
  ops/       hand-written CUDA kernels for Hopper and their plain versions
  parallel/  attention over the sequence axis and embedding tables (one
             shard for now)
  runtime/   the single-device Trainer and its optimizers, and the serving
             export (the JAX package's artifact format)
  serving/   batch and continuous-batching LM serving replicas, router,
             HTTP frontend and autoscaler signals
  tools/     FLOP and MFU accounting

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no device named they raise.

Nothing is imported eagerly: ``import edl_tpu_torch`` loads no torch.
"""
