"""edl_tpu_torch — the port of edl_tpu to PyTorch and CUDA on NVIDIA Hopper.

The JAX package `edl_tpu` stays beside it as the reference; this package
imports neither JAX nor anything of `edl_tpu`, and keeps its own copy of
what it needs. It mirrors the reference's layout, so each counterpart sits
at the same path:

  ckpt_plane/ the memory-resident checkpoint plane: peer-replicated ZeRO-1
             shards in the JAX package's blob format
  cli        ``python -m edl_tpu_torch``: validate, run, controller, status,
             serve, plan and train, as the JAX package's CLI
  controller/ the control plane: cluster accounting, the autoscaler, the
             per-job updater, actuation through the job's coordinator, and
             the in-memory and local-process cluster backends
  coordinator/ copies of the JAX package's coordinator client, in-process
             twin and native-server manager (the same binary)
  examples/  the training entries the launcher execs, and the elastic demo
  k8s/       the Kubernetes backend of the control plane (stdlib HTTP)
  models/    the model bundle and the zoo: fit_a_line, mnist, word2vec, ctr,
             resnet and the transformer LM (with its serving steps)
  obs/       the metrics registry, span tracing and `/metrics` over HTTP
  ops/       hand-written CUDA kernels for Hopper and their plain versions
  parallel/  the mesh of ranks, its collectives and batch sharding,
             embedding tables across shards, and attention over the
             sequence axis (one shard for now)
  runtime/   the Trainer on one device or a mesh of ranks, its optimizers
             and options (wire transport, gradient accumulation, pipelined
             placement), the lease-driven data path, checkpoints (the port's
             own format), the serving export (the JAX package's format) and
             elasticity: the elastic and multi-process workers, the
             fault-tolerance policy and the straggler detector
  serving/   batch and continuous-batching LM serving replicas, router,
             HTTP frontend and autoscaler signals
  tools/     the cluster collector, the step profiler, FLOP and MFU
             accounting

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device and no device named they raise.

Nothing is imported eagerly: ``import edl_tpu_torch`` loads no torch.
"""
