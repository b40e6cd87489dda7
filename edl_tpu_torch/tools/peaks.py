"""The card's published peak, apart from `tools.mfu` so that code which
imports no torch (the CLI, the planner) can read it."""

#: the H100 SXM's dense bf16 tensor-core peak, TFLOP/s (NVIDIA data sheet,
#: no sparsity); also the planner's default card (`parallel.planner.Topology`)
H100_PEAK_BF16_TFLOPS = 989.0
