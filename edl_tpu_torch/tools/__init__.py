"""Tools of the port: the step profiler and trace capture
(`tools.profiler`), and FLOP and MFU accounting (`tools.mfu`). The JAX
package's metrics collector reads the controller, and comes with it."""

from edl_tpu_torch.tools.profiler import (
    StepProfiler,
    StepRecord,
    annotate_step,
    annotation,
    device_memory_stats,
    trace,
)

__all__ = [
    "StepProfiler",
    "StepRecord",
    "annotate_step",
    "annotation",
    "device_memory_stats",
    "trace",
]
