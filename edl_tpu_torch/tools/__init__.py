"""Tools of the port: the cluster metrics collector (`tools.collector`),
the step profiler and trace capture (`tools.profiler`), and FLOP and MFU
accounting (`tools.mfu`)."""

from edl_tpu_torch.tools.collector import ClusterSample, Collector
from edl_tpu_torch.tools.profiler import (
    StepProfiler,
    StepRecord,
    annotate_step,
    annotation,
    device_memory_stats,
    trace,
)

__all__ = [
    "ClusterSample",
    "Collector",
    "StepProfiler",
    "StepRecord",
    "annotate_step",
    "annotation",
    "device_memory_stats",
    "trace",
]
