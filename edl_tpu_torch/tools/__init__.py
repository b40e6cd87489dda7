"""Tools of the port: the cluster metrics collector (`tools.collector`),
the step profiler and trace capture (`tools.profiler`), and FLOP and MFU
accounting (`tools.mfu`).

The names below resolve at first use (`__getattr__`): the profiler imports
torch, and the CLI and the controller, which import this package, need none.
"""

import importlib

#: name -> the submodule that defines it
_MODULES = {
    "ClusterSample": "collector",
    "Collector": "collector",
    "StepProfiler": "profiler",
    "StepRecord": "profiler",
    "annotate_step": "profiler",
    "annotation": "profiler",
    "device_memory_stats": "profiler",
    "trace": "profiler",
}

__all__ = list(_MODULES)


def __getattr__(name):
    if name not in _MODULES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_MODULES[name]}"), name)
