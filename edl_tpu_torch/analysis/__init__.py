"""Domain-specific static analysis for the elastic-training codebase.

Generic linters cannot see the invariants elastic training lives or dies
by: shared controller/coordinator state mutated during a rescale must be
lock-guarded (EDL001), a body captured once and replayed (a CUDA graph,
``torch.compile``, TorchScript) must not read host state (EDL002), axis
names handed to the mesh and collective API must exist on the meshes we
actually build (EDL003), coordinator handler paths must never block
while holding the service lock (EDL004), failures must not vanish into
bare ``except`` handlers (EDL005), attributes reached from multiple thread
roots must share a lock (EDL006), the wire protocol's three
implementations must agree (EDL007), training state must not depend on
host identity or unordered iteration (EDL008), and the protocol's declared
state effects must survive bounded model checking against the in-process
coordinator (EDL009) and its crash-recovery model (EDL010). This package is an AST-based engine with one checker
per invariant, a baseline file to ratchet existing debt down, and per-line
suppression via ``# edl: noqa[RULE]``.

Run it as ``python -m edl_tpu_torch.analysis [paths]`` (default
``edl_tpu_torch``) or through ``tests/test_torch_analysis.py`` (tier-1: the
committed tree must be clean against the port's baseline,
``edl_tpu_torch/analysis/baseline.json``).
"""

from edl_tpu_torch.analysis.core import Finding, SourceFile
from edl_tpu_torch.analysis.engine import AnalysisContext, Report, analyze
from edl_tpu_torch.analysis.baseline import (
    Baseline,
    apply_baseline,
    fingerprint,
    load_baseline,
    write_baseline,
)

__all__ = [
    "AnalysisContext",
    "Baseline",
    "Finding",
    "Report",
    "SourceFile",
    "analyze",
    "apply_baseline",
    "fingerprint",
    "load_baseline",
    "write_baseline",
]
