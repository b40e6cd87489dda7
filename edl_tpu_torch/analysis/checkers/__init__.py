"""Checker registry: one module per EDL rule."""

from edl_tpu_torch.analysis.checkers.lock_discipline import LockDisciplineChecker
from edl_tpu_torch.analysis.checkers.trace_hygiene import TraceHygieneChecker
from edl_tpu_torch.analysis.checkers.sharding_consistency import (
    ShardingConsistencyChecker,
)
from edl_tpu_torch.analysis.checkers.blocking import BlockingInLockChecker
from edl_tpu_torch.analysis.checkers.exception_hygiene import ExceptionHygieneChecker
from edl_tpu_torch.analysis.checkers.thread_races import ThreadRaceChecker
from edl_tpu_torch.analysis.checkers.wire_protocol import WireProtocolChecker
from edl_tpu_torch.analysis.checkers.elastic_determinism import (
    ElasticDeterminismChecker,
)
from edl_tpu_torch.analysis.checkers.protocol_model import ProtocolModelChecker
from edl_tpu_torch.analysis.checkers.durability import DurabilityModelChecker

ALL_CHECKERS = (
    LockDisciplineChecker,
    TraceHygieneChecker,
    ShardingConsistencyChecker,
    BlockingInLockChecker,
    ExceptionHygieneChecker,
    ThreadRaceChecker,
    WireProtocolChecker,
    ElasticDeterminismChecker,
    ProtocolModelChecker,
    DurabilityModelChecker,
)

RULES = {c.rule: c for c in ALL_CHECKERS}

__all__ = ["ALL_CHECKERS", "RULES"]
