"""Elastic hybrid-parallel layout planner: cost-model search over meshes,
the port of `edl_tpu.parallel.planner`.

A rescale used to mean one thing: resize the ``data`` axis to the new card
count and keep every other parallelism decision frozen at config time. That
leaves the survivors of a node loss running a provably suboptimal layout —
the dp x pp x virtual-stage trade-off moves with the card count, and the
hierarchical-vs-flat question flips entirely depending on whether the data
ring still fits inside one NVLink domain.

This module composes the port's closed forms into a live search:

- pipeline bubble + stash closed forms (``parallel.pipeline.bubble_fraction``
  / ``stash_slots``);
- the ZeRO-1 bytes-on-wire model (``parallel.collective.zero1_step_bytes``
  + ``estimate_collective_seconds``);
- a memory feasibility bound (params + sharded moments + activation stash
  vs the card's memory).

``plan_layout`` enumerates every feasible (mesh shape, schedule, virtual
stages, microbatch count) for the new card count — including
hierarchical shapes like ``{dcn: 2, data: k}`` against the flat ``{data:
2k}`` — scores each with the composed step-time model, and returns the
deterministic argmin. The elastic workers (``runtime.elastic`` /
``runtime.multihost``) adopt the planned layout at every rescale through
their ``layout_planner``.

The arithmetic is the JAX package's, number for number: given the same
`Topology` and `ModelProfile` both packages score the same table and pick
the same layout. Only `Topology`'s defaults differ: an NVIDIA H100 SXM
(the dense bf16 peak of `tools.mfu`, 80 GiB of HBM3, NVLink 4 inside a
node and one NDR InfiniBand port a card between nodes, the data-sheet
rates of `parallel.collective`). A slice here is one NVLink domain: a
node of cards. Everything is host-side arithmetic on a handful of
candidates — no tensors, no device work.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from edl_tpu_torch.parallel.collective import (
    INFINIBAND_BYTES_PER_SEC,
    NVLINK_BYTES_PER_SEC,
    estimate_collective_seconds,
    zero1_step_bytes,
)
from edl_tpu_torch.parallel.mesh import MeshSpec
from edl_tpu_torch.parallel.pipeline import bubble_fraction, stash_slots
from edl_tpu_torch.tools.peaks import H100_PEAK_BF16_TFLOPS

__all__ = [
    "Candidate",
    "ModelProfile",
    "Plan",
    "PIPELINE_SCHEDULES",
    "Topology",
    "data_only_plan",
    "enumerate_candidates",
    "plan_layout",
    "score_candidate",
]

#: schedules the planner searches over when the model is pipelineable
#: (``ModelProfile.n_layers`` > 1 and the caller did not restrict them).
PIPELINE_SCHEDULES = ("gpipe", "1f1b", "1f1b-interleaved")

#: microbatch counts tried per pipeline depth, as multiples of the stage
#: count (M % n == 0 is the interleaved schedule's hard constraint; using
#: the same grid for every schedule keeps the comparison fair).
_MICROBATCH_MULTIPLES = (1, 2, 4, 8)

#: virtual-stage chunk counts tried for 1f1b-interleaved (v=1 degenerates
#: to plain 1f1b, which is searched as its own schedule).
_VIRTUAL_STAGE_OPTIONS = (2, 3, 4)


@dataclass(frozen=True)
class Topology:
    """The physical fabric candidates are scored against.

    ``slices`` lists cards per NVLink domain (a node; nodes are joined by
    InfiniBand, the ``dcn`` tier), e.g. ``(8, 8)`` for two 8-card nodes. A
    job may occupy fewer cards than the fabric offers (the elastic case:
    survivors of a node loss); feasibility of a ``dcn`` axis and the
    bandwidth tier of a flat ring both derive from this shape, not from the
    card count alone. The defaults are an H100 SXM's (module docstring).
    """

    slices: Tuple[int, ...]
    #: effective per-card throughput (FLOP/s) the compute term divides by:
    #: the dense bf16 peak
    chip_flops: float = H100_PEAK_BF16_TFLOPS * 1e12
    #: per-card memory budget the stash feasibility bound checks against.
    hbm_bytes: float = 80.0 * 2**30
    #: one direction of NVLink inside a node, and of InfiniBand between nodes
    ici_bps: float = NVLINK_BYTES_PER_SEC
    dcn_bps: float = INFINIBAND_BYTES_PER_SEC

    def __post_init__(self) -> None:
        if not self.slices or any(int(s) < 1 for s in self.slices):
            raise ValueError(f"Topology.slices must be >=1 each, got {self.slices!r}")
        object.__setattr__(self, "slices", tuple(int(s) for s in self.slices))

    @property
    def chips(self) -> int:
        return sum(self.slices)

    def dcn_feasible(self, n_chips: int, n_groups: int) -> bool:
        """Can ``n_chips`` split into ``n_groups`` equal dcn groups, each
        living entirely inside a distinct slice? (Inner axes must never
        straddle a node boundary — ``build_hierarchical_mesh``'s
        construction invariant.)"""
        if n_groups <= 1 or n_chips % n_groups:
            return False
        per = n_chips // n_groups
        return sum(1 for s in self.slices if s >= per) >= n_groups

    def flat_crosses_dcn(self, n_chips: int) -> bool:
        """Does a flat axis over ``n_chips`` spill past the largest single
        NVLink domain? If so its ring has InfiniBand links in it, and the
        whole ring moves at the slowest link's speed."""
        return n_chips > max(self.slices)


@dataclass(frozen=True)
class ModelProfile:
    """The handful of numbers the step-time model needs about a model.

    Deliberately NOT a Model: the planner must run before any trainer is
    constructed (inside the rescale's replan phase) and must be cheap
    enough to sweep from the CLI.
    """

    #: bytes of ZeRO-shardable params (a divisible dim exists — the set
    #: ``zero_shard_dim`` places; grads reduce-scatter, params all-gather).
    param_bytes: float
    #: bytes of leaves that stay replicated (grad all-reduced either way).
    replicated_bytes: float = 0.0
    #: stackable layer count — bounds pipeline depth (stages must divide
    #: layers) and interleaving (n_layers % (stages * virtual) == 0).
    n_layers: int = 1
    #: train-step FLOPs per sample (fwd+bwd); 0 models a collective-bound
    #: step (the compute term drops out, layouts compete on bytes alone).
    flops_per_sample: float = 0.0
    #: stage-boundary activation bytes of ONE microbatch — the stash unit
    #: ``stash_slots`` multiplies and the p2p term ships per stage hop.
    activation_bytes_per_microbatch: float = 0.0
    #: optimizer moment bytes per param byte (adam: 2 f32 moments).
    moment_bytes_per_param_byte: float = 2.0

    def __post_init__(self) -> None:
        if self.param_bytes < 0 or self.replicated_bytes < 0:
            raise ValueError("ModelProfile byte counts must be >= 0")
        if self.n_layers < 1:
            raise ValueError(f"ModelProfile.n_layers must be >= 1, got {self.n_layers}")


@dataclass(frozen=True)
class Candidate:
    """One point in the layout search space (pre-scoring)."""

    axes: Tuple[Tuple[str, int], ...]  # canonical (name, size), AXIS_ORDER
    schedule: Optional[str]  # None when pipe == 1
    virtual_stages: int
    microbatches: int

    @property
    def axes_dict(self) -> Dict[str, int]:
        return dict(self.axes)

    def mesh_spec(self) -> MeshSpec:
        return MeshSpec({k: v for k, v in self.axes if v > 1} or {"data": 1})

    @property
    def dcn(self) -> int:
        return self.axes_dict.get("dcn", 1)

    @property
    def data(self) -> int:
        return self.axes_dict.get("data", 1)

    @property
    def pipe(self) -> int:
        return self.axes_dict.get("pipe", 1)

    def describe(self) -> str:
        axes = "x".join(f"{k}{v}" for k, v in self.axes if v > 1) or "data1"
        if self.pipe <= 1:
            return axes
        sched = self.schedule or "gpipe"
        v = f",v={self.virtual_stages}" if self.virtual_stages > 1 else ""
        return f"{axes} {sched}(M={self.microbatches}{v})"


@dataclass(frozen=True)
class ScoredCandidate:
    candidate: Candidate
    feasible: bool
    reason: str  # infeasibility cause ("" when feasible)
    step_seconds: float  # inf when infeasible
    compute_seconds: float
    bubble: float
    collective_seconds: float
    p2p_seconds: float
    stash_bytes: float
    memory_bytes: float

    def to_dict(self) -> dict:
        return {
            "layout": self.candidate.describe(),
            "axes": self.candidate.axes_dict,
            "schedule": self.candidate.schedule,
            "virtual_stages": self.candidate.virtual_stages,
            "microbatches": self.candidate.microbatches,
            "feasible": self.feasible,
            "reason": self.reason,
            "step_ms": (round(self.step_seconds * 1e3, 4)
                        if math.isfinite(self.step_seconds) else None),
            "compute_ms": round(self.compute_seconds * 1e3, 4),
            "bubble_fraction": round(self.bubble, 4),
            "collective_ms": round(self.collective_seconds * 1e3, 4),
            "p2p_ms": round(self.p2p_seconds * 1e3, 4),
            "stash_bytes": int(self.stash_bytes),
            "memory_bytes": int(self.memory_bytes),
        }


@dataclass(frozen=True)
class Plan:
    """The argmin layout plus the full scored table it won against."""

    chips: int
    mesh_axes: Tuple[Tuple[str, int], ...]
    schedule: Optional[str]
    virtual_stages: int
    microbatches: int
    step_seconds: float
    #: the trainer batch axis the layout implies (hierarchical meshes
    #: shard the batch over both the dcn and data axes).
    batch_axis: object  # str | Tuple[str, ...]
    #: modeled step time of the naive data-only resize at the same chip
    #: count — the baseline the planner must beat (inf when even that
    #: layout is infeasible).
    baseline_step_seconds: float
    table: Tuple[ScoredCandidate, ...] = field(default_factory=tuple)

    @property
    def axes_dict(self) -> Dict[str, int]:
        return dict(self.mesh_axes)

    @property
    def hierarchical(self) -> bool:
        return self.axes_dict.get("dcn", 1) > 1

    def describe(self) -> str:
        return self.chosen().candidate.describe()

    def chosen(self) -> ScoredCandidate:
        for sc in self.table:
            if sc.feasible and sc.step_seconds == self.step_seconds \
                    and sc.candidate.axes == self.mesh_axes \
                    and sc.candidate.microbatches == self.microbatches \
                    and sc.candidate.schedule == self.schedule:
                return sc
        raise ValueError("plan table does not contain its own argmin")

    def to_dict(self) -> dict:
        return {
            "chips": self.chips,
            "layout": self.describe(),
            "axes": self.axes_dict,
            "schedule": self.schedule,
            "virtual_stages": self.virtual_stages,
            "microbatches": self.microbatches,
            "batch_axis": (list(self.batch_axis)
                           if isinstance(self.batch_axis, tuple)
                           else self.batch_axis),
            "step_ms": round(self.step_seconds * 1e3, 4),
            "baseline_step_ms": (round(self.baseline_step_seconds * 1e3, 4)
                                 if math.isfinite(self.baseline_step_seconds)
                                 else None),
            "candidates": [sc.to_dict() for sc in self.table],
        }


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_candidates(
    n_chips: int,
    topology: Topology,
    profile: ModelProfile,
    global_batch: int,
    schedules: Optional[Sequence[str]] = None,
) -> List[Candidate]:
    """Every layout candidate for ``n_chips`` of ``topology``.

    ``schedules`` restricts the pipeline schedules searched; ``()`` forbids
    pipelining entirely (the elastic path's default for models without a
    stacked-layer pipeline structure), None searches all of
    ``PIPELINE_SCHEDULES``.
    """
    if n_chips < 1:
        raise ValueError(f"n_chips must be >= 1, got {n_chips}")
    if n_chips > topology.chips:
        raise ValueError(
            f"{n_chips} chips requested but topology has {topology.chips}")
    if global_batch < 1:
        raise ValueError(f"global_batch must be >= 1, got {global_batch}")
    scheds = PIPELINE_SCHEDULES if schedules is None else tuple(schedules)
    out: List[Candidate] = []
    dcn_options = [1] + [s for s in _divisors(n_chips)[1:]
                         if topology.dcn_feasible(n_chips, s)]
    for dcn in dcn_options:
        inner = n_chips // dcn
        for pipe in _divisors(inner):
            if pipe > 1 and (not scheds or profile.n_layers % pipe
                             or pipe > profile.n_layers):
                continue
            data = inner // pipe
            dp_total = dcn * data
            if global_batch % dp_total:
                continue
            axes = tuple((k, v) for k, v in
                         (("dcn", dcn), ("data", data), ("pipe", pipe))
                         if v > 1) or (("data", 1),)
            if pipe == 1:
                out.append(Candidate(axes=axes, schedule=None,
                                     virtual_stages=1, microbatches=1))
                continue
            for schedule in scheds:
                v_options = ((1,) if schedule != "1f1b-interleaved"
                             else tuple(v for v in _VIRTUAL_STAGE_OPTIONS
                                        if profile.n_layers % (pipe * v) == 0))
                for v in v_options:
                    for mult in _MICROBATCH_MULTIPLES:
                        m = mult * pipe
                        if global_batch % (dp_total * m):
                            continue
                        out.append(Candidate(
                            axes=axes, schedule=schedule,
                            virtual_stages=v, microbatches=m))
    return out


def _dp_tiers(cand: Candidate, n_chips: int,
              topology: Topology) -> List[Tuple[str, int]]:
    """The gradient-sync tier list for a candidate's data-parallel group.

    Hierarchical layouts split the sync into an intra-slice phase over the
    ``data`` axis and a cross-slice phase over ``dcn``. A FLAT layout whose
    chips spill past one slice has InfiniBand links inside its single ring,
    and a ring moves at its slowest link: the whole tier is priced at DCN speed
    (which is exactly why the planner exists — the naive data-only resize
    pays this, the hierarchical shape does not)."""
    if cand.dcn > 1:
        return [("dcn", cand.dcn), ("data", cand.data)]
    if topology.flat_crosses_dcn(n_chips):
        return [("dcn", cand.data)]  # DCN-priced flat ring
    return [("data", cand.data)]


def score_candidate(
    cand: Candidate,
    n_chips: int,
    topology: Topology,
    profile: ModelProfile,
    global_batch: int,
    grad_sync: str = "reduce_scatter",
) -> ScoredCandidate:
    """Composed step-time model for one candidate.

    step = compute / (1 - bubble)  +  zero1 collective seconds  +  p2p

    - compute assumes the work divides perfectly over chips (elasticity's
      throughput premise);
    - the bubble closed form multiplies compute because masked warmup/drain
      ticks execute at full cost (see parallel.pipeline);
    - collective bytes follow ZeRO-1 over the dp tier list, with params
      and moments divided across pipeline stages;
    - p2p ships each microbatch's boundary activation across the stage
      ring, forward + backward.

    Infeasible candidates (non-integer microbatch, stash or weights past
    HBM) come back with ``feasible=False`` and ``step_seconds=inf`` so the
    argmin never picks them but the table still shows why they lost.
    """
    dp_total = cand.dcn * cand.data
    pipe = cand.pipe
    m = cand.microbatches
    v = cand.virtual_stages

    bubble = bubble_fraction(cand.schedule or "gpipe", pipe, m, v) \
        if pipe > 1 else 0.0
    compute = (profile.flops_per_sample * global_batch
               / (topology.chip_flops * n_chips))
    pipeline_compute = compute / (1.0 - bubble) if bubble < 1.0 else math.inf

    sharded = profile.param_bytes / pipe
    replicated = profile.replicated_bytes / pipe
    tiers = _dp_tiers(cand, n_chips, topology)
    acct = zero1_step_bytes(sharded, replicated, tiers, grad_sync)
    collective = estimate_collective_seconds(
        acct, ici_bps=topology.ici_bps, dcn_bps=topology.dcn_bps)

    p2p = 0.0
    if pipe > 1:
        # Stage boundaries are NVLink when the pipe axis sits inside a slice
        # (any hierarchical layout, or a flat layout that fits one slice);
        # a flat multi-slice layout's pipe ring may straddle InfiniBand.
        bps = (topology.dcn_bps
               if cand.dcn == 1 and topology.flat_crosses_dcn(n_chips)
               else topology.ici_bps)
        p2p = (2.0 * m * profile.activation_bytes_per_microbatch
               * (pipe - 1) / pipe / bps)

    slots = stash_slots(cand.schedule or "gpipe", pipe, m, v) \
        if pipe > 1 else 0
    stash = float(slots) * profile.activation_bytes_per_microbatch
    weights = (profile.param_bytes + profile.replicated_bytes) / pipe
    moments = (profile.param_bytes * profile.moment_bytes_per_param_byte
               / (pipe * dp_total))
    memory = weights + moments + stash

    feasible = True
    reason = ""
    mb_samples, rem = divmod(global_batch, dp_total * m)
    if rem or mb_samples < 1:
        feasible, reason = False, (
            f"batch {global_batch} not divisible into {dp_total}x{m} "
            f"microbatches")
    elif memory > topology.hbm_bytes:
        feasible, reason = False, (
            f"memory {memory / 2**30:.2f} GiB exceeds HBM "
            f"{topology.hbm_bytes / 2**30:.2f} GiB")
    step = pipeline_compute + collective + p2p if feasible else math.inf
    return ScoredCandidate(
        candidate=cand, feasible=feasible, reason=reason,
        step_seconds=step, compute_seconds=compute, bubble=bubble,
        collective_seconds=collective, p2p_seconds=p2p,
        stash_bytes=stash, memory_bytes=memory,
    )


def _candidate_sort_key(sc: ScoredCandidate):
    """Deterministic argmin: modeled time first, then a stable structural
    tie-break (fewer axes, shallower pipe, lexical) so the plan is a pure
    function of (world, topology, profile, batch)."""
    c = sc.candidate
    return (sc.step_seconds, len(c.axes), c.pipe, c.virtual_stages,
            c.microbatches, c.axes, c.schedule or "")


def plan_layout(
    n_chips: int,
    topology: Topology,
    profile: ModelProfile,
    global_batch: int,
    schedules: Optional[Sequence[str]] = None,
    grad_sync: str = "reduce_scatter",
) -> Plan:
    """Enumerate, score, argmin. Raises when NO candidate is feasible —
    a chip count the batch cannot shard onto is a configuration error the
    rescale must surface, not paper over."""
    cands = enumerate_candidates(n_chips, topology, profile, global_batch,
                                 schedules=schedules)
    scored = sorted(
        (score_candidate(c, n_chips, topology, profile, global_batch,
                         grad_sync=grad_sync) for c in cands),
        key=_candidate_sort_key,
    )
    best = next((sc for sc in scored if sc.feasible), None)
    if best is None:
        raise ValueError(
            f"no feasible layout for {n_chips} chips, batch {global_batch} "
            f"on {topology.slices} (tried {len(scored)} candidates)")
    baseline = data_only_step_seconds(n_chips, topology, profile,
                                      global_batch, grad_sync=grad_sync)
    c = best.candidate
    return Plan(
        chips=n_chips,
        mesh_axes=c.axes,
        schedule=c.schedule,
        virtual_stages=c.virtual_stages,
        microbatches=c.microbatches,
        step_seconds=best.step_seconds,
        batch_axis=("dcn", "data") if c.dcn > 1 else "data",
        baseline_step_seconds=baseline,
        table=tuple(scored),
    )


def data_only_plan(
    n_chips: int,
    topology: Topology,
    profile: ModelProfile,
    global_batch: int,
    grad_sync: str = "reduce_scatter",
) -> ScoredCandidate:
    """The naive resize scored under the SAME model: flat ``{data: n}``,
    no pipeline, no hierarchy — exactly what the pre-planner
    ``_build_mesh`` produced. The oracle the planner must beat."""
    cand = Candidate(axes=(("data", n_chips),), schedule=None,
                     virtual_stages=1, microbatches=1)
    return score_candidate(cand, n_chips, topology, profile, global_batch,
                           grad_sync=grad_sync)


def data_only_step_seconds(
    n_chips: int,
    topology: Topology,
    profile: ModelProfile,
    global_batch: int,
    grad_sync: str = "reduce_scatter",
) -> float:
    sc = data_only_plan(n_chips, topology, profile, global_batch,
                        grad_sync=grad_sync)
    return sc.step_seconds
