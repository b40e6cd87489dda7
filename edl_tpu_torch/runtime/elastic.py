"""Elastic training: membership-driven checkpoint-restore rescale, the port
of `edl_tpu.runtime.elastic`.

The flow, as in the JAX package:

  register -> build the mesh for the current world -> restore-or-init ->
  train on leased shards, heartbeating ->
  on membership epoch change: checkpoint, barrier with survivors,
  rebuild at the new world size, restore, resume.

Recovery time (detect -> first step at the new world) is measured and
reported — the north-star budget is <30 s (BASELINE.md) — and every rescale
records the eight `RESCALE_PHASES` under the new epoch's trace id.

**One device per process.** The JAX single-host simulation grows one
process's mesh over more local devices as the world grows (its
``default_device_planner``: world 1 -> 4 devices, world 2 -> 8). One
process driving several cards is not PyTorch's idiom: a card is a rank,
and a job over several cards runs one `MultiHostWorker` per card. So this
worker builds its mesh over its one device (``device``, default the current
CUDA device) at every world size: a world-1 local mesh
(`parallel.mesh.local_mesh`). A rescale is still the JAX package's:
checkpoint, barrier, a new `Trainer`, restore, resume. The global batch is
the same at every world size, so the math is too: the losses match the JAX
worker's on a CPU mesh of any size.

The layout, as in the JAX worker: ``mesh_axes`` fixes the non-data axes
and ``data`` takes the rest of the devices, so with one device a fixed
axis above 1 raises the JAX worker's ``ValueError`` ("1 devices not
divisible by fixed axes ..."), as the JAX worker does given one device.
``layout_planner(n_devices, devices) -> Plan | None`` (say
`parallel.planner.plan_layout` closed over a `Topology` and a
`ModelProfile`) replaces that at every rescale; its plan is recorded on the
``replan`` span (``planned``, ``schedule``, ``microbatches``,
``modeled_step_seconds``, ``baseline_step_seconds``) and re-points the
Trainer's batch axis when it is hierarchical. Here it is asked for one
device. Model-parallel meshes over several cards run in the
`MultiHostWorker`.

``profiler=`` takes a `tools.profiler.StepProfiler`: every rescale marks
the next step warm-up, and the run's summary carries its ``profile_*``
keys. ``compile_cache_dir`` is accepted and does nothing: eager PyTorch
keeps no executable for a layout, and the one compiled artifact, the
kernel library, is already kept on disk by a digest of its sources
(`ops._build`); so every `RescaleEvent.compile_cache` reads ``"off"``, as
a JAX worker without a cache reports it. ``warm_compile`` runs one forward
on zeros during the restore (see `Trainer.warm_compile`).
``metrics_port`` serves the worker's own `/metrics` with the coordinator's
status counters bridged onto it (`obs.bridge`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from edl_tpu_torch.coordinator.client import CoordinatorError
from edl_tpu_torch.coordinator.outbox import OutboxClient
from edl_tpu_torch.coordinator.watch import make_epoch_watch
from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model
from edl_tpu_torch.obs.instruments import PreemptInstruments, WorkerInstruments
from edl_tpu_torch.obs.tracing import Tracer, get_tracer, rescale_trace_id
from edl_tpu_torch.parallel.mesh import Mesh, MeshSpec, local_mesh
from edl_tpu_torch.runtime.checkpoint import Checkpointer
from edl_tpu_torch.runtime.data import LeaseReader, split_pass
from edl_tpu_torch.runtime.ft_policy import (
    DRAIN_SHRINK, MODE_CODES, PARK, RIDE_OUT, FTPolicy, FTPolicyConfig,
)
from edl_tpu_torch.runtime.train_loop import Trainer, TrainerConfig, TrainState
from edl_tpu_torch.runtime.wire import WireRestartRequired

#: coordinator KV key a worker publishes its live policy state under;
#: `edl-tpu status` enumerates members and reads these back.
FT_POLICY_KEY = "edl/ft_policy/{worker}"

log = logging.getLogger("edl_tpu_torch.runtime.elastic")


@dataclass
class ElasticConfig:
    checkpoint_dir: str = ""
    checkpoint_interval: int = 100  # steps between periodic async saves
    heartbeat_interval: float = 1.0  # seconds between coordinator heartbeats
    #: fractional jitter (±) applied per beat to the heartbeat interval,
    #: seeded by worker name: 10k workers launched from one template would
    #: otherwise phase-lock into synchronized heartbeat storms that turn
    #: the coordinator's load spiky (see doc/performance.md, control plane).
    heartbeat_jitter: float = 0.2
    #: how epoch changes reach this worker: ``"watch"`` subscribes to the
    #: coordinator's push stream (a rescale arrives in one RTT instead of a
    #: heartbeat period) and treats a dead subscription as an error to
    #: surface; ``"pull"`` keeps the pre-watch heartbeat-only discovery;
    #: ``"auto"`` (default) subscribes when the transport supports it and
    #: degrades silently to pull when it doesn't. Pull stays on as the
    #: liveness fallback in every mode — the watch only *adds* latency
    #: headroom and suppresses redundant dedicated pulls while healthy.
    epoch_discovery: str = "auto"
    #: max wait for survivors at the rescale barrier; on timeout we proceed
    #: (the checkpoint is already durable, latecomers restore from it).
    rescale_barrier_timeout: float = 60.0
    batch_axis: str = "data"
    #: optional per-step hook (step, state) -> None — e.g. a
    #: `runtime.export.PeriodicExporter` writing the serving artifact the
    #: way the reference's trainer 0 does (`ctr/train.py:169-180`).
    step_callback: Optional[Callable[[int, TrainState], None]] = None
    #: on a membership change, checkpoint durably and exit the process with
    #: RESCALE_EXIT_CODE instead of rebuilding in-process: the pod launcher
    #: (launcher.launch.start_trainer) relaunches the entry, which re-runs
    #: distributed_init and restores from the checkpoint. The default
    #: rebuilds in-process.
    restart_on_rescale: bool = False
    #: pipeline the data path: the next shard loads on a background thread
    #: while the current shard's batches feed training (costs one extra held
    #: lease + up to two shards of host RAM). See LeaseReader.
    prefetch: bool = False
    #: device-side input pipelining: > 0 runs wire encode + H2D batch
    #: placement on a pump thread (`runtime.pipeline.DevicePrefetcher`),
    #: up to this many placed batches ahead of step dispatch. 0 places
    #: synchronously. The lease RPCs move to the pump thread with the
    #: reader; CoordinatorClient serializes per-request, so heartbeats and
    #: checkpoint commits on the main thread interleave safely.
    pipeline_depth: int = 2
    #: warm what the first step at the new world pays lazily (one forward on
    #: zeros of the noted batch shapes: the kernels' library load and the
    #: library handles; `Trainer.warm_compile`) on a background thread
    #: during the rescale restore window.
    warm_compile: bool = True
    #: coordinator-outage budget, seconds: while the coordinator is
    #: unreachable the worker keeps stepping batches already leased (the
    #: compute never depended on the control plane) and buffers
    #: completions in an outbox; past this budget it checkpoints durably
    #: and parks, polling for the coordinator's return. See
    #: doc/robustness.md for the full failure model.
    outage_budget: float = 60.0
    #: fault-tolerance policy mode: ``adaptive`` sizes the park decision
    #: per incident from live outage statistics and measured recovery
    #: costs (`runtime.ft_policy`); ``static`` pins it to the fixed
    #: ``outage_budget`` threshold above — the pre-policy semantics.
    policy: str = "adaptive"
    #: full policy knobs; None derives FTPolicyConfig(policy=policy,
    #: outage_budget=outage_budget) with the documented defaults.
    ft_policy: Optional[FTPolicyConfig] = None
    #: serve ``/metrics`` + ``/healthz`` + ``/spans`` from this worker
    #: process on the given port (0 = ephemeral); None disables. The
    #: endpoint also bridges the coordinator's status counters, so one
    #: scrape sees the control plane and the data plane together.
    metrics_port: Optional[int] = None
    #: memory-resident checkpoint plane (``edl_tpu_torch.ckpt_plane``): > 0
    #: replicates each worker's ZeRO-1 state shard to this many ring peers
    #: through the coordinator at every checkpoint, and restores assemble
    #: from peers in memory (zero blob reads) with the blob store as the
    #: group-death fallback. 0 (the default) disables the plane entirely —
    #: restores read the blob store exactly as before.
    peer_replicas: int = 0
    #: the JAX package's persistent AOT compile cache directory, accepted
    #: and unused: eager PyTorch keeps no executable for a layout, and the
    #: kernel library is kept on disk by a digest of its sources
    #: (`ops._build`). Every `RescaleEvent.compile_cache` reads "off".
    compile_cache_dir: str = ""
    trainer: TrainerConfig = field(default_factory=TrainerConfig)

    def __post_init__(self) -> None:
        # Fail at construction, not an hour into the job: a negative
        # outage_budget silently turned every blip into a park, a negative
        # heartbeat interval spins the beat loop hot — both were accepted
        # without complaint before this check.
        if self.heartbeat_interval < 0:
            raise ValueError(
                f"ElasticConfig.heartbeat_interval must be >= 0 seconds "
                f"(0 beats every loop iteration), got {self.heartbeat_interval!r}")
        if not 0.0 <= self.heartbeat_jitter <= 1.0:
            raise ValueError(
                f"ElasticConfig.heartbeat_jitter is a ± fraction of the "
                f"interval and must be in [0, 1], got {self.heartbeat_jitter!r}")
        if self.outage_budget <= 0:
            raise ValueError(
                f"ElasticConfig.outage_budget must be > 0 seconds (it is "
                f"the park threshold ceiling), got {self.outage_budget!r}")
        if self.rescale_barrier_timeout <= 0:
            raise ValueError(
                f"ElasticConfig.rescale_barrier_timeout must be > 0 "
                f"seconds, got {self.rescale_barrier_timeout!r}")
        if self.checkpoint_interval < 1:
            raise ValueError(
                f"ElasticConfig.checkpoint_interval must be >= 1 step, "
                f"got {self.checkpoint_interval!r}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"ElasticConfig.pipeline_depth must be >= 0 "
                f"(0 places synchronously), got {self.pipeline_depth!r}")
        if self.policy not in ("adaptive", "static"):
            raise ValueError(
                f"ElasticConfig.policy must be 'adaptive' or 'static', "
                f"got {self.policy!r}")
        if self.epoch_discovery not in ("watch", "pull", "auto"):
            raise ValueError(
                f"ElasticConfig.epoch_discovery must be 'watch', 'pull' or "
                f"'auto', got {self.epoch_discovery!r}")
        if self.peer_replicas < 0:
            raise ValueError(
                f"ElasticConfig.peer_replicas must be >= 0 "
                f"(0 disables the checkpoint plane), got "
                f"{self.peer_replicas!r}")


def check_layout_args(mesh_axes: Optional[Dict[str, int]], layout_planner) -> None:
    """The JAX workers' rule: a static layout or a searched one, not both."""
    if layout_planner is not None and mesh_axes:
        raise ValueError(
            "pass either mesh_axes (static layout) or layout_planner "
            "(searched layout), not both")


def fixed_axes_mesh_spec(mesh_axes: Optional[Dict[str, int]], n: int) -> MeshSpec:
    """The JAX workers' static layout for ``n`` devices: ``mesh_axes`` fixed
    and ``data`` over the rest, raising their ``ValueError`` when the fixed
    axes do not divide ``n``."""
    axes = dict(mesh_axes or {})
    fixed = 1
    for size in axes.values():
        fixed *= size
    if n % fixed != 0:
        raise ValueError(f"{n} devices not divisible by fixed axes {axes}")
    axes["data"] = n // fixed
    return MeshSpec(axes)


def planned_trainer_config(config: TrainerConfig, plan) -> TrainerConfig:
    """The trainer config for the current layout: a planned layout
    re-points the batch axis (a hierarchical plan shards the batch over
    ("dcn", "data")); the static path uses ``config`` as it is."""
    if plan is None or config.batch_axis == plan.batch_axis:
        return config
    return dataclasses.replace(config, batch_axis=plan.batch_axis)


def heartbeat_schedule(worker: str, base: float, jitter: float,
                       n: int) -> List[float]:
    """First ``n`` heartbeat intervals for ``worker``: ``base`` ± ``jitter``
    fraction, drawn from an RNG seeded by the worker's name. This is the
    exact sequence ElasticWorker/MultiHostWorker sleep between beats —
    deterministic per name (str seeds hash stably in ``random.Random``),
    different across names, so a fleet de-correlates without coordination.
    Exposed for tests and capacity planning.
    """
    rng = random.Random(f"edl-hb:{worker}")  # edl: noqa[EDL008] heartbeat jitter, not training state — per-worker decorrelation is the point
    return [max(0.0, base * (1.0 + jitter * (2.0 * rng.random() - 1.0)))
            for _ in range(n)]


@dataclass
class RescaleEvent:
    at_step: int
    from_world: int
    to_world: int
    recovery_seconds: float
    #: warm-up time at the new world (`Trainer.warm_compile`), overlapped
    #: with restore on a background thread (0.0 when warm-compile was off
    #: or skipped) — reported as its own field so the recovery interval it
    #: no longer sits inside stays honest.
    compile_seconds: float = 0.0
    #: the JAX package's compile-cache outcome; always "off" here (eager
    #: PyTorch has no executable cache; see ``compile_cache_dir``).
    compile_cache: str = "off"
    #: the mesh layout adopted at this rescale: this process's local mesh
    #: (every axis of size 1).
    layout: Dict[str, int] = field(default_factory=dict)


@contextlib.contextmanager
def beating(client, interval: float, name: str = "edl-beat"):
    """Heartbeat ``client`` every ``interval`` seconds (at least 0.1) on a
    thread for the body's length. A restore (the model's build and the
    checkpoint's load) or a save makes no coordinator call and grows with
    the model: past the heartbeat TTL the member would expire and the epoch
    move under it. A failed beat is left to the caller's own loop, whose
    heartbeats meet the outage."""
    stop = threading.Event()

    def beat() -> None:
        while not stop.wait(max(0.1, interval)):
            try:
                client.heartbeat()
            except CoordinatorError:
                pass

    thread = threading.Thread(target=beat, name=name, daemon=True)
    thread.start()
    try:
        yield
    finally:
        stop.set()
        thread.join()


class ElasticWorker:
    """One trainer process's elastic loop."""

    def __init__(
        self,
        model: Model,
        client,  # coordinator client bound to this worker's name
        source,  # shard source with .read(shard)
        config: ElasticConfig,
        device: DeviceLike = None,
        mesh_axes: Optional[Dict[str, int]] = None,
        profiler=None,  # optional tools.profiler.StepProfiler
        tracer: Optional[Tracer] = None,
        layout_planner=None,
    ):
        if not config.checkpoint_dir:
            raise ValueError("ElasticConfig.checkpoint_dir is required")
        check_layout_args(mesh_axes, layout_planner)
        self.profiler = profiler
        self.model = model
        #: this process's one device (see the module docstring)
        self.device = resolve_device(device)
        #: degraded-mode facade: mutations buffer during a coordinator
        #: outage and replay idempotently on reconnect; reads fail soft.
        self.client = client if isinstance(client, OutboxClient) \
            else OutboxClient(client)
        self.source = source
        self.config = config
        self.mesh_axes = mesh_axes  # extra non-data axes, sized per full mesh
        #: hybrid-parallel replanner: ``(n_devices, devices) -> Plan | None``
        #: (typically ``parallel.planner.plan_layout`` closed over a Topology
        #: + ModelProfile). Called at every rescale; a returned Plan's mesh
        #: axes and batch axis replace the static data-only resize, a None
        #: falls back to it. Mutually exclusive with ``mesh_axes`` — the
        #: plan owns the whole layout.
        self.layout_planner = layout_planner
        #: the Plan adopted at the last mesh build (None on the static path)
        self.last_plan = None
        #: rescale lifecycle spans land here (shared process tracer unless a
        #: test/bench passes its own); correlated cross-process via the
        #: membership epoch (obs.tracing.rescale_trace_id).
        self.tracer = tracer if tracer is not None else get_tracer()
        self.obs = WorkerInstruments()
        #: per-incident recovery-mode selector (doc/robustness.md, policy
        #: layer): replaces the fixed outage_budget comparison with a
        #: threshold computed from the live outage distribution and
        #: measured checkpoint/restore/re-step costs. ``policy="static"``
        #: pins it back to the old semantics.
        self.policy = FTPolicy(
            config.ft_policy if config.ft_policy is not None
            else FTPolicyConfig(policy=config.policy,
                                outage_budget=config.outage_budget),
            worker=self.client.worker,
            tracer=self.tracer,
        )
        #: transport retry policy at construction — the regime baseline the
        #: storm deadline override is computed from and restored to.
        self._default_retry = None
        self.client.on_outage_close = self._on_outage_close
        self.ckpt = Checkpointer(config.checkpoint_dir)
        #: the Trainer and mesh of the current world (the checkpoint plane
        #: gathers the state through the Trainer; a step_callback such as a
        #: `PeriodicExporter` reads the mesh)
        self._trainer: Optional[Trainer] = None
        self.mesh: Optional[Mesh] = None
        #: memory-resident checkpoint plane (None when disabled): peer-
        #: replicated ZeRO shards pushed at every checkpoint, assembled in
        #: memory on restore, blob store as the group-death fallback.
        if config.peer_replicas > 0:
            from edl_tpu_torch.ckpt_plane import CkptPlane

            self.ckpt_plane: Optional[CkptPlane] = CkptPlane(
                self.client, replicas=config.peer_replicas,
                tracer=self.tracer)
        else:
            self.ckpt_plane = None
        #: what the last _restore_or_init was served from — the restore
        #: span's source/bytes attribution (peer | blob | init).
        self._last_restore: Dict = {"source": "init", "bytes": 0}
        self.rescales: List[RescaleEvent] = []
        self.steps_done = 0
        self.losses: List[float] = []
        self._epoch = -1
        self._world = 0
        self._prev_world = 0
        self._rank = -1
        self._last_heartbeat = 0.0
        #: per-worker seeded jitter stream (satellite of the control-plane
        #: scale work): each beat draws its own interval so the fleet's
        #: heartbeats de-correlate instead of arriving in phase-locked waves.
        self._hb_rng = random.Random(f"edl-hb:{self.client.worker}")  # edl: noqa[EDL008] control-plane timing jitter, never touches model/optimizer state
        self._hb_interval = self._next_hb_interval()
        #: heartbeats satisfied from a piggybacked membership observation
        #: (no dedicated RPC issued).
        self.hb_coalesced = 0
        # Piggyback heartbeats onto in-flight calls when the transport
        # supports it: lease/kv traffic then refreshes our TTL for free and
        # most dedicated beats coalesce away entirely.
        raw = getattr(self.client, "client", self.client)
        if getattr(raw, "piggyback_heartbeat", None) == 0.0:
            raw.piggyback_heartbeat = config.heartbeat_interval
        #: push-based epoch discovery: a watch subscription on the raw
        #: transport (None when epoch_discovery='pull' or the transport
        #: supports neither flavor). Pull stays the liveness fallback.
        self._watch = make_epoch_watch(self.client, config.epoch_discovery)
        if config.epoch_discovery == "watch" and self._watch is None:
            raise ValueError(
                "epoch_discovery='watch' but the transport exposes neither "
                "a wire endpoint nor a call surface to subscribe on")
        #: dedicated pull rounds skipped because a healthy watch already
        #: covered epoch discovery (mirrors the metric family).
        self.pulls_suppressed = 0
        #: True between observing the coordinator unreachable and the next
        #: successful control-plane call — gates benign epoch adoption.
        self._outage_open = False
        #: wall time _epoch_changed first decided to interrupt — the drain
        #: span's start (signal -> step loop quiesced), 0.0 when no signal
        #: is pending.
        self._drain_signal_t = 0.0
        #: preemption sensor suite (notices, notice-to-drained, evictions).
        self.preempt_obs = PreemptInstruments()
        #: advance-notice revocation addressed to THIS worker, consumed
        #: from the watch stream and awaiting its drain: the notice dict
        #: (worker/notice_s/reason/seq/arrival/deadline) plus the policy's
        #: ``mode`` and the wall-clock arrival for span stitching.
        self._pending_preempt: Optional[Dict] = None
        #: replay-free drain latch: the reader stops at the next shard
        #: BOUNDARY (nothing fails back) instead of interrupting mid-shard.
        self._soft_drain = False
        #: times the worker hit the outage budget and parked.
        self.parks = 0
        #: completion lag (at-least-once across hard crashes): shards whose
        #: updates the save initiated LAST is covering — their leases are
        #: completed once the NEXT save initiation proves that save durable
        #: (the Checkpointer keeps one save in flight).
        self._pending_commit: List[str] = []
        #: fully-consumed shards no initiated save covers yet.
        self._carry_consumed: List[str] = []
        #: per-pass step counts (multi-pass training; key = pass index).
        self.pass_steps: Dict[int, int] = {}
        #: host-batch (shape, dtype) per key observed at first placement —
        #: what the rescale warm-up runs its forward on. Written once from
        #: whichever thread places first.
        self._batch_avals: Optional[Dict[str, Tuple[Tuple[int, ...], np.dtype]]] = None

    # -- fault-tolerance policy plumbing ----------------------------------------

    def _on_outage_close(self, duration: float) -> None:
        """OutboxClient callback: one outage incident ended. Feeds the
        per-incident duration (the histogram the running-total gauge loses)
        and the policy's history, then re-applies the regime's transport
        deadline. Runs on whichever thread's guarded call observed
        recovery — everything here is thread-safe and cheap."""
        self.obs.outage_duration.observe(duration)
        self.policy.note_outage_closed(duration)
        self._apply_retry_deadline()
        self._publish_policy_state()

    def _apply_retry_deadline(self) -> None:
        """Storm regime: shorten the transport's retry deadline so calls
        fail fast into degraded mode instead of spending the policy's wait
        window inside one RPC's retry loop; restore the construction-time
        default when the regime calms."""
        raw = getattr(self.client, "client", self.client)
        retry = getattr(raw, "retry", None)
        if retry is None or not hasattr(retry, "deadline"):
            return  # in-process clients have no transport retry loop
        if self._default_retry is None:
            self._default_retry = retry
        want = self.policy.retry_deadline()
        raw.retry = (dataclasses.replace(self._default_retry, deadline=want)
                     if want is not None else self._default_retry)

    def _publish_policy_state(self) -> None:
        """Push the policy's auditable state to the coordinator KV — a
        guarded mutation, so it buffers through the outbox during the very
        outages it describes and lands on replay. `edl-tpu status` reads
        these keys back per member."""
        try:
            self.client.kv_put(
                FT_POLICY_KEY.format(worker=self.client.worker),
                json.dumps(self.policy.state()))
        except Exception:  # edl: noqa[EDL005] telemetry publish is best-effort; policy-state visibility must never take down training
            log.debug("ft_policy state publish failed", exc_info=True)

    # -- membership ------------------------------------------------------------

    def _adopt(self, info: Dict) -> None:
        self._epoch = info["epoch"]
        self._world = max(1, info["world"])
        self._rank = int(info.get("rank", -1))
        if self._watch is not None \
                and int(self._epoch) > self._watch.last_epoch:
            # Prime the resume cursor: epochs adopted via register/pull must
            # not replay as notifications on the next (re)subscribe.
            self._watch.last_epoch = int(self._epoch)
        self.obs.note_epoch(self._epoch)
        if self.ckpt_plane is not None:
            # New epoch = new rank numbering: publish the epoch's replica-
            # placement map and invalidate the previous epoch's key.
            self.ckpt_plane.on_epoch(self._epoch, self._world, self._rank)

    def _sync_membership(self) -> None:
        # run() entry = incarnation boundary: a predecessor's leases (same
        # pod name, relaunched after a crash) requeue for replay.
        info = self.client.register(takeover=True)
        if not info.get("ok"):
            info = self._register_blocking(takeover=True)
        self._adopt(info)
        if self._watch is not None:
            # Subscribe after the first adoption so the cursor is primed —
            # the coordinator replays nothing we already know. Failure is
            # not fatal: poll() retries with backoff, pull covers the gap.
            self._watch.subscribe()

    def _register_blocking(self, takeover: bool = False) -> Dict:
        """Re-register, waiting out a coordinator outage — the PARKED state.

        ``takeover=False`` (the reconnect default) keeps our leases: the
        coordinator restores/renews them for a returning worker, so an
        outage shorter than the lease TTL never forfeits shards mid-
        training. The first success replays the outbox (OutboxClient)
        before we resume normal bookkeeping.
        """
        logged = False
        while True:
            reply = self.client.register(takeover=takeover)
            self.obs.note_outage_state(self.client)
            if reply.get("ok"):
                self._outage_open = False
                if logged:
                    log.info("coordinator back after %d park(s); outage "
                             "telemetry: %s", self.parks, self.client.summary())
                return reply
            if not logged:
                logged = True
                log.warning("parked: waiting for coordinator (%s)",
                            reply.get("error", "unreachable"))
            # Jittered: a coordinator restart otherwise gets the whole
            # parked fleet re-registering in phase-locked waves.
            base = min(1.0, max(0.1, self.config.heartbeat_interval))
            time.sleep(max(0.05, base * (1.0 + self.config.heartbeat_jitter
                                         * (2.0 * self._hb_rng.random() - 1.0))))

    def _next_hb_interval(self) -> float:
        return max(0.0, self.config.heartbeat_interval
                   * (1.0 + self.config.heartbeat_jitter
                      * (2.0 * self._hb_rng.random() - 1.0)))

    def _poll_pause(self, base: float = 0.2) -> None:
        """Idle-poll sleep from the seeded per-worker jitter stream: a
        fleet draining the same queue (or the same outage) would otherwise
        re-poll the coordinator in phase-locked waves — the identical
        hazard the heartbeat jitter exists for."""
        time.sleep(max(0.05, base * (1.0 + self.config.heartbeat_jitter
                                     * (2.0 * self._hb_rng.random() - 1.0))))

    def _signal_drain(self) -> bool:
        """Mark the instant the interrupt decision was made (the drain
        span's start — first signal wins: quiesce time is measured from the
        earliest observation, not the latest re-confirmation)."""
        if not self._drain_signal_t:
            self._drain_signal_t = time.time()
        return True

    #: coalesce-window stretch while the watch is healthy: dedicated pulls
    #: drop to 1/stretch cadence because discovery rides the push stream.
    _WATCH_PULL_STRETCH = 3.0

    def _consume_watch(self) -> bool:
        """Drain pushed epoch notifications (non-blocking) and report
        whether one names an epoch beyond ours. Arrival -> consumption
        delay feeds `edl_worker_epoch_notify_latency_seconds`. A dead
        subscription is not an error here: poll() re-subscribes with
        bounded backoff and the pull cadence stays the liveness fallback.
        """
        now = time.monotonic()
        moved = False
        for epoch, arrived in self._watch.poll():
            self.obs.note_epoch_notify(now - arrived)
            if epoch > self._epoch:
                moved = True
        take = getattr(self._watch, "take_preempts", None)
        if callable(take):
            for notice in take():
                if self._handle_preempt(notice):
                    moved = True
        return moved

    def _handle_preempt(self, notice: Dict) -> bool:
        """One revocation notice addressed to this worker: run the policy's
        notice-budget decision and report whether the step loop should
        interrupt mid-shard. ``ride_out`` keeps stepping — the notice was
        too short for even a checkpoint to pay off. ``drain_shrink`` (ample
        budget) drains at the next SHARD boundary via the soft latch:
        the in-flight shard finishes and completes, so NOTHING replays on
        the survivors. ``park`` (tight budget) interrupts mid-shard — the
        in-flight lease fails back (at-least-once replay accepted) to buy
        checkpoint time before the deadline."""
        now_mono = time.monotonic()
        remaining = notice["deadline"] - now_mono
        self.preempt_obs.notices.inc(reason=notice.get("reason", "preempt"))
        self.preempt_obs.notice_remaining.set(remaining)
        mode = self.policy.on_preempt_notice(remaining)
        log.warning(
            "preempt notice: %.1fs remaining (reason=%s seq=%s) -> %s",
            remaining, notice.get("reason"), notice.get("seq"), mode)
        if mode == RIDE_OUT:
            return False
        self._pending_preempt = {
            **notice, "mode": mode,
            # monotonic arrival -> wall clock, so the preempt_drain span
            # stitches onto the survivors' rescale timeline.
            "wall_arrival": time.time() - (now_mono - notice["arrival"]),
        }
        if mode == DRAIN_SHRINK:
            self._soft_drain = True
            self._signal_drain()  # drain span starts at the decision
            return False
        return True

    def _finish_preempt_drain(self, state: TrainState, drain_t0: float,
                              ck_t0: float, ck_t1: float, world: int,
                              t_start: float) -> Dict[str, float]:
        """The revoked worker's exit: evacuate this rank's shards onto
        surviving replica holders, leave (bumping the epoch the survivors
        replan under), and return a summary with ``steps_lost == 0`` — the
        blocking checkpoint that preceded this call made every consumed
        shard durable, so nothing trained here replays.

        The ``preempt_drain`` span (notice arrival -> evacuation done) is
        stamped with the POST-leave epoch's trace id: that is the rescale
        the survivors run, so their drain/replan/restore spans and our
        notice-window span stitch into one timeline.
        """
        pd = self._pending_preempt
        self._pending_preempt = None
        self._soft_drain = False
        assert pd is not None
        ev_t0 = time.time()
        if self.ckpt_plane is not None and pd["mode"] == DRAIN_SHRINK:
            # Placement override: this rank is banned from every replica
            # ring from here on, and its shards are pushed to survivors NOW
            # (peer-sourced restore must not depend on the doomed host).
            self.ckpt_plane.set_revoked([self._rank])
            self.ckpt_plane.evacuate(self._trainer.full_state(state),
                                     int(state.step), max(1, self._world))
        reply = self.client.leave()
        drained_mono = time.monotonic()
        ev_t1 = time.time()
        left_epoch = int(reply.get("epoch", self._epoch + 1))
        rid = rescale_trace_id(left_epoch)
        self.tracer.record("preempt_drain", pd["wall_arrival"], ev_t1,
                           trace_id=rid, component="worker", notice=True,
                           mode=pd["mode"], reason=pd.get("reason", ""),
                           notice_s=float(pd.get("notice_s", 0.0)),
                           evacuate_seconds=round(ev_t1 - ev_t0, 6))
        self.tracer.record("drain", drain_t0, ck_t0, trace_id=rid,
                           component="worker", from_world=world)
        self.tracer.record("checkpoint", ck_t0, ck_t1, trace_id=rid,
                           component="worker")
        notice_to_drained = drained_mono - pd["arrival"]
        deadline_met = drained_mono <= pd["deadline"]
        self.preempt_obs.notice_to_drained.observe(notice_to_drained)
        trigger = ("straggler" if pd.get("reason") == "straggler"
                   else "revocation")
        self.preempt_obs.evictions.inc(trigger=trigger)
        log.warning(
            "preempt drain complete: left epoch %d after %.2fs of %.1fs "
            "notice (deadline %s, trigger=%s, steps_lost=0)",
            left_epoch, notice_to_drained, float(pd.get("notice_s", 0.0)),
            "met" if deadline_met else "MISSED", trigger)
        outage = {f"outage_{k}": v for k, v in self.client.summary().items()}
        outage["outage_parks"] = float(self.parks)
        outage.update({f"policy_{m}": float(n)
                       for m, n in self.policy.decisions.items()})
        outage["policy_incidents"] = float(self.policy.incidents)
        return {
            **outage,
            "steps": float(self.steps_done),
            "final_loss": self.losses[-1] if self.losses else float("nan"),
            "world": float(world),
            "passes_trained": float(len(self.pass_steps)),
            "rescales": float(len(self.rescales)),
            "max_recovery_seconds": max(
                (r.recovery_seconds for r in self.rescales), default=0.0),
            "seconds": time.perf_counter() - t_start,
            "preempted": 1.0,
            "preempt_mode_code": float(MODE_CODES[pd["mode"]]),
            "preempt_notice_s": float(pd.get("notice_s", 0.0)),
            "notice_to_drained_seconds": round(notice_to_drained, 6),
            "preempt_deadline_met": 1.0 if deadline_met else 0.0,
            # Every consumed shard was committed by the blocking checkpoint
            # above; the evacuated shards restore peer-side. Nothing replays.
            "steps_lost": 0.0,
        }

    def _epoch_changed(self, force: bool = False) -> bool:
        """Heartbeat (rate-limited) and report whether membership moved.

        Degraded mode lives here: an unreachable coordinator is NOT an
        epoch change while the outage stays inside ``outage_budget`` —
        batches already leased keep stepping, side effects buffer. Past
        the budget it reports True so run() checkpoints durably and parks.
        """
        now = time.monotonic()
        # Push fast path: the watch stream is drained BEFORE the heartbeat
        # rate limit — this is the whole latency win (a rescale notification
        # interrupts the step loop in one RTT, not a heartbeat period).
        # Draining is a non-blocking socket read, cheap enough per step.
        if self._watch is not None and self._consume_watch():
            return self._signal_drain()
        if not force and now - self._last_heartbeat < self._hb_interval:
            return False
        self._last_heartbeat = now
        self._hb_interval = self._next_hb_interval()
        # Coalesce: every coordinator reply carries the current epoch, and
        # membership-shaped replies (piggybacked heartbeats among them) are
        # recorded by the transport. A fresh observation — made within the
        # nominal interval, so the server-side TTL was refreshed then too —
        # answers this beat without a dedicated RPC.
        lm = getattr(self.client, "last_membership", None)
        lm_at = getattr(self.client, "last_membership_at", 0.0)
        fresh_window = self.config.heartbeat_interval
        if self._watch is not None and self._watch.connected:
            # Watch healthy: epoch discovery rides the push stream, so the
            # dedicated pull only backstops TTL refresh and liveness.
            # Stretch the coalesce window (bounded — a fully idle transport
            # still pulls at stretch x cadence, well inside the default TTL
            # of ~10 intervals).
            fresh_window *= self._WATCH_PULL_STRETCH
        if not force and lm is not None and now - lm_at < fresh_window:
            reply = dict(lm)
            self.hb_coalesced += 1
            self.obs.note_coalesced_heartbeat()
            if now - lm_at >= self.config.heartbeat_interval:
                # Only the stretched window made this round coalesce: a
                # pull the watch genuinely suppressed.
                self.pulls_suppressed += 1
                self.obs.note_pull_suppressed()
        else:
            reply = self.obs.timed_heartbeat(self.client)
        self.obs.note_outage_state(self.client)
        if reply.get("unreachable"):
            self._outage_open = True
            outage = self.client.outage_seconds()
            # The policy adjudicates the incident: wait (degraded mode is
            # free while leased batches last) or escalate to checkpoint-
            # and-park. The threshold froze when the incident opened, so
            # this comparison flips at most once per incident.
            if self.policy.on_outage(outage) == PARK:
                log.warning(
                    "coordinator unreachable %.1fs (policy threshold %.1fs, "
                    "policy=%s): checkpoint-and-park", outage,
                    self.policy.frozen_threshold, self.policy.config.policy)
                self._publish_policy_state()  # buffered; lands on replay
                return self._signal_drain()
            return False
        rejoined = False
        if not reply.get("ok"):
            # We were expired (long compile stall) or the coordinator
            # restarted and forgot us: rejoin WITHOUT takeover — our leases
            # must survive the re-register (we are still training them).
            reply = self.client.register(takeover=False)
            if reply.get("unreachable"):
                self._outage_open = True
                if self.policy.on_outage(
                        self.client.outage_seconds()) == PARK:
                    return self._signal_drain()
                return False
            if not reply.get("ok") or "epoch" not in reply:
                # Repeated failure: fall back to the rendezvous path, which
                # re-registers until membership settles.
                return self._signal_drain()
            rejoined = True
        if self._outage_open or rejoined:
            self._outage_open = False
            # Reconnected (or re-registered after the coordinator forgot
            # us — an expiry, or a restart fast enough that the transport
            # retries hid the outage). A restart bumps the epoch even when
            # nobody joined or left; if world AND rank are unchanged the
            # mesh is already right — adopt the new epoch without paying a
            # rescale. Restricted to these paths: a bump_epoch with a
            # stable world is the control plane's explicit rescale nudge
            # and must still interrupt.
            if (reply["epoch"] != self._epoch
                    and int(reply.get("world", -1)) == self._world
                    and int(reply.get("rank", -2)) == self._rank):
                log.info("adopted epoch %s after outage (world/rank "
                         "unchanged)", reply["epoch"])
                self._epoch = reply["epoch"]
                return False
        if reply["epoch"] == self._epoch:
            self._rank = int(reply.get("rank", self._rank))
            return False
        return self._signal_drain()

    def _rendezvous(self) -> None:
        """Agree on (epoch, world) with every live member before building the
        mesh. The coordinator releases the sync when all current members have
        arrived at the same epoch; if membership moves mid-wait we get
        resync=True with the new epoch and retry. On timeout we proceed —
        the checkpoint is already durable and stragglers restore from it.
        An unreachable coordinator parks the rendezvous (checkpointed state
        is durable; there is nothing useful to do but wait).
        """
        attempts = 0
        while attempts < 64:
            reply = self.client.sync(
                self._epoch, timeout=self.config.rescale_barrier_timeout
            )
            if reply.get("ok"):
                self._world = max(1, reply["world"])
                return
            if reply.get("error") == "unreachable":
                # Park: does not count against the thrash bound — waiting
                # out an outage is not membership churn.
                self._adopt(self._register_blocking(takeover=False))
                continue
            attempts += 1
            if reply.get("resync"):
                self._epoch = reply["epoch"]
                self._world = max(1, reply["world"])
                continue
            if reply.get("error") == "unknown worker":
                info = self.client.register(takeover=False)
                if not info.get("ok"):
                    info = self._register_blocking(takeover=False)
                self._adopt(info)
                continue
            log.warning("rescale sync incomplete (%s); proceeding", reply)
            return
        raise RuntimeError("rendezvous thrashed: membership never settled")

    # -- mesh / state ----------------------------------------------------------

    def _build_mesh(self, world: int) -> Mesh:
        """The mesh over this process's one device, at every membership
        ``world`` (see the module docstring): the planned layout when a
        ``layout_planner`` gives one, else ``mesh_axes`` and ``data`` over
        the rest."""
        devices = [self.device]
        self.last_plan = None
        if self.layout_planner is not None:
            plan = self.layout_planner(len(devices), devices)
            if plan is not None:
                self.last_plan = plan
                return local_mesh(dict(plan.mesh_axes))
        return local_mesh(fixed_axes_mesh_spec(self.mesh_axes, len(devices)).axes)

    def _trainer_config(self) -> TrainerConfig:
        """The trainer config for the current layout (`planned_trainer_config`)."""
        return planned_trainer_config(self.config.trainer, self.last_plan)

    def _restore_or_init(self, trainer: Trainer, fresh: TrainState) -> TrainState:
        self._last_restore = {"source": "init", "bytes": 0}
        blob_step = self.ckpt.latest_step()
        if (self.ckpt_plane is not None
                and self.policy.restore_source() == "peer"):
            # Peer-first (the break-even above may demote to blob-first):
            # assemble the state from the coordinator's memory-resident
            # shards and load it into this world's state. min_step pins the
            # plane to at least the blob store's best — recovery never moves
            # training backwards.
            t0 = time.time()
            from edl_tpu_torch.ckpt_plane import state_template

            got = self.ckpt_plane.restore(
                state_template(trainer, fresh), trainer=trainer, state=fresh,
                min_step=blob_step,
            )
            if got is not None:
                state, info = got
                self.policy.note_peer_restore(time.time() - t0)
                self._last_restore = {"source": "peer",
                                      "bytes": int(info["bytes"]),
                                      # the load window peer_restore timed —
                                      # the rescale loop records it as the
                                      # `reshard` phase
                                      "reshard_start": info["reshard_start"],
                                      "reshard_end": info["reshard_end"]}
                log.info(
                    "restored step=%s from %d peer shard(s) (%d bytes in "
                    "memory, zero blob reads)",
                    info["step"], info["world_at_save"], info["bytes"])
                return state
        if blob_step is None:
            return fresh
        state = self.ckpt.restore(fresh)
        self._last_restore = {"source": "blob", "bytes": 0}
        if self.ckpt_plane is not None:
            # The fallback rung actually taken — the restores-by-source
            # audit is what proves a group death demoted cleanly.
            self.ckpt_plane.obs.restores.inc(source="blob")
        log.info("restored checkpoint step=%s", int(state.step))
        return state

    def _note_batch_avals(self, batch: Dict) -> None:
        if self._batch_avals is None:
            self._batch_avals = {k: (tuple(np.shape(v)), np.asarray(v).dtype)
                                 for k, v in batch.items()}

    def _start_warm_compile(self, trainer: Trainer, fresh: TrainState,
                            trace_id: str = ""):
        """Kick off the new world's warm-up on a daemon thread; returns
        ``join() -> warm-up seconds`` (0.0 when disabled/skipped/failed).

        Runs concurrently with the restore — the rescale drain already made
        state durable, and the warm-up's forward only reads the params it
        restores into, its output discarded. Needs the batch shapes a
        previous incarnation's first placement recorded; a cold start has
        none and pays on step 1 as before. The ``warm_compile`` span is
        recorded from the warm-up thread so its wall interval shows the
        overlap with ``restore`` on the stitched timeline.
        """
        import threading

        out = {"seconds": 0.0}
        if not self.config.warm_compile or self._batch_avals is None:
            return lambda: 0.0

        def _compile():
            t0 = time.time()
            try:
                out["seconds"] = trainer.warm_compile(fresh, self._batch_avals)
                self.tracer.record("warm_compile", t0, time.time(),
                                   trace_id=trace_id, component="worker",
                                   compile_seconds=out["seconds"],
                                   cache=trainer.last_compile_cache)
            except Exception:  # edl: noqa[EDL005] the warm-up is an optimization; a failure must degrade to paying on step 1, not kill the rescale
                self.tracer.record("warm_compile", t0, time.time(),
                                   trace_id=trace_id, component="worker",
                                   error="warm_compile_failed")
                log.warning("rescale warm-up failed; the first step pays "
                            "lazily", exc_info=True)

        t = threading.Thread(
            target=_compile, daemon=True, name="edl-warm-compile"
        )
        t.start()

        def join() -> float:
            t.join()
            return out["seconds"]

        return join

    def _dispatched(self, reader: LeaseReader, trainer: Trainer):
        """Yield ``(placed, step_fn, task, samples, place_seconds)`` per
        batch, placement pipelined per ``config.pipeline_depth``.

        The pump closure snapshots ``reader.current`` at placement time so
        per-pass step attribution follows the batch, not whatever shard the
        reader has moved on to by step time; ``place_bound`` snapshots the
        step callable for the same reason (codec widening in flight).
        """
        depth = self.config.pipeline_depth

        def place(batch):
            self._note_batch_avals(batch)
            placed, step_fn = trainer.place_bound(batch)
            return placed, step_fn, reader.current

        if depth <= 0:
            for batch in reader:
                samples = len(next(iter(batch.values())))
                t0 = time.perf_counter()
                payload = place(batch)
                yield (*payload, samples, time.perf_counter() - t0)
            return
        from edl_tpu_torch.runtime.pipeline import DevicePrefetcher

        with DevicePrefetcher(
            reader, place, depth=depth, thread_name="edl-elastic-place-pump",
            device=trainer.device,
        ) as pf:
            for item in pf:
                yield (*item.payload, item.samples, item.place_seconds)

    def _checkpoint(self, state: TrainState, block: bool = False) -> None:
        with self._beating():
            self.ckpt.save(int(state.step), state)
            if block:
                self.ckpt.wait()
            if self.ckpt_plane is not None:
                # One process holds the whole state, so one host gather
                # covers every rank's shard. Best-effort — the blob save
                # above is the durable copy.
                self.ckpt_plane.replicate_all(
                    self._trainer.full_state(state), int(state.step),
                    max(1, self._world))

    def _beating(self):
        return beating(self.client, self.config.heartbeat_interval,
                       "edl-elastic-beat")

    def _checkpoint_and_commit(
        self, state: TrainState, reader: Optional[LeaseReader], block: bool
    ) -> None:
        """Save, then complete every shard lease a DURABLE save now covers.

        Async path: ``ckpt.save`` blocks until the previous async save
        finished, so entering it proves the prior save (covering
        ``_pending_commit``) is durable — those complete now, and the shards
        consumed since become the new in-flight pending set. Blocking path:
        everything consumed so far is durable; complete it all. A kill -9
        at ANY point replays exactly the shards no durable save covers.
        """
        consumed = self._carry_consumed + (
            reader.take_consumed() if reader is not None else []
        )
        self._carry_consumed = []
        ck_t0 = time.monotonic()
        self._checkpoint(state, block=block)
        if block:
            # Only a blocking save measures durability end-to-end (an async
            # initiation returns before the bytes land) — that is exactly
            # the cost the policy's park break-even prices.
            self.policy.note_checkpoint_cost(time.monotonic() - ck_t0)
        covered = self._pending_commit
        if block:
            covered = covered + consumed
            self._pending_commit = []
        else:
            self._pending_commit = consumed
        for task in covered:
            self.client.complete_task(task)

    # -- main loop -------------------------------------------------------------

    def run(self, max_rescales: int = 32) -> Dict[str, float]:
        """Train until the task queue is exhausted, rescaling on membership
        changes. Returns summary metrics.

        With ``config.metrics_port`` set, `/metrics` + `/healthz` + `/spans`
        are served for the run's duration (``self.metrics_url`` carries the
        bound address — port 0 means ephemeral), with the coordinator's
        status counters bridged onto the same scrape.
        """
        try:
            if self.config.metrics_port is None:
                return self._run(max_rescales)
            from edl_tpu_torch.obs.bridge import CoordinatorStatusBridge
            from edl_tpu_torch.obs.http import MetricsServer

            bridge = CoordinatorStatusBridge(self.client).register()
            server = MetricsServer(port=self.config.metrics_port,
                                   tracer=self.tracer,
                                   health=self._health).start()
            self.metrics_url = server.url  # edl: noqa[EDL001] set once at startup, before the serving thread handles requests
            log.info("worker metrics at %s/metrics", server.url)
            try:
                return self._run(max_rescales)
            finally:
                bridge.unregister()
                server.stop()
        finally:
            if self._watch is not None:
                self._watch.close()

    def _health(self) -> Dict:
        return {
            "worker": self.client.worker,
            "epoch": self._epoch,
            "world": self._world,
            "rank": self._rank,
            "steps": self.steps_done,
            "rescales": len(self.rescales),
            "ft_policy": self.policy.state(),
        }

    def _run(self, max_rescales: int) -> Dict[str, float]:
        self._sync_membership()
        t_start = time.perf_counter()
        #: (drain_t0, ckpt_t0, ckpt_t1) measured while the OLD epoch was
        #: draining; recorded as spans only after rendezvous settles the NEW
        #: epoch — the rescale's trace id — so all five lifecycle phases
        #: stitch under one correlator.
        pending_drain = None
        while True:
            # Rendezvous: all members agree on (epoch, world) before meshes
            # are built — joiners arrive here too, so nobody waits on a ghost.
            self._rendezvous()
            world = self._world
            rid = rescale_trace_id(self._epoch)
            if pending_drain is not None:
                drain_t0, ck_t0, ck_t1 = pending_drain
                pending_drain = None
                # No notice triggered THIS worker's drain: the zero-length
                # marker keeps the 8-phase completeness gate unconditional
                # (a revoked peer's real preempt_drain span lands on the
                # same trace id from its side of the drain).
                self.tracer.record("preempt_drain", drain_t0, drain_t0,
                                   trace_id=rid, component="worker",
                                   notice=False)
                self.tracer.record("drain", drain_t0, ck_t0, trace_id=rid,
                                   component="worker",
                                   from_world=self._prev_world)
                self.tracer.record("checkpoint", ck_t0, ck_t1, trace_id=rid,
                                   component="worker")
            rescale_t0 = time.perf_counter()
            # The layout, the Trainer's build and the restore make no
            # coordinator call and grow with the model: beat through them.
            with self._beating():
                # Replan: the layout search (planner argmin when a layout_planner
                # is wired, the static data-only resize otherwise — recorded
                # either way so every rescale timeline carries the phase and a
                # missing planner shows up as a ~0 s replan, not a missing one).
                t_replan0 = time.time()
                mesh = self.mesh = self._build_mesh(world)
                replan_attrs: Dict = {"layout": json.dumps(dict(mesh.shape))}
                if self.last_plan is not None:
                    replan_attrs.update(
                        planned=True,
                        schedule=self.last_plan.schedule or "none",
                        microbatches=self.last_plan.microbatches,
                        modeled_step_seconds=self.last_plan.step_seconds,
                        baseline_step_seconds=self.last_plan.baseline_step_seconds,
                    )
                else:
                    replan_attrs["planned"] = False
                self.tracer.record("replan", t_replan0, time.time(),
                                   trace_id=rid, component="worker",
                                   **replan_attrs)
                codec_channel = None
                if self.config.trainer.wire_transport:
                    from edl_tpu_torch.runtime.wire import KVCodecChannel

                    # One process: in-place widening is safe,
                    # but persisting the widen floor through the coordinator means
                    # a restarted incarnation never re-learns an old overflow.
                    codec_channel = KVCodecChannel(self.client, self._epoch)
                trainer = Trainer(self.model, mesh, self._trainer_config(),
                                  device=self.device, codec_channel=codec_channel)
                self._trainer = trainer
                self.ckpt.trainer = trainer  # saves and restores go through it
                # Live re-step pricing: every completed step feeds its wall
                # seconds to the policy's EMA (train_loop cost hook).
                trainer.step_cost_cb = self.policy.note_step
                if self.profiler is not None:
                    # the first step on a fresh Trainer builds its optimizer
                    # state and allocations: keep it out of steady summaries
                    self.profiler.mark_warmup()
                # The warm-up overlaps restore: the fresh state is built once,
                # then its forward runs on a background thread while the
                # checkpoint loads into it.
                fresh = trainer.init_state()
                join_warm = self._start_warm_compile(trainer, fresh, trace_id=rid)
                t_restore0 = time.time()
                state = self._restore_or_init(trainer, fresh=fresh)
            self.tracer.record(
                "restore", t_restore0, time.time(), trace_id=rid,
                component="worker", world=world,
                source=self._last_restore["source"],
                bytes_from_peers=(self._last_restore["bytes"]
                                  if self._last_restore["source"] == "peer"
                                  else 0),
            )
            # Reshard: the window that loaded restored leaves into THIS
            # world's state. Peer restores time it explicitly
            # (ckpt_plane.recovery reports the window); a blob restore fuses
            # it into the checkpoint load and an init has nothing to move —
            # both record the zero-length marker (clamped to 1 us by the
            # tracer) so the phase appears on every rescale timeline.
            t_restore1 = time.time()
            self.tracer.record(
                "reshard",
                self._last_restore.get("reshard_start", t_restore1),
                self._last_restore.get("reshard_end", t_restore1),
                trace_id=rid, component="worker",
                source=self._last_restore["source"],
                fused=(self._last_restore["source"] == "blob"),
            )
            if self._last_restore["source"] != "peer":
                # Peer restores feed their own EMA (note_peer_restore); only
                # a blob/init-path restore prices the blob arm.
                self.policy.note_restore_cost(time.time() - t_restore0)
            compile_seconds = join_warm()
            # first_step measures mesh-ready -> first optimizer step done:
            # the residual cost the warm-up could not hide (dispatch, what
            # it could not load ahead, the first batch's lease + placement).
            mesh_ready = time.time()
            first_step_done = False
            last_ckpt_step = int(state.step)
            rescale = False
            finished = False

            while not rescale and not finished:
                reader = LeaseReader(
                    self.client,
                    self.source,
                    stop_check=self._epoch_changed,
                    defer_completion=True,
                    prefetch=self.config.prefetch,
                    soft_stop_check=lambda: self._soft_drain,
                )
                if self.profiler is not None:
                    self.profiler.start()
                try:
                    for placed, step_fn, task, samples, place_dt in \
                            self._dispatched(reader, trainer):
                        state, loss = step_fn(state, placed)
                        if self.profiler is not None:
                            self.profiler.step(samples, place_seconds=place_dt)
                        if not first_step_done:
                            first_step_done = True
                            recovery = time.perf_counter() - rescale_t0
                            self.tracer.record(
                                "first_step", mesh_ready, time.time(),
                                trace_id=rid, component="worker",
                                step=int(state.step), world=world,
                            )
                            if self.steps_done:  # a rescale, not cold start
                                self.obs.rescales.inc()
                                self.rescales.append(
                                    RescaleEvent(
                                        at_step=int(state.step),
                                        from_world=self._prev_world,
                                        to_world=world,
                                        recovery_seconds=recovery,
                                        compile_seconds=compile_seconds,
                                        compile_cache=trainer.last_compile_cache,
                                        layout={str(k): int(v) for k, v
                                                in mesh.shape.items()},
                                    )
                                )
                        self.steps_done += 1
                        self.obs.steps.inc()
                        self.losses.append(float(loss))
                        if task is not None:
                            p = split_pass(task)[1]
                            self.pass_steps[p] = self.pass_steps.get(p, 0) + 1
                        step = int(state.step)
                        if self.config.step_callback is not None:
                            self.config.step_callback(step, state)
                        if step - last_ckpt_step >= self.config.checkpoint_interval:
                            self._checkpoint_and_commit(state, reader, block=False)
                            last_ckpt_step = step
                        elif self._pending_commit and not self.ckpt.saving():
                            # The in-flight save landed: its shards are
                            # durable now — complete them immediately rather
                            # than holding leases until the next save
                            # initiation. (`done_task`, NOT `task`: the
                            # enclosing loop's `task` is live for per-pass
                            # step attribution below.)
                            for done_task in self._pending_commit:
                                self.client.complete_task(done_task)
                            self._pending_commit = []
                except WireRestartRequired as e:
                    # Multi-process wire-codec overflow (only raised on a
                    # mesh of more than one rank): the widened floor is
                    # already published, and renegotiation needs a fresh
                    # membership epoch — which an in-process rebuild cannot
                    # produce (a process group's world is fixed at init).
                    # Flush durable state and take the gang warm-restart
                    # exit, the same path a rescale takes, regardless of
                    # restart_on_rescale.
                    from edl_tpu_torch.launcher.launch import RESCALE_EXIT_CODE

                    self._carry_consumed.extend(reader.take_consumed())
                    self._checkpoint_and_commit(state, None, block=True)
                    log.warning("wire codec overflow (%s); exiting %d for "
                                "gang warm-restart", e, RESCALE_EXIT_CODE)
                    raise SystemExit(RESCALE_EXIT_CODE)

                self._carry_consumed.extend(reader.take_consumed())
                if reader.interrupted is not None:
                    rescale = True
                    # Drain starts at the SIGNAL (stop_check's interrupt
                    # decision, possibly mid-step), not at this check: the
                    # interval covers finishing the in-flight batch and
                    # winding the reader down.
                    drain_t0 = self._drain_signal_t or time.time()
                    self._drain_signal_t = 0.0
                elif reader.drained:
                    # Replay-free boundary drain (advance-notice revocation
                    # with budget): the in-flight shard completed, nothing
                    # failed back.
                    rescale = True
                    drain_t0 = self._drain_signal_t or time.time()
                    self._drain_signal_t = 0.0
                elif reader.exhausted:
                    finished = True
                else:
                    # Queue empty but leases outstanding. Some may be OUR OWN
                    # completion-lagged shards: flush them durably so the
                    # queue can actually drain (multihost's tail-flush rule),
                    # then keep polling — a peer may still fail and requeue.
                    if self._carry_consumed or self._pending_commit:
                        self._checkpoint_and_commit(state, None, block=True)
                        last_ckpt_step = int(state.step)
                    self._poll_pause()
                    if self._epoch_changed(force=True):
                        rescale = True
                        drain_t0 = self._drain_signal_t or time.time()
                        self._drain_signal_t = 0.0

            if rescale:
                # Membership changed OR the outage budget expired: make
                # state durable first. During an outage the completions
                # buffer in the outbox — this is exactly checkpoint-and-
                # park, and _register_blocking below is the park.
                ck_t0 = time.time()
                self._checkpoint_and_commit(state, None, block=True)
                ck_t1 = time.time()
                pending_drain = (drain_t0, ck_t0, ck_t1)
                if self._pending_preempt is not None:
                    # This worker is the one being revoked: finish the
                    # drain (evacuate, leave) and exit — the survivors
                    # replan and shrink under the epoch our leave bumps.
                    return self._finish_preempt_drain(
                        state, drain_t0, ck_t0, ck_t1, world, t_start)
                if self.config.restart_on_rescale:
                    from edl_tpu_torch.launcher.launch import RESCALE_EXIT_CODE

                    log.info(
                        "membership epoch moved; exiting %d for a warm "
                        "restart into the new world", RESCALE_EXIT_CODE,
                    )
                    raise SystemExit(RESCALE_EXIT_CODE)
                self._prev_world = world
                info = self.client.register(takeover=False)
                if not info.get("ok"):  # refresh observed epoch/world
                    self.parks += 1
                    self.obs.parks.inc()
                    info = self._register_blocking(takeover=False)
                self._adopt(info)
                if len(self.rescales) >= max_rescales:
                    raise RuntimeError("too many rescales; aborting")
                continue

            # Queue exhausted: final checkpoint, commit held leases, finish.
            self._checkpoint_and_commit(state, None, block=True)
            # The final commit must actually LAND (not sit buffered): wait
            # out any outage so no completed shard is lost with the process.
            while len(self.client.outbox):
                self._register_blocking(takeover=False)
                if len(self.client.outbox):
                    self.client.replay()
                if len(self.client.outbox):
                    self._poll_pause()
            total = time.perf_counter() - t_start
            if self.profiler is not None:
                prof = {f"profile_{k}": v for k, v in self.profiler.summary().items()}
            else:
                prof = {}
            if self.pass_steps:
                log.info("per-pass steps: %s", dict(sorted(self.pass_steps.items())))
            outage = {f"outage_{k}": v for k, v in self.client.summary().items()}
            outage["outage_parks"] = float(self.parks)
            outage.update({f"policy_{m}": float(n)
                           for m, n in self.policy.decisions.items()})
            outage["policy_incidents"] = float(self.policy.incidents)
            return {
                **prof,
                **outage,
                "steps": float(self.steps_done),
                "final_loss": self.losses[-1] if self.losses else float("nan"),
                "world": float(self._world),
                "passes_trained": float(len(self.pass_steps)),
                "rescales": float(len(self.rescales)),
                "max_recovery_seconds": max(
                    (r.recovery_seconds for r in self.rescales), default=0.0
                ),
                "seconds": total,
            }
