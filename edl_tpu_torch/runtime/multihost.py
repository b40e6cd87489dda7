"""Multi-process elastic training: lockstep rounds over one mesh of ranks,
the port of `edl_tpu.runtime.multihost`.

Single-process elasticity (`edl_tpu_torch.runtime.elastic.ElasticWorker`)
lets each worker lease shards independently — fine when each worker owns
its own mesh. A multi-process job is ONE mesh spanning every process (a
rank of a ``torch.distributed`` group per card, formed by
`runtime.distributed.distributed_init`), so every process must run the
same step the same number of times (each step is a collective over the
group); independent leasing would deadlock the stragglers.

Protocol (the reshape of the reference master's task queue,
`docker/paddle_k8s:26-32` — still at-least-once leases, but consumed in
lockstep):

- rank 0 is the decision-maker: each ROUND it checks the membership epoch
  and leases ``world`` shards, then broadcasts the round plan through the
  coordinator KV under an (epoch, round)-scoped key;
- every rank polls that exact key and trains its assigned shard's batches:
  each batch is this rank's slice of the global batch, which is the local
  batch times the world (`Trainer.place_batch` takes it as it is, as the
  JAX package assembles process-local data into global arrays).
  When the source exposes ``batch_count(shard)``, rank 0 publishes the
  round's step count (max over the leased shards) and every rank runs
  exactly that many steps, cycling a shorter shard's batches to pad —
  uneven shards therefore cannot desynchronize the collective step count.
  Sources without the metadata must yield identical batch counts per shard;
- tail rounds with fewer shards than ranks replicate the remainder across
  ranks (``tasks[r % len]``) so the queue drains without breaking lockstep;
- **completion lags the checkpoint**: rank 0 holds consumed shards' leases
  until a collective checkpoint covers them, then marks them complete. An
  interrupted incarnation therefore replays exactly the shards whose
  updates the restored checkpoint lacks (true at-least-once — the same
  guarantee the reference gets from pserver-held state + lease requeue);
- on an epoch change (or a poll timeout — e.g. rank 0 died) every rank
  exits ``RESCALE_EXIT_CODE`` WITHOUT saving: a collective save cannot
  complete if any peer is already gone, and the completion lag makes the
  last periodic checkpoint a consistent restore point. The pod launcher
  warm-restarts the entry, which re-runs ``distributed_init`` (a process
  group's world is fixed at init; re-forming one in place is not done
  here, as the JAX package does not) and comes back at the new world size,
  restoring the whole tensors of the checkpoint into its shards
  (`Checkpointer(trainer=)`).

What the port leaves out raises ``NotImplementedError`` naming its
ROADMAP.md item (`elastic.check_unported`): ``layout_planner``,
``profiler=``, ``compile_cache_dir`` and axes other than ``data`` above 1
(item 9: the mesh Trainer trains such meshes; the rounds do not yet give
their model-parallel peers the same shard).
"""

from __future__ import annotations

import json
import logging
import random
import time
from typing import Dict, List, Optional

import torch.distributed as dist

from edl_tpu_torch.coordinator.client import CoordinatorAuthError, CoordinatorError
from edl_tpu_torch.coordinator.outbox import OutboxClient
from edl_tpu_torch.coordinator.watch import make_epoch_watch
from edl_tpu_torch.device import DeviceLike, resolve_device
from edl_tpu_torch.models.base import Model
from edl_tpu_torch.obs.instruments import PreemptInstruments, WorkerInstruments
from edl_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh, local_mesh
from edl_tpu_torch.runtime.checkpoint import Checkpointer
from edl_tpu_torch.runtime.elastic import ElasticConfig, check_unported
from edl_tpu_torch.runtime.ft_policy import (
    RIDE_OUT, WARM_RESTART, FTPolicy, FTPolicyConfig,
)
from edl_tpu_torch.runtime.train_loop import Trainer, TrainState

log = logging.getLogger("edl_tpu_torch.runtime.multihost")

#: KV key template for round plans; epoch-scoping keeps incarnations apart.
ROUND_KEY = "edl/mh_round/{epoch}/{round}"


class MultiHostWorker:
    """One process's share of a lockstep multi-host elastic job.

    Requires the default process group to be formed first
    (`edl_tpu_torch.runtime.distributed.distributed_init`); ranks here are
    ``torch.distributed.get_rank()``, which distributed_init derived from
    the same coordinator registration this worker holds. ``device`` is this
    rank's card (default the current CUDA device).

    Sizing note: uncommitted leases are not renewed, so if a checkpoint
    interval takes longer than the coordinator's task-lease time (16 s
    default) some shards expire, requeue, and train twice before their
    re-lease commits — correct (at-least-once) but wasteful. Pick
    ``checkpoint_interval`` so an interval's wall time stays under the
    lease time, or raise ``--task-lease-sec``.
    """

    def __init__(
        self,
        model: Model,
        client,
        source,  # object with .read(shard) -> Iterator[host batch]
        config: ElasticConfig,
        device: DeviceLike = None,
        mesh_axes: Optional[Dict[str, int]] = None,
        profiler=None,
        layout_planner=None,
    ):
        if not config.checkpoint_dir:
            raise ValueError("ElasticConfig.checkpoint_dir is required")
        check_unported(config, mesh_axes, profiler, layout_planner)
        self.model = model
        self.device = resolve_device(device)
        # Degraded-mode facade: a coordinator outage buffers completions
        # (rank 0's checkpoint commits) instead of killing the gang; the
        # round machinery below holds the gang on the current round while
        # the outage lasts, up to ``config.outage_budget``.
        if not isinstance(client, OutboxClient):
            client = OutboxClient(client)
        self.client = client
        self.source = source
        self.config = config
        self.mesh_axes = mesh_axes  # size-1 axes only (check_unported)
        #: same metric families as ElasticWorker — dashboards don't care
        #: which worker flavor a pod runs.
        self.obs = WorkerInstruments()
        #: per-incident recovery selector. The escalation terminal for a
        #: lockstep gang is the warm restart (one process cannot park
        #: alone: peers would hang in the next collective); the wait/
        #: reconnect half of the ladder is identical to ElasticWorker's.
        self.policy = FTPolicy(
            config.ft_policy if config.ft_policy is not None
            else FTPolicyConfig(policy=config.policy,
                                outage_budget=config.outage_budget),
            worker=self.client.worker,
        )

        def _outage_closed(duration: float) -> None:
            self.obs.outage_duration.observe(duration)
            self.policy.note_outage_closed(duration)

        self.client.on_outage_close = _outage_closed
        #: rank-collective checkpoints through the Trainer of this
        #: incarnation (set in ``_run``): rank 0 writes whole tensors
        self.ckpt = Checkpointer(config.checkpoint_dir)
        #: this incarnation's mesh, once ``run`` has built it (a
        #: step_callback such as a `PeriodicExporter` reads it)
        self.mesh: Optional[Mesh] = None
        #: memory-resident checkpoint plane (None when disabled). Each
        #: process replicates exactly its own rank's ZeRO slice — the
        #: plane's owner set IS the gang.
        if config.peer_replicas > 0:
            from edl_tpu_torch.ckpt_plane import CkptPlane

            self.ckpt_plane: Optional[CkptPlane] = CkptPlane(
                self.client, replicas=config.peer_replicas)
        else:
            self.ckpt_plane = None
        self.steps_done = 0
        self.losses: List[float] = []
        #: rank 0 only: shards consumed since the last durable checkpoint —
        #: their leases are held open until a checkpoint covers them.
        self._uncommitted: List[str] = []
        #: rank 0 only: shards that produced a zero-step round once already
        #: (no-metadata path). First zero-observation requeues the shard —
        #: rank 0 cannot know whether OTHER ranks trained it; a second zero
        #: round completes it as genuinely empty (no livelock).
        self._zero_seen: set = set()
        #: rank 0 only: published round-plan indices not yet GC'd, and the
        #: last round known to have contained a collective (training step or
        #: checkpoint). A collective in round R proves every rank consumed
        #: plans <= R, so GC'ing only up to that high-water mark can never
        #: delete a plan a straggler still needs (the round-plan GC race).
        self._plan_rounds: List[int] = []
        self._collective_hwm: int = -1
        #: seeded per-worker jitter stream: heartbeat/backoff cadence draws
        #: from it so a gang of 10k processes sharing one config template
        #: de-correlates instead of hammering the coordinator in phase
        #: (same scheme as ElasticWorker — see elastic.heartbeat_schedule).
        self._hb_rng = random.Random(f"edl-hb:{self.client.worker}")  # edl: noqa[EDL008] control-plane timing jitter, never touches model/optimizer state
        self._next_hb = 0.0
        #: heartbeats satisfied from a piggybacked membership observation.
        self.hb_coalesced = 0
        raw = getattr(self.client, "client", self.client)
        if getattr(raw, "piggyback_heartbeat", None) == 0.0:
            raw.piggyback_heartbeat = config.heartbeat_interval
        #: push-based epoch discovery (same knob/semantics as ElasticWorker):
        #: a notified epoch move is latched and consumed at the next round
        #: boundary — a lockstep gang cannot react mid-collective.
        self._watch = make_epoch_watch(self.client, config.epoch_discovery)
        if config.epoch_discovery == "watch" and self._watch is None:
            raise ValueError(
                "epoch_discovery='watch' but the transport exposes neither "
                "a wire endpoint nor a call surface to subscribe on")
        self._epoch = -1
        self._watch_moved = False
        #: advance-notice revocation (spot reclaim / straggler eviction):
        #: a pushed preempt frame latches here and is consumed at the next
        #: round boundary — same rule as epoch moves, a lockstep gang
        #: cannot abandon a collective mid-flight.
        self.preempt_obs = PreemptInstruments()
        self._preempt_notice: Optional[Dict] = None
        #: dedicated pull rounds skipped because a healthy watch already
        #: covered epoch discovery (mirrors the metric family).
        self.pulls_suppressed = 0

    # -- plumbing --------------------------------------------------------------

    def _jittered(self, base: float) -> float:
        """``base`` ± config.heartbeat_jitter fraction, from the seeded
        per-worker stream."""
        j = getattr(self.config, "heartbeat_jitter", 0.0)
        return max(0.0, base * (1.0 + j * (2.0 * self._hb_rng.random() - 1.0)))

    def _hb_sleep(self) -> None:
        """Outage/backoff pause at heartbeat cadence, jittered so retry
        storms from a whole gang spread out instead of arriving in waves."""
        time.sleep(self._jittered(
            min(1.0, max(0.1, self.config.heartbeat_interval))))

    def _maybe_heartbeat(self) -> None:
        """Beat at the jittered heartbeat interval — not per poll iteration.

        The poll loop spins at 20 Hz per rank; heartbeating every spin is
        what melts the control plane at 10k workers. TTL refresh needs one
        beat per ``heartbeat_interval``, and with reply piggybacking on the
        kv_get polls even that usually coalesces away (the transport records
        the membership observation; we just consume it).
        """
        self._consume_watch()  # non-blocking drain; latches epoch moves
        now = time.monotonic()
        if now < self._next_hb:
            return
        self._next_hb = now + self._jittered(self.config.heartbeat_interval)
        lm = getattr(self.client, "last_membership", None)
        lm_at = getattr(self.client, "last_membership_at", 0.0)
        fresh_window = self.config.heartbeat_interval
        if self._watch is not None and self._watch.connected:
            # Watch healthy: epoch discovery rides the push stream, so the
            # dedicated pull only backstops TTL refresh and liveness
            # (same stretch as ElasticWorker._WATCH_PULL_STRETCH).
            fresh_window *= 3.0
        if lm is not None and now - lm_at < fresh_window:
            self.hb_coalesced += 1
            self.obs.note_coalesced_heartbeat()
            if now - lm_at >= self.config.heartbeat_interval:
                self.pulls_suppressed += 1
                self.obs.note_pull_suppressed()
            return
        self.obs.timed_heartbeat(self.client)  # fails soft under OutboxClient
        self.obs.note_outage_state(self.client)

    def _consume_watch(self) -> bool:
        """Drain pushed epoch notifications and latch whether one names an
        epoch beyond the adopted one. The latch (not the transient poll
        result) is what round boundaries consult — a notification that
        arrives mid-round must still trigger the restart decision at the
        NEXT boundary check."""
        if self._watch is None:
            return self._watch_moved
        now = time.monotonic()
        for ep, arrived in self._watch.poll():
            self.obs.note_epoch_notify(now - arrived)
            if ep > self._epoch:
                self._watch_moved = True
        take = getattr(self._watch, "take_preempts", None)
        if callable(take):
            for notice in take():
                self._handle_preempt(notice)
        return self._watch_moved

    def _handle_preempt(self, notice: Dict) -> None:
        """Run the notice-budget decision and latch non-ride-out verdicts
        for the next round boundary. The latch keeps the EARLIEST deadline
        if notices stack (a re-pushed notice never extends the first)."""
        remaining = notice["deadline"] - time.monotonic()
        self.preempt_obs.notices.inc(reason=notice.get("reason", "preempt"))
        self.preempt_obs.notice_remaining.set(remaining)
        mode = self.policy.on_preempt_notice(remaining)
        log.warning(
            "preempt notice: %.1fs remaining (reason=%s seq=%s) -> %s",
            remaining, notice.get("reason"), notice.get("seq"), mode)
        if mode == RIDE_OUT:
            return
        if self._preempt_notice is None or \
                notice["deadline"] < self._preempt_notice["deadline"]:
            self._preempt_notice = {**notice, "mode": mode}

    def _build_mesh(self, world: int) -> Mesh:
        """The mesh of ranks: ``mesh_axes``' size-1 axes and ``data`` over
        the whole world (every rank calls it: it creates the groups). With
        no process group, one process's local mesh (as the JAX worker runs
        at ``jax.process_count() == 1``)."""
        axes = {a: 1 for a in (self.mesh_axes or {}) if a != "data"}
        if not dist.is_initialized():
            axes["data"] = 1
            return local_mesh(axes)
        axes["data"] = world
        return build_mesh(MeshSpec(axes))

    def _restore_or_init(self, trainer: Trainer) -> TrainState:
        """Collective: every rank restores the same step into its shards."""
        fresh = trainer.init_state()
        blob_step = self.ckpt.latest_step()
        if (self.ckpt_plane is not None
                and self.policy.restore_source() == "peer"):
            t0 = time.monotonic()
            from edl_tpu_torch.ckpt_plane import state_template

            got = self.ckpt_plane.restore(
                state_template(trainer, fresh), trainer=trainer, state=fresh,
                min_step=blob_step,
            )
            if got is not None:
                state, info = got
                self.policy.note_peer_restore(time.monotonic() - t0)
                log.info(
                    "restored step=%s from %d peer shard(s) onto %d-process "
                    "mesh (%d bytes in memory, zero blob reads)",
                    info["step"], info["world_at_save"], trainer.mesh.world,
                    info["bytes"])
                return state
        if blob_step is None:
            return fresh
        state = self.ckpt.restore(fresh)
        if self.ckpt_plane is not None:
            self.ckpt_plane.obs.restores.inc(source="blob")
        log.info("restored step=%s onto %d-process mesh",
                 int(state.step), trainer.mesh.world)
        return state

    def _exit_for_restart(self) -> None:
        """No save here: a collective save hangs if any peer is gone,
        and completion lag guarantees the last periodic checkpoint is a
        consistent restore point (uncommitted shards' leases expire and
        requeue for replay)."""
        from edl_tpu_torch.launcher.launch import RESCALE_EXIT_CODE

        log.info("epoch moved; exiting %d for warm restart", RESCALE_EXIT_CODE)
        raise SystemExit(RESCALE_EXIT_CODE)

    # -- round plan exchange ---------------------------------------------------

    def _publish_round(self, epoch: int, rnd: int, world: int) -> dict:
        """Rank 0: lease up to ``world`` shards and broadcast the plan.

        Emits ``{"ckpt": true}`` instead of shards when the uncommitted
        backlog must be made durable first — either the queue drained down
        to our own held leases (flush before declaring exhausted) or the
        periodic interval elapsed."""
        if self._consume_watch():
            # A pushed notification already told us membership moved — skip
            # the discovery RPC and head straight to the warm restart. The
            # stop is still published: a peer that left on SIGTERM polls
            # this round with its watch off.
            log.info("round %d: epoch moved (watch push); gang restart", rnd)
            msg = {"stop": "rescale"}
            self.client.kv_put(ROUND_KEY.format(epoch=epoch, round=rnd), json.dumps(msg))
            return msg
        hb = self.client.heartbeat()
        while not hb.get("ok") and hb.get("unreachable"):
            # Coordinator outage: hold the gang on this round. Peers polling
            # this round's key stall on the same signal (their kv_get raises),
            # so lockstep holds; past the budget the whole gang warm-restarts
            # and the completion lag replays anything uncovered.
            if self.policy.on_outage(
                    self.client.outage_seconds(),
                    escalate_mode=WARM_RESTART) == WARM_RESTART:
                log.warning(
                    "coordinator outage %.1fs over policy threshold %.1fs; "
                    "gang restart", self.client.outage_seconds(),
                    self.policy.frozen_threshold)
                return {"stop": "rescale"}
            self._hb_sleep()
            hb = self.client.heartbeat()
        if not hb.get("ok"):
            hb = self.client.register()
            if not hb.get("ok") or "epoch" not in hb:
                # Could not rejoin (membership thrash / unknown state):
                # warm-restart rather than guessing an epoch.
                return {"stop": "rescale"}
        if int(hb["epoch"]) != epoch:
            msg = {"stop": "rescale"}
        else:
            tasks: List[str] = []
            counts: Dict[str, int] = {}
            has_meta = hasattr(self.source, "batch_count")
            while len(tasks) < world:
                task = self.client.acquire_task()
                if task is None:
                    break
                if has_meta:
                    n = int(self.source.batch_count(task))
                    if n <= 0:
                        # Empty shard: no data to train, nothing a checkpoint
                        # must cover — complete it here so it never enters a
                        # plan (a zero-step round would have no collective and
                        # would reopen the GC race). Logged loudly because if
                        # the metadata UNDER-reported, this is the moment the
                        # shard's data would be silently dropped.
                        log.warning(
                            "shard %r has batch_count 0; completing untrained",
                            task,
                        )
                        self.client.complete_task(task)
                        continue
                    counts[task] = n
                tasks.append(task)
            if not tasks:
                try:
                    st = self.client.status()
                except CoordinatorAuthError:
                    raise
                except CoordinatorError:
                    # Outage mid-probe: "wait" is the safe verdict — never
                    # declare exhaustion on missing information.
                    st = {"queued": -1, "leased": -1}
                queued = int(st.get("queued", 0))
                leased = int(st.get("leased", 0))
                if self._uncommitted:
                    # Tail flush: checkpoint, then complete our held leases.
                    msg = {"ckpt": True}
                elif queued == 0 and leased == 0:
                    msg = {"stop": "exhausted"}
                else:
                    # Another incarnation's lease has not expired yet.
                    msg = {"stop": "wait"}
            else:
                msg = {"tasks": tasks}
                if has_meta:
                    # Lockstep step count for the round: max over the leased
                    # shards; shorter shards pad by cycling (no data dropped).
                    msg["steps"] = max(counts.values())
        self.client.kv_put(ROUND_KEY.format(epoch=epoch, round=rnd), json.dumps(msg))
        self._plan_rounds.append(rnd)
        # GC old plans, but only up to the last collective round: a collective
        # in round R is proof every rank already consumed plans <= R. Deleting
        # anything newer races stragglers on wait-rounds (no barrier there) —
        # a delayed rank would poll a dead key for rescale_barrier_timeout and
        # falsely conclude rank 0 died.
        keep: List[int] = []
        for r in self._plan_rounds:
            if r <= self._collective_hwm and r < rnd:
                try:
                    self.client.kv_del(ROUND_KEY.format(epoch=epoch, round=r))
                except CoordinatorAuthError:
                    raise
                except CoordinatorError:
                    keep.append(r)  # GC is best-effort; retry next round
            else:
                keep.append(r)
        self._plan_rounds = keep
        return msg

    def _poll_round(self, epoch: int, rnd: int, timeout: float,
                    watch: bool = True) -> dict:
        """Ranks > 0: block on the round key; a timeout means rank 0 is gone
        (or membership is thrashing) — treat as a rescale. ``watch=False``
        (a rank that left the membership itself) waits for the plan without
        taking its own epoch move as a stop.

        A coordinator outage is NOT rank-0 death: while the transport keeps
        failing, the liveness deadline is suspended and the wait is governed
        by ``outage_budget`` instead. When the coordinator answers again the
        deadline restarts fresh — rank 0 rode the same outage and gets a
        full window to publish."""
        key = ROUND_KEY.format(epoch=epoch, round=rnd)
        deadline = time.monotonic() + timeout
        down_since = None
        while True:
            try:
                raw = self.client.kv_get(key)
            except CoordinatorAuthError:
                raise
            except CoordinatorError:
                if down_since is None:
                    down_since = time.monotonic()
                if self.policy.on_outage(
                        time.monotonic() - down_since,
                        escalate_mode=WARM_RESTART) == WARM_RESTART:
                    log.warning(
                        "round %d: coordinator outage over policy threshold "
                        "%.1fs; assuming rescale", rnd,
                        self.policy.frozen_threshold)
                    return {"stop": "rescale"}
                self._hb_sleep()
                continue
            if down_since is not None:
                # kv_get is a passthrough (no outbox accounting), so close
                # the incident here unless a guarded call's on_outage_close
                # callback already did.
                if self.policy.incident_open:
                    duration = time.monotonic() - down_since
                    self.obs.outage_duration.observe(duration)
                    self.policy.note_outage_closed(duration)
                down_since = None
                deadline = time.monotonic() + timeout
            if raw:
                return json.loads(raw)
            if time.monotonic() >= deadline:
                break
            self._maybe_heartbeat()
            if watch and self._consume_watch():
                # Round boundary (no collective in flight): a pushed epoch
                # move means this plan will never arrive from the old gang.
                log.info("round %d: epoch moved (watch push); rescale", rnd)
                return {"stop": "rescale"}
            time.sleep(0.05)
        log.warning("round %d plan never arrived; assuming rescale", rnd)
        return {"stop": "rescale"}

    def _padded_batches(self, shard: str, tasks: List[str], steps: int):
        """Yield exactly ``steps`` batches for a lockstep round.

        Cycles the rank's own shard to pad when it is shorter than the
        round's published step count. If the shard yields nothing at all
        (metadata said it wouldn't — publish-time filtering keeps genuinely
        empty shards out of plans), falls back to the OTHER shards in the
        same plan (every rank knows the full task list), mirroring how tail
        rounds already replicate shards across ranks. Only if every shard in
        the plan is unreadable does the rank exit for a gang warm-restart.
        """
        candidates = [shard] + [t for t in tasks if t != shard]
        idx = 0
        produced_this_pass = 0
        emitted = 0
        it = iter(self.source.read(candidates[0]))
        while emitted < steps:
            try:
                batch = next(it)
            except StopIteration:
                if produced_this_pass == 0:
                    idx += 1  # shard unreadable: try a peer's shard
                    if idx >= len(candidates):
                        log.error(
                            "no shard in round plan %s yielded batches but "
                            "plan says %d steps; exiting for restart",
                            tasks, steps,
                        )
                        self._exit_for_restart()
                    log.warning(
                        "shard %r yielded no batches; padding from %r",
                        shard, candidates[idx],
                    )
                produced_this_pass = 0
                it = iter(self.source.read(candidates[idx]))
                continue
            produced_this_pass += 1
            emitted += 1
            yield batch

    # -- main loop -------------------------------------------------------------

    def _graceful_leave(self) -> None:
        """Pod-termination drain (scale-down / preemption): requeue the
        trained-but-uncovered shards immediately (their checkpoint never
        landed — TTL expiry would replay them anyway, just minutes later),
        deregister so the epoch bumps for survivors NOW, and exit 0.
        The reference's analog is free: trainer death just stops gradient
        pushes and the master re-leases its tasks; an SPMD gang must leave
        at a round boundary so no peer is abandoned mid-collective."""
        self._leave()
        raise SystemExit(0)

    def _leave(self) -> None:
        """`_graceful_leave` without the exit: requeue and deregister."""
        log.info("drain: requeueing %d uncovered shards, leaving",
                 len(self._uncommitted))
        consecutive_failures = 0
        for task in self._uncommitted:
            try:
                self.client.fail_task(task)
                consecutive_failures = 0
            except Exception:  # edl: noqa[EDL005] CoordinatorError wraps all
                # transport failures, so one exception can't distinguish a
                # transient hiccup (keep draining) from a dead coordinator
                # (every further call burns a full reconnect timeout inside
                # the pod's termination grace). Two in a row = gone; TTL
                # expiry covers whatever this drain didn't requeue.
                consecutive_failures += 1
                if consecutive_failures >= 2:
                    break
        self._uncommitted.clear()
        try:
            self.client.leave()
        except Exception:  # edl: noqa[EDL005] best-effort leave inside the SIGTERM grace window; membership TTL expires us anyway
            pass

    def _preempt_leave(self, state: TrainState, rank: int,
                       world: int) -> None:
        """The revoked rank's round-boundary exit. One process of an SPMD
        gang cannot checkpoint collectively alone, so the drain here is:
        ban this rank from the plane's replica rings, requeue the uncovered
        shards for replay, and leave — `_graceful_leave`, the identical
        SIGTERM path.
        Requeued shards ARE the steps-lost accounting (at-least-once: they
        retrain on survivors)."""
        pd = self._preempt_notice
        self._preempt_notice = None
        assert pd is not None
        if self.ckpt_plane is not None:
            # Placement override: this rank never again appears in a
            # replica ring. Its slice is NOT re-pushed here: the plane's
            # blobs are cut from the whole state, which one rank of the gang
            # cannot gather alone (`Trainer.full_state` is collective); the
            # last checkpoint's replicate already put it on its ring peers.
            self.ckpt_plane.set_revoked([rank])
        drained_mono = time.monotonic()
        notice_to_drained = drained_mono - pd["arrival"]
        self.preempt_obs.notice_to_drained.observe(notice_to_drained)
        trigger = ("straggler" if pd.get("reason") == "straggler"
                   else "revocation")
        self.preempt_obs.evictions.inc(trigger=trigger)
        if self._uncommitted:
            self.preempt_obs.steps_lost.inc(len(self._uncommitted))
        log.warning(
            "preempt drain at round boundary: %.2fs of %.1fs notice used "
            "(deadline %s, trigger=%s, %d shards requeue)",
            notice_to_drained, float(pd.get("notice_s", 0.0)),
            "met" if drained_mono <= pd["deadline"] else "MISSED",
            trigger, len(self._uncommitted))
        self._graceful_leave()

    def run(self, max_rounds: int = 1_000_000) -> Dict[str, float]:
        import signal

        from edl_tpu_torch.runtime.signals import main_thread_signal

        self._drain_requested = False

        def _on_term(signum, frame):
            self._drain_requested = True

        # SIGTERM -> drain at the next round boundary (no-op install off
        # the main thread — pytest drives workers from threads too).
        with main_thread_signal(signal.SIGTERM, _on_term):
            try:
                return self._run(max_rounds)
            finally:
                if self._watch is not None:
                    self._watch.close()

    def _run(self, max_rounds: int) -> Dict[str, float]:
        grouped = dist.is_initialized()
        rank = dist.get_rank() if grouped else 0
        world = dist.get_world_size() if grouped else 1
        # Incarnation boundary: a warm-restarted worker's predecessor may
        # still hold leases under this pod name; requeue them for replay.
        # A coordinator outage at startup (e.g. it is mid-restart under the
        # supervisor) is ridden out up to the outage budget.
        info = self.client.register(takeover=True)
        while not info.get("ok"):
            if not info.get("unreachable") or (
                    self.policy.on_outage(self.client.outage_seconds(),
                                          escalate_mode=WARM_RESTART)
                    == WARM_RESTART):
                self._exit_for_restart()
            self._hb_sleep()
            info = self.client.register(takeover=True)
        epoch = int(info["epoch"])
        self._epoch = epoch
        self.obs.note_epoch(epoch)
        if self._watch is not None:
            # Prime the resume cursor with the adopted epoch (it must not
            # replay as a notification), then subscribe; failure is soft —
            # poll() retries with backoff, the pull cadence covers the gap.
            self._watch.last_epoch = max(self._watch.last_epoch, epoch)
            self._watch.subscribe()
        if self.ckpt_plane is not None:
            # Every rank publishes the identical epoch-scoped placement map
            # (idempotent kv_put) and invalidates its previous epoch's key.
            self.ckpt_plane.on_epoch(epoch, world, rank)

        mesh = self.mesh = self._build_mesh(world)
        codec_channel = None
        if self.config.trainer.wire_transport:
            from edl_tpu_torch.runtime.wire import KVCodecChannel

            # Epoch-scoped: a rescale's new incarnation renegotiates the
            # codec from scratch (possibly under a new rank 0) while the
            # widen floor persists across epochs.
            codec_channel = KVCodecChannel(self.client, epoch)
        trainer = Trainer(self.model, mesh, self.config.trainer,
                          device=self.device, codec_channel=codec_channel)
        self.ckpt.trainer = trainer
        # Live re-step pricing for the policy's park break-even
        # (train_loop cost hook).
        trainer.step_cost_cb = self.policy.note_step
        t_restore0 = time.monotonic()
        state = self._restore_or_init(trainer)
        self.policy.note_restore_cost(time.monotonic() - t_restore0)
        last_ckpt_step = int(state.step)
        t_start = time.perf_counter()

        def checkpoint_and_commit() -> None:
            """Collective save (all ranks reach this in the same round), then
            rank 0 completes the shards that checkpoint now covers."""
            nonlocal last_ckpt_step
            ck_t0 = time.monotonic()
            self.ckpt.save(int(state.step), state)
            self.ckpt.wait()
            if grouped:
                # The save is the round's barrier (the plan GC relies on it),
                # but its gather issues no collective when nothing is
                # sharded: make it one, as the JAX package's save is.
                dist.barrier()
            self.policy.note_checkpoint_cost(time.monotonic() - ck_t0)
            if self.ckpt_plane is not None:
                # Each process pushes its OWN rank's ZeRO slice — the plane
                # covers the gang when every rank's put lands. Best-effort.
                self.ckpt_plane.replicate(trainer.full_state(state),
                                          int(state.step), rank, world)
            last_ckpt_step = int(state.step)
            if rank == 0:
                for t in self._uncommitted:
                    self.client.complete_task(t)
                self._uncommitted.clear()

        #: a rank > 0 that left the membership on SIGTERM and runs out the
        #: plan rank 0 may already have published
        leaving = False
        for rnd in range(max_rounds):
            if self._drain_requested and not leaving:
                if rank == 0:
                    # Round boundary, and rank 0 has not published this
                    # round: no collective in flight that a peer could be
                    # abandoned in — safe to go.
                    self._graceful_leave()
                # A peer cannot know whether rank 0 already published this
                # round's plan: if it did, rank 0 waits in the round's
                # collectives for this rank. So leave the membership first
                # (the epoch moves), then run out whatever plan is
                # published; rank 0's next publish sees the move and stops
                # the gang, and this rank exits 0 at that stop.
                self._leave()
                leaving = True
            if self._preempt_notice is not None:
                # Advance-notice revocation: same round-boundary exit as
                # SIGTERM, plus shard evacuation while the notice lasts.
                self._preempt_leave(state, rank, world)
            if rank == 0:
                msg = self._publish_round(epoch, rnd, world)
            else:
                msg = self._poll_round(
                    epoch, rnd, timeout=self.config.rescale_barrier_timeout,
                    watch=not leaving,
                )

            stop = msg.get("stop")
            if stop == "rescale":
                if leaving:
                    raise SystemExit(0)
                self._exit_for_restart()
            if stop == "exhausted":
                break
            if stop == "wait":
                # Queue empty but leases outstanding (e.g. a previous
                # incarnation's lease has not expired yet): idle this round,
                # jittered so a whole gang's wait-round re-polls don't land
                # on the coordinator in phase-locked waves.
                time.sleep(self._jittered(0.2))
                continue
            if msg.get("ckpt"):
                checkpoint_and_commit()
                if rank == 0:
                    self._collective_hwm = rnd  # the save is a barrier
                continue

            tasks = msg["tasks"]
            shard = tasks[rank % len(tasks)]  # tail rounds replicate remainder
            ran_steps = 0

            def _train_one(placed, step_fn) -> None:
                nonlocal state, ran_steps
                state, loss = step_fn(state, placed)
                ran_steps += 1
                self.steps_done += 1
                self.obs.steps.inc()
                self.losses.append(float(loss))
                if self.config.step_callback is not None:
                    self.config.step_callback(int(state.step), state)

            from edl_tpu_torch.runtime.data import prefetch_iter
            from edl_tpu_torch.runtime.pipeline import DevicePrefetcher
            from edl_tpu_torch.runtime.wire import WireRestartRequired

            steps = msg.get("steps")
            depth = self.config.pipeline_depth
            try:
                if steps is None:
                    # No batch_count metadata: shards must align by construction.
                    batches = self.source.read(shard)
                else:
                    # Run exactly `steps` collective steps; cycle a shorter
                    # shard's batches so every rank stays in lockstep.
                    batches = self._padded_batches(shard, tasks, steps)
                if depth > 0:
                    # Placement pump: wire encode + local-slice assembly of
                    # batch N+1 overlap the collective step N. The pump pulls
                    # from the source itself, so it subsumes `prefetch`'s
                    # read-ahead; exceptions — including a SystemExit from
                    # the padded-batches fallback — relay to this thread.
                    with DevicePrefetcher(
                        batches, trainer.place_bound, depth=depth,
                        thread_name="edl-mh-place-pump", device=trainer.device,
                    ) as pf:
                        for item in pf:
                            _train_one(*item.payload)
                else:
                    if self.config.prefetch:
                        # Batch-level read-ahead: shard decompression overlaps
                        # the step (exception-safe — a SystemExit from
                        # the padded-batches fallback still reaches this
                        # thread).
                        batches = prefetch_iter(batches)
                    for batch in batches:
                        _train_one(*trainer.place_bound(batch))
            except WireRestartRequired as e:
                # A batch overflowed the gang-negotiated wire codec; the
                # widened floor is already published. Same recovery as a
                # rescale: gang warm-restart, renegotiate from the floor.
                log.warning("wire codec overflow (%s); gang restart", e)
                self._exit_for_restart()
            if rank == 0 and ran_steps > 0:
                # hwm only moves when a collective actually ran this round: a
                # zero-step round has no barrier, so advancing it would reopen
                # the GC race on stragglers.
                self._uncommitted.extend(dict.fromkeys(tasks))  # dedup tail dups
                self._collective_hwm = rnd  # train steps are global collectives
            elif rank == 0:
                # Only reachable on the no-metadata path when rank 0's OWN
                # read yielded nothing. Completing on that local observation
                # alone would be at-most-once: another rank may have trained
                # updates from these shards that no checkpoint covers yet. So
                # the first zero round requeues them for replay; a shard that
                # comes back zero a SECOND time is genuinely empty (the
                # no-metadata contract says shards align by construction) and
                # completes, bounding the requeue loop.
                for t in dict.fromkeys(tasks):
                    if t in self._zero_seen:
                        log.warning(
                            "round %d: shard %r empty twice; completing", rnd, t
                        )
                        self.client.complete_task(t)
                    else:
                        log.warning(
                            "round %d: shard %r trained 0 steps; requeueing "
                            "for replay", rnd, t
                        )
                        self._zero_seen.add(t)
                        self.client.fail_task(t)
            if int(state.step) - last_ckpt_step >= self.config.checkpoint_interval:
                # Deterministic across ranks (lockstep step counter), so every
                # process enters the collective save together.
                checkpoint_and_commit()

        # drained: final collective checkpoint covers any stragglers. Plan
        # keys after the last collective round (including the terminal
        # "exhausted" plan) are deliberately NOT GC'd — a straggler may still
        # need to read them to exit; the litter is bounded by one tail's
        # worth of rounds and dies with the job's coordinator.
        checkpoint_and_commit()
        if rank == 0 and len(self.client.outbox):
            # Completions buffered during an outage that is still open at
            # drain time: give the coordinator one budget's grace to come
            # back. Giving up is safe — the final checkpoint is durable, so
            # the leases just expire and the next incarnation replays and
            # re-completes those shards (at-least-once, never lost).
            grace = time.monotonic() + self.config.outage_budget
            while len(self.client.outbox) and time.monotonic() < grace:
                if self.client.heartbeat().get("ok"):
                    self.client.replay()
                if len(self.client.outbox):
                    time.sleep(self._jittered(0.2))
            if len(self.client.outbox):
                log.warning(
                    "exiting with %d completions still buffered (coordinator "
                    "unreachable); their leases will expire and replay",
                    len(self.client.outbox))
        outage = {f"outage_{k}": v for k, v in self.client.summary().items()}
        outage.update({f"policy_{m}": float(n)
                       for m, n in self.policy.decisions.items()})
        outage["policy_incidents"] = float(self.policy.incidents)
        return {
            **outage,
            "steps": float(self.steps_done),
            "final_loss": self.losses[-1] if self.losses else float("nan"),
            "world": float(world),
            "rank": float(rank),
            "seconds": time.perf_counter() - t_start,
        }
