"""The JAX package's chaos suites on the port's `ChaosProxy`, `ChaosScenario`,
coordinator and workers.

- the 15 cases of `tests/test_coordinator_outage.py` that
  `tests/test_torch_control_plane.py` does not hold (retry policy, typed
  errors, retries through resets, dedup across a restart, the supervisor,
  `ProcessCluster` restarting a coordinator role, the `ElasticWorker`
  riding a partition and a coordinator kill; the soak stays ``slow``);
- `tests/test_chaos_preempt.py`'s revocation wave;
- `tests/test_chaos.py`'s two-job SIGKILL run, on the port's launcher and
  `tests/torch_mh_worker.py` ranks (the JAX side skips it on this image:
  its ranks need ``jax.distributed``; the port's gloo ranks run here);
- `tests/test_chaos_composed.py` (``slow``, as its original);
- the two packages side by side: the same seed and request sequence give
  the same injected faults through both proxies, and a scenario spec made
  by either package loads in the other with the same steps.

Determinism: every fault sequence comes from seeded RNGs — the
``RetryPolicy`` seed fixes the backoff jitter, the ``ChaosProxy`` seed
fixes which chunks get delayed/reset/dropped — and every scenario fault
fires on observed progress, not the clock. Every wait has a deadline.
"""

import importlib
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest

from edl_tpu_torch.coordinator import (
    CoordinatorAuthError,
    CoordinatorServer,
    CoordinatorUnreachable,
    InProcessCoordinator,
    RetryPolicy,
)
from edl_tpu_torch.coordinator.client import CoordinatorClient
from edl_tpu_torch.coordinator.server import CoordinatorSupervisor, free_port
from edl_tpu_torch.testing import ChaosProxy, ChaosScenario

from tests.test_torch_coordinator import has_toolchain

# Every outage test also rides the sanitizer lane (`make tsan-smoke`): the
# kill/restart/partition interleavings here are exactly what TSan should see.
pytestmark = [pytest.mark.chaos, pytest.mark.sanitizer]

REPO = str(Path(__file__).resolve().parents[1])
PACKAGES = {"jax": "edl_tpu", "torch": "edl_tpu_torch"}


@pytest.fixture
def native():
    """Skips the test where the native coordinator cannot be built."""
    if not has_toolchain():
        pytest.skip("native toolchain unavailable")


# -- retry policy --------------------------------------------------------------


def test_retry_policy_deterministic_and_bounded():
    a = RetryPolicy(seed=7)
    b = RetryPolicy(seed=7)
    sa, sb = a.sleeps(), b.sleeps()
    seq = [next(sa) for _ in range(8)]
    assert seq == [next(sb) for _ in range(8)]
    # jittered exponential: positive, bounded by max_backoff * (1 + jitter)
    assert all(0 < s <= a.max_backoff * (1.0 + a.jitter) for s in seq)
    # a different seed jitters differently
    sc = RetryPolicy(seed=8).sleeps()
    assert seq != [next(sc) for _ in range(8)]


def test_retry_policy_backoff_grows():
    seq = []
    gen = RetryPolicy(seed=1, jitter=0.0).sleeps()
    for _ in range(5):
        seq.append(next(gen))
    assert seq == sorted(seq)  # no jitter -> pure exponential up to the cap


# -- typed errors / fail-fast auth ---------------------------------------------


def test_unreachable_raised_after_deadline():
    dead = free_port()
    t0 = time.monotonic()
    with pytest.raises(CoordinatorUnreachable):
        CoordinatorClient(port=dead, connect_timeout=0.5,
                          retry=RetryPolicy(deadline=0.5, seed=0))
    assert time.monotonic() - t0 < 5.0


@pytest.mark.usefixtures("native")
def test_auth_error_fails_fast_no_retry():
    with CoordinatorServer(auth_token="right-secret") as server:
        c = CoordinatorClient(port=server.port, worker="w0",
                              token="wrong-secret",
                              retry=RetryPolicy(deadline=30.0, seed=0))
        t0 = time.monotonic()
        with pytest.raises(CoordinatorAuthError):
            c.register()
        # fail-fast: no backoff loop burned the 30 s retry budget
        assert time.monotonic() - t0 < 5.0
        assert c.retry_count == 0
        c.close()


@pytest.mark.usefixtures("native")
def test_barrier_and_sync_distinguish_unreachable_from_timeout():
    with CoordinatorServer() as server:
        c = server.client("w0")
        c.register()
        late = server.client("w-late")
        late.register()  # a member that never reaches the sync point
        # live coordinator, missing peers: a genuine rendezvous timeout
        assert c.barrier("b", count=2, timeout=0.4) == {
            "ok": False, "error": "timeout"}
        epoch = int(c.status()["epoch"])
        reply = c.sync(epoch, timeout=0.4)
        assert reply.get("ok") is False
        assert reply.get("error") == "timeout" or reply.get("resync"), reply
        late.close()
        c.close()
        # second client outlives the server (the `with` exit stops it)
        c2 = CoordinatorClient(port=server.port, worker="w1",
                               retry=RetryPolicy(deadline=0.5, seed=0))
        c2.register()
    # dead coordinator: transport failure must NOT masquerade as "timeout"
    assert c2.barrier("b", count=2, timeout=0.4) == {
        "ok": False, "error": "unreachable"}
    assert c2.sync(0, timeout=0.4) == {"ok": False, "error": "unreachable"}
    c2.close()


# -- chaos proxy: transport faults ---------------------------------------------


@pytest.mark.usefixtures("native")
def test_client_retries_through_proxy_resets():
    with CoordinatorServer() as server:
        with ChaosProxy(server.port, seed=11, reset_prob=0.2) as proxy:
            c = CoordinatorClient(port=proxy.port, worker="w0",
                                  retry=RetryPolicy(deadline=30.0, seed=11))
            c.register()
            for i in range(40):
                c.kv_put(f"k{i}", str(i))
            for i in range(40):
                assert c.kv_get(f"k{i}") == str(i)
            c.close()
        assert proxy.stats["resets"] > 0, proxy.stats
        assert proxy.stats["connections"] > 1  # re-dialed after resets


@pytest.mark.usefixtures("native")
def test_chaos_proxy_is_deterministic():
    """Same seed + same request sequence -> same injected fault counts."""
    stats = []
    for _ in range(2):
        with CoordinatorServer() as server:
            with ChaosProxy(server.port, seed=5, reset_prob=0.15) as proxy:
                c = CoordinatorClient(port=proxy.port, worker="w0",
                                      retry=RetryPolicy(deadline=30.0, seed=5))
                c.register()
                for i in range(25):
                    c.kv_put(f"k{i}", "v")
                c.close()
                stats.append((proxy.stats["resets"], proxy.stats["drops"]))
    assert stats[0] == stats[1], stats


# -- server-side idempotence / dedup -------------------------------------------


@pytest.mark.usefixtures("native")
def test_complete_task_idempotent_and_requeue_tolerant():
    with CoordinatorServer() as server:
        c = server.client("w0")
        c.register()
        c.add_tasks(["a", "b"])
        assert c.acquire_task() == "a"
        assert c.complete_task("a").get("ok")
        dup = c.complete_task("a")
        assert dup.get("ok") and dup.get("duplicate")
        # requeued-but-unleased: lease dropped (fail_task), completion still
        # lands — the worker only completes after a covering checkpoint
        assert c.acquire_task() == "b"
        c.fail_task("b")
        back = c.complete_task("b")
        assert back.get("ok") and back.get("requeued")
        st = c.status()
        assert int(st["done"]) == 2 and int(st["queued"]) == 0
        # a task this run never heard of is still an error
        assert not c.complete_task("never-added").get("ok")
        c.close()


@pytest.mark.usefixtures("native")
def test_acquire_req_id_dedup_returns_same_lease():
    with CoordinatorServer() as server:
        c = server.client("w0")
        c.register()
        c.add_tasks(["t0", "t1"])
        first = c.call("acquire_task", req_id="lost-reply-1")
        assert first["task"] == "t0"
        retry = c.call("acquire_task", req_id="lost-reply-1")
        assert retry["task"] == "t0" and retry.get("duplicate")
        st = c.status()
        assert int(st["leased"]) == 1, st  # no zombie second lease
        fresh = c.call("acquire_task", req_id="lost-reply-2")
        assert fresh["task"] == "t1"
        c.close()


@pytest.mark.usefixtures("native")
def test_kv_incr_op_id_dedup_survives_restart(tmp_path):
    state = str(tmp_path / "state.jsonl")
    server = CoordinatorServer(state_file=state, run_id="r1")
    server.start()
    try:
        c = server.client("w0")
        assert c.call("kv_incr", key="budget", delta=1,
                      op_id="op-1")["value"] == 1
        # same op replayed against the SAME incarnation: no double count
        rep = c.call("kv_incr", key="budget", delta=1, op_id="op-1")
        assert rep["value"] == 1 and rep.get("duplicate")
        c.close()

        server.kill()  # SIGKILL: only the journal survives
        server.restart()
        c = server.client("w0")
        # replay across the restart: the marker was journaled with the value
        rep = c.call("kv_incr", key="budget", delta=1, op_id="op-1")
        assert rep["value"] == 1 and rep.get("duplicate")
        assert c.call("kv_incr", key="budget", delta=1,
                      op_id="op-2")["value"] == 2
        c.close()
    finally:
        server.stop()


# -- supervision ---------------------------------------------------------------


@pytest.mark.usefixtures("native")
def test_supervisor_restarts_killed_coordinator(tmp_path):
    state = str(tmp_path / "state.jsonl")
    server = CoordinatorServer(state_file=state, run_id="sup")
    server.start()
    sup = CoordinatorSupervisor(server, poll_interval=0.05)
    sup.start()
    try:
        c = server.client("seed")
        c.add_tasks(["t0", "t1"])
        epoch_before = int(c.status()["epoch"])
        c.close()

        server.kill()
        deadline = time.monotonic() + 20.0
        revived = {}
        while time.monotonic() < deadline:
            try:
                probe = server.client("probe")
                revived = probe.status()
                probe.close()
                if revived.get("ok"):
                    break
            except Exception:  # edl: noqa[EDL005] probe loop: any transport error just means "not yet back"
                pass
            time.sleep(0.1)
        assert revived.get("ok"), "supervisor never brought the coordinator back"
        # journal resumed (queue intact), epoch bumped by the restart
        assert int(revived["queued"]) == 2
        assert int(revived["epoch"]) > epoch_before
        # the counter increments on the watch thread AFTER the server is
        # observably back (like k8s status lag) — poll, don't snapshot
        while sup.summary()["restarts"] < 1.0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert sup.summary()["restarts"] >= 1.0
    finally:
        sup.stop()


def test_process_cluster_restarts_failed_coordinator_role():
    from edl_tpu_torch.api.quantity import ResourceList
    from edl_tpu_torch.controller.cluster import NodeInfo
    from edl_tpu_torch.controller.process_cluster import ProcessCluster

    class W:
        entrypoint = f"{sys.executable} -c 'import time; time.sleep(600)'"
        env = {}
        workspace = ""

    cluster = ProcessCluster(
        [NodeInfo(name="n0", allocatable=ResourceList.make({"cpu": 8}))])
    try:
        one_cpu = ResourceList.make({"cpu": 1})
        cluster.create_role("job", "coordinator", 1, one_cpu, one_cpu, W())
        pods = [p for p in cluster.pods if p.info.role == "coordinator"]
        assert len(pods) == 1 and pods[0].info.phase == "Running"
        cluster.kill_pod(pods[0].info.name)
        deadline = time.monotonic() + 10.0
        while (cluster.job_pods("job", "coordinator")[0].phase != "Failed"
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert cluster.job_pods("job", "coordinator")[0].phase == "Failed"
        assert cluster.restart_failed("job", role="coordinator") == 1
        replacement = cluster.job_pods("job", "coordinator")
        assert len(replacement) == 1 and replacement[0].phase == "Running"
        assert replacement[0].name != pods[0].info.name
    finally:
        cluster.shutdown()


# -- end-to-end: elastic worker rides real outages -----------------------------


def _counting_source(model, batch_size=8, batches_per_shard=4):
    from edl_tpu_torch.runtime.data import SyntheticShardSource

    counts = {}

    class Counting(SyntheticShardSource):
        def read(self, shard):
            counts[shard] = counts.get(shard, 0) + 1
            return super().read(shard)

    return Counting(model, batch_size=batch_size,
                    batches_per_shard=batches_per_shard), counts


@pytest.mark.usefixtures("native")
def test_elastic_worker_rides_5s_partition_exactly_once(tmp_path):
    """The seeded-partition acceptance case: a 5 s network partition mid-run
    neither kills the worker nor loses/duplicates a shard — every shard
    trains exactly once, the lease ledger balances, and the outage shows up
    in the worker's telemetry."""
    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.runtime.data import shard_names
    from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker
    from edl_tpu_torch.runtime.train_loop import TrainerConfig

    model = fit_a_line.MODEL
    shards = shard_names("px", 5)
    # Leases and membership must outlive the 5 s partition: TTLs at 60 s so
    # the only thing the outage interrupts is bookkeeping.
    with CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0) as server:
        admin = server.client("admin")
        admin.add_tasks(shards)

        with ChaosProxy(server.port, seed=42) as proxy:
            raw = CoordinatorClient(port=proxy.port, worker="w0",
                                    retry=RetryPolicy(deadline=2.0, seed=42))
            source, counts = _counting_source(model)
            cfg = ElasticConfig(
                checkpoint_dir=str(tmp_path / "ck"),
                checkpoint_interval=4,          # ~one shard per commit
                heartbeat_interval=0.0,         # poll the epoch every batch
                outage_budget=60.0,
                trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05),
            )
            worker = ElasticWorker(model, raw, source, cfg,
                                   device="cpu")

            def chaos():
                while worker.steps_done < 3 and not done_flag.is_set():
                    time.sleep(0.02)
                proxy.partition()
                time.sleep(5.0)
                proxy.heal()

            done_flag = threading.Event()
            t = threading.Thread(target=chaos, daemon=True)
            t.start()
            try:
                metrics = worker.run()
            finally:
                done_flag.set()
                t.join(timeout=10)

        st = admin.status()
        admin.close()
    # ledger balanced: nothing lost, nothing leaked
    assert int(st["done"]) == len(shards)
    assert int(st["queued"]) == 0 and int(st["leased"]) == 0
    # exactly once: no shard read twice (leases outlived the partition)
    assert counts == {s: 1 for s in shards}, counts
    # the outage actually happened and was ridden out, not rescaled through
    assert metrics["outage_outages"] >= 1.0, metrics
    assert metrics["rescales"] == 0.0, metrics


@pytest.mark.usefixtures("native")
def test_elastic_worker_survives_coordinator_kill_and_restart(tmp_path):
    """The SIGKILL acceptance case: the coordinator dies mid-run and comes
    back (same state file, same run_id). The worker rides the outage on its
    retry policy, adopts the restarted coordinator's bumped epoch without a
    spurious rescale, replays buffered completions, and the job converges
    with every shard trained exactly once."""
    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.runtime.data import shard_names
    from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker
    from edl_tpu_torch.runtime.train_loop import TrainerConfig

    model = fit_a_line.MODEL
    shards = shard_names("kx", 5)
    state = str(tmp_path / "coord-state.jsonl")
    server = CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0,
                               state_file=state, run_id="killrun")
    server.start()
    try:
        admin = server.client("admin")
        admin.add_tasks(shards)
        admin.close()

        raw = CoordinatorClient(port=server.port, worker="w0",
                                retry=RetryPolicy(deadline=20.0, seed=3))
        source, counts = _counting_source(model)
        cfg = ElasticConfig(
            checkpoint_dir=str(tmp_path / "ck"),
            checkpoint_interval=4,
            heartbeat_interval=0.0,
            outage_budget=60.0,
            trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05),
        )
        worker = ElasticWorker(model, raw, source, cfg,
                               device="cpu")

        def chaos():
            while worker.steps_done < 3 and not done_flag.is_set():
                time.sleep(0.02)
            server.kill()          # SIGKILL: no graceful anything
            time.sleep(1.0)        # a real supervisor's restart latency
            server.restart()

        done_flag = threading.Event()
        t = threading.Thread(target=chaos, daemon=True)
        t.start()
        try:
            metrics = worker.run()
        finally:
            done_flag.set()
            t.join(timeout=30)

        probe = server.client("probe")
        st = probe.status()
        probe.close()
    finally:
        server.stop()
    assert int(st["done"]) == len(shards), st
    assert int(st["queued"]) == 0 and int(st["leased"]) == 0, st
    # exactly once per shard: restored leases stayed with their holder
    assert counts == {s: 1 for s in shards}, counts
    assert metrics["steps"] == float(5 * 4), metrics


# -- slow soak: sustained chaos + kill, multi-shard ----------------------------


@pytest.mark.slow
@pytest.mark.usefixtures("native")
def test_soak_sustained_chaos_with_coordinator_kill(tmp_path):
    """Sustained seeded faults (delays + resets) AND a mid-run coordinator
    SIGKILL+restart over a bigger queue. At-least-once is the floor (a reset
    can kill a connection mid-acquire before the reply lands), exactly-once
    is the expectation under lease preservation — assert the ledger and
    that no shard trained more than twice (bounded replay)."""
    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.runtime.data import shard_names
    from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker
    from edl_tpu_torch.runtime.train_loop import TrainerConfig

    model = fit_a_line.MODEL
    shards = shard_names("soak", 12)
    state = str(tmp_path / "coord-state.jsonl")
    server = CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0,
                               state_file=state, run_id="soak")
    server.start()
    try:
        admin = server.client("admin")
        admin.add_tasks(shards)
        admin.close()

        with ChaosProxy(server.port, seed=99, delay_prob=0.2,
                        delay_range=(0.005, 0.05), reset_prob=0.05) as proxy:
            raw = CoordinatorClient(port=proxy.port, worker="w0",
                                    retry=RetryPolicy(deadline=20.0, seed=99))
            source, counts = _counting_source(model)
            cfg = ElasticConfig(
                checkpoint_dir=str(tmp_path / "ck"),
                checkpoint_interval=4,
                heartbeat_interval=0.0,
                outage_budget=60.0,
                trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05),
            )
            worker = ElasticWorker(model, raw, source, cfg,
                                   device="cpu")

            def chaos():
                while worker.steps_done < 6 and not done_flag.is_set():
                    time.sleep(0.02)
                server.kill()
                time.sleep(1.5)
                server.restart()

            done_flag = threading.Event()
            t = threading.Thread(target=chaos, daemon=True)
            t.start()
            try:
                worker.run()
            finally:
                done_flag.set()
                t.join(timeout=30)
            assert proxy.stats["delays"] + proxy.stats["resets"] > 0

        probe = server.client("probe")
        st = probe.status()
        probe.close()
    finally:
        server.stop()
    assert int(st["done"]) == len(shards), st
    assert int(st["queued"]) == 0 and int(st["leased"]) == 0, st
    assert all(1 <= counts.get(s, 0) <= 2 for s in shards), counts


# -- tests/test_chaos_preempt.py: a revocation wave over two jobs --------------

N_SHARDS, BPS, BATCH = 6, 6, 16


class _WaveJob:
    """One training job: coordinator, doomed worker, follower peer."""

    def __init__(self, tag, tmp_path):
        from edl_tpu_torch.models import fit_a_line
        from edl_tpu_torch.runtime.data import shard_names

        self.tag = tag
        self.model = fit_a_line.MODEL
        self.coord = InProcessCoordinator(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
        self.admin = self.coord.client(f"admin-{tag}")
        self.admin.add_tasks(shard_names(f"wave-{tag}", N_SHARDS))
        self.workdir = tmp_path / tag
        self.doomed = self._worker("trainer-0")
        self.result = {}
        self._stop = threading.Event()
        self._threads = []

    def _worker(self, name):
        from edl_tpu_torch.runtime.data import SyntheticShardSource
        from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker

        return ElasticWorker(
            self.model, self.coord.client(name),
            SyntheticShardSource(self.model, batch_size=BATCH, batches_per_shard=BPS),
            ElasticConfig(checkpoint_dir=str(self.workdir / "ck"), checkpoint_interval=50,
                          heartbeat_interval=0.0, rescale_barrier_timeout=30.0,
                          peer_replicas=1),
            device="cpu")

    def _follow(self):
        j = self.coord.client("trainer-1")
        epoch = j.register()["epoch"]
        while not self._stop.is_set():
            reply = j.sync(epoch, timeout=5.0)
            if reply.get("ok"):
                break
            epoch = reply.get("epoch", epoch)
        while not self._stop.is_set():
            hb = j.heartbeat()
            if hb.get("ok") and hb["epoch"] != epoch:
                epoch = hb["epoch"]
                j.sync(epoch, timeout=5.0)
            time.sleep(0.02)

    def start(self):
        def run():
            self.result.update(self.doomed.run())
        for target in (self._follow, run):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def finish(self):
        # the doomed worker's run() thread ends when its drain completes.
        self._threads[1].join(timeout=120)
        assert not self._threads[1].is_alive(), f"job {self.tag} never drained"
        rest = self._worker("trainer-2").run()
        self._stop.set()
        self._threads[0].join(timeout=10)
        assert not self._threads[0].is_alive()
        return rest


def test_revocation_wave_drains_two_jobs_with_zero_steps_lost(tmp_path):
    alpha, beta = _WaveJob("alpha", tmp_path), _WaveJob("beta", tmp_path)
    sc = (ChaosScenario("revocation-wave")
          .register_coordinator("alpha", alpha.admin)
          .register_coordinator("beta", beta.admin)
          .predicate("alpha_warm", lambda: alpha.doomed.steps_done >= 3)
          .predicate("beta_warm", lambda: beta.doomed.steps_done >= 3)
          .add("alpha.revoke", when="alpha_warm", worker="trainer-0",
               notice_s=30.0, reason="spot-wave")
          .add("beta.revoke", when="beta_warm", after=0.05,
               worker="trainer-0", notice_s=30.0, reason="spot-wave"))
    # the preempt instruments live in the global registry: the wave's
    # contribution is asserted as a delta
    notices_before = alpha.doomed.preempt_obs.notices.value(reason="spot-wave")
    alpha.start()
    beta.start()
    sc.start()
    sc.join(timeout=120)
    assert sc.completed and sc.failed is None, sc.events
    assert [e["action"] for e in sc.events] == ["alpha.revoke", "beta.revoke"]
    for job in (alpha, beta):
        rest = job.finish()
        doomed = job.result
        assert doomed["preempted"] == 1.0, (job.tag, doomed)
        assert doomed["steps_lost"] == 0.0
        assert doomed["preempt_deadline_met"] == 1.0
        assert doomed["notice_to_drained_seconds"] < 30.0
        # exact accounting: the wave lost nothing and replayed nothing
        assert doomed["steps"] + rest["steps"] == N_SHARDS * BPS, job.tag
    assert alpha.doomed.preempt_obs.notices.value(reason="spot-wave") == notices_before + 2
    # the fired timeline replays from its JSON spec, the revocation kwargs intact
    replay = ChaosScenario.from_spec(sc.spec())
    assert [s.to_dict() for s in replay.steps] == [s.to_dict() for s in sc.steps]
    assert replay.steps[0].kwargs["worker"] == "trainer-0"
    assert json.loads(sc.spec())["name"] == "revocation-wave"


# -- tests/test_chaos.py: SIGKILL a pod of each of two jobs ---------------------

KILL_SHARDS = 8


def test_two_jobs_survive_random_pod_kills(native, tmp_path):
    """Two jobs of `tests/torch_mh_worker.py` ranks under the port's
    launcher on a `ProcessCluster`; once each has committed a shard, a
    running pod of each is SIGKILLed, whole process group, no drain. The
    dead member expires by TTL, `restart_failed` spawns a replacement pod
    whose worker registers under its own name, restores the durable
    checkpoint and drains the queue: every shard done exactly once."""
    from edl_tpu_torch.api.quantity import ResourceList
    from edl_tpu_torch.controller.cluster import NodeInfo
    from edl_tpu_torch.controller.jobparser import parse_to_trainer
    from edl_tpu_torch.controller.process_cluster import ProcessCluster
    from tests.test_torch_controller import _finals, _live_job, _until, _wait_drained

    rng = random.Random(0)
    names = ("alpha", "beta")
    # a short member TTL requeues the killed pod's leases soon; task leases
    # stay long (renewed by heartbeats)
    servers = {n: CoordinatorServer(task_lease_sec=120.0, heartbeat_ttl_sec=6.0)
               for n in names}
    cluster = ProcessCluster([NodeInfo(name=f"h{i}", allocatable=ResourceList.make(
        {"cpu": 16, "tpu": 4})) for i in range(2)], log_dir=str(tmp_path / "logs"))
    deadline = time.monotonic() + 120.0
    admins, killed = {}, {}
    try:
        for n in names:
            servers[n].start()
            admins[n] = servers[n].client("admin")
            admins[n].add_tasks([f"{n}/part-{i:05d}" for i in range(KILL_SHARDS)])
            # durable early (a checkpoint every 2 steps) and paced, so the
            # kill lands mid-queue with a checkpoint to restore
            trainer = parse_to_trainer(_live_job(n, 1, 1, servers[n], tmp_path,
                                                 BATCHES_PER_SHARD=4, BATCH_SLEEP=0.1,
                                                 CKPT_INTERVAL=2))
            cluster.create_role(n, "trainer", 1, trainer.requests, trainer.limits,
                                workload=trainer)
        _until(lambda: all(int(admins[n].status().get("done", 0)) >= 2 for n in names),
               deadline, "no progress on both queues", cluster)
        for n in names:
            victim = rng.choice([p for p in cluster.job_pods(n, "trainer")
                                 if p.phase == "Running"])
            cluster.kill_pod(victim.name)
            killed[n] = victim.name
        _until(lambda: all(any(p.phase == "Failed" for p in cluster.job_pods(n, "trainer"))
                           for n in names), deadline, "a killed pod never failed", cluster)
        # nothing drains while the pods are dead and unreplaced
        assert any(int(admins[n].status()["queued"]) > 0
                   or int(admins[n].status()["leased"]) > 0 for n in names)
        for n in names:
            assert cluster.restart_failed(n) == 1
        _wait_drained(cluster, deadline, "the jobs never drained after the kills")
        for n in names:
            st = admins[n].status()
            assert (int(st["queued"]), int(st["leased"]), int(st["done"])) == \
                (0, 0, KILL_SHARDS), (n, st)
            pods = cluster.job_pods(n, "trainer")
            assert len(pods) == 1 and pods[0].phase == "Succeeded", (n, pods)
            assert pods[0].name != killed[n]  # it IS the replacement
    finally:
        cluster.shutdown(grace=2.0)
        for s in servers.values():
            s.stop()
    # the replacement really trained: restored, then drained the rest
    for n in names:
        finals = _finals(tmp_path / f"{n}.jsonl")
        rep = [m for w, m in finals.items() if w != killed[n]]
        assert len(rep) == 1 and rep[0]["exit"] == 0 and rep[0]["world"] == 1 and \
            rep[0]["metrics"]["steps"] > 0, finals


# -- the two packages' proxies and scenarios side by side -----------------------


class _EchoServer:
    """A line-echo TCP server: the target both proxies relay to."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.port = self.sock.getsockname()[1]
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    @staticmethod
    def _serve(conn):
        with conn:
            f = conn.makefile("rb")
            for line in f:
                try:
                    conn.sendall(line)
                except OSError:
                    return

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept()
        except OSError:
            pass
        self.sock.close()
        self._thread.join(timeout=5)
        assert not self._thread.is_alive()


def _fault_log(pkg, port, seed, n=40):
    """``n`` sequential requests through ``pkg``'s proxy at ``seed``: each
    request's outcome (answered, or reset and re-dialled) and the stats."""
    proxy_cls = importlib.import_module(f"{PACKAGES[pkg]}.testing").ChaosProxy
    log = []
    with proxy_cls(port, seed=seed, reset_prob=0.2, delay_prob=0.2,
                   delay_range=(0.001, 0.002)) as proxy:
        conn = None
        for i in range(n):
            if conn is None:
                conn = socket.create_connection(("127.0.0.1", proxy.port), timeout=5.0)
                reader = conn.makefile("rb")
            try:
                conn.sendall(f"req-{i}\n".encode())
                reply = reader.readline()
            except OSError:
                reply = b""
            if reply == f"req-{i}\n".encode():
                log.append("ok")
            else:
                log.append("reset")
                conn.close()
                conn = None
        if conn is not None:
            conn.close()
        stats = dict(proxy.stats)
    return log, stats


@pytest.mark.parametrize("seed", [3, 5, 11, 42])
def test_both_proxies_inject_the_same_faults(seed):
    """Fault decisions come from ``random.Random`` seeded by (seed,
    connection index, direction), integers only: the JAX package's proxy
    and the port's, given the same seed and the same request sequence,
    reset the same requests and count the same faults."""
    server = _EchoServer()
    try:
        jax_side = _fault_log("jax", server.port, seed)
        port_side = _fault_log("torch", server.port, seed)
    finally:
        server.close()
    assert port_side == jax_side
    log, stats = port_side
    assert "reset" in log and "ok" in log, log  # the faults fired
    assert stats["resets"] == log.count("reset") and stats["delays"] > 0


def _scenario(pkg):
    cls = importlib.import_module(f"{PACKAGES[pkg]}.testing").ChaosScenario
    return (cls("crossing")
            .add("beta.partition", when="beta_warm", note="blip 1")
            .add("beta.heal", after=1.2)
            .add("alpha.revoke", when="alpha_warm", worker="trainer-0", notice_s=30.0,
                 reason="spot-wave")
            .add("beta.heal", when="scraped", timeout=180.0, note="storm"))


@pytest.mark.parametrize("made_by, loaded_by", [("jax", "torch"), ("torch", "jax")])
def test_a_scenario_spec_crosses_between_the_packages(made_by, loaded_by):
    made = _scenario(made_by)
    loader = importlib.import_module(f"{PACKAGES[loaded_by]}.testing").ChaosScenario
    loaded = loader.from_spec(made.spec())
    assert [s.to_dict() for s in loaded.steps] == [s.to_dict() for s in made.steps]
    assert loaded.spec() == made.spec() == _scenario(loaded_by).spec()
    assert loaded.name == "crossing"


# -- tests/test_chaos_composed.py: SIGKILL x apiserver faults x partitions ------

N_ALPHA = 6          # shards on the SIGKILL-axis job
N_BETA = 12          # shards on the partition-axis job
BETA_BATCHES = 4
BETA_PACE = 0.2      # seconds a batch: keeps beta's queue alive through all
                     # three blips and the storm (the gates synchronize)

#: job alpha's worker: the port's `ElasticWorker` on fit_a_line in a
#: process of its own, paced so a SIGKILL lands mid-run
ALPHA_SRC = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
from edl_tpu_torch.coordinator.client import CoordinatorClient
from edl_tpu_torch.models import fit_a_line
from edl_tpu_torch.runtime import ElasticConfig, ElasticWorker, SyntheticShardSource
from edl_tpu_torch.runtime.train_loop import TrainerConfig


class SlowSource(SyntheticShardSource):
    def read(self, shard):
        for b in super().read(shard):
            time.sleep(0.05)
            yield b


client = CoordinatorClient(port=int(os.environ["PORT"]), worker=os.environ["NAME"])
worker = ElasticWorker(fit_a_line.MODEL, client,
                       SlowSource(fit_a_line.MODEL, batch_size=8, batches_per_shard=6),
                       ElasticConfig(checkpoint_dir=os.environ["CKPT"], checkpoint_interval=6,
                                     heartbeat_interval=0.0,
                                     trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05)),
                       device="cpu")
print("METRICS " + json.dumps(worker.run()))
"""


def _scrape(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


@pytest.mark.slow
def test_composed_cross_axis_chaos(native, tmp_path):
    """The three axes overlapping under one `ChaosScenario`, every fault
    gated on observed workload state: job alpha's worker is SIGKILLed and
    its replacement converges; job beta rides three ~1.2 s blips and then
    checkpoint-and-parks a storm, its adaptive policy choosing at least two
    recovery modes (its ``edl_ft_policy_*`` families scraped live and its
    decision spans); the K8s status updater and informer survive 409s and a
    mid-stream 410; exactly once on both queues, and beta's final loss
    within rel 0.05 of an unfaulted twin's."""
    from edl_tpu_torch.api.types import JobPhase
    from edl_tpu_torch.k8s import K8sJobStore
    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.obs.metrics import parse_prometheus
    from edl_tpu_torch.runtime import SyntheticShardSource
    from edl_tpu_torch.runtime.data import shard_names
    from edl_tpu_torch.runtime.elastic import FT_POLICY_KEY, ElasticConfig, ElasticWorker
    from edl_tpu_torch.runtime.ft_policy import PARK, RECONNECT, WAIT, FTPolicyConfig
    from edl_tpu_torch.runtime.train_loop import TrainerConfig
    from tests.fake_apiserver import FakeApiServer
    from tests.test_torch_k8s import _client, _job

    model = fit_a_line.MODEL
    server_a = CoordinatorServer(task_lease_sec=60.0, heartbeat_ttl_sec=60.0)
    server_b = CoordinatorServer(task_lease_sec=120.0, heartbeat_ttl_sec=120.0)
    srv = FakeApiServer()
    base = srv.serve()
    alpha_names, alpha_procs = ("w-a0", "w-a1"), []

    def spawn_alpha(name):
        env = {**os.environ, "PORT": str(server_a.port), "NAME": name,
               "CKPT": str(tmp_path / "ck-alpha")}
        return subprocess.Popen([sys.executable, "-c", ALPHA_SRC.format(repo=REPO)],
                                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    def kill_alpha():
        p = alpha_procs[0]
        p.kill()  # SIGKILL: no atexit, no finally, leases left dangling
        p.wait()
        # leave in lieu of waiting out the TTL: its leases requeue
        server_a.client(alpha_names[0]).leave()

    counts = {}

    class PacedCounting(SyntheticShardSource):
        def read(self, shard):
            counts[shard] = counts.get(shard, 0) + 1
            for b in super().read(shard):
                time.sleep(BETA_PACE)
                yield b

    watch_events = []

    class Recorder:
        def on_add(self, job):
            watch_events.append(("add", job.name, job.status.phase))

        def on_update(self, job):
            watch_events.append(("update", job.name, job.status.phase))

        def on_del(self, job):
            watch_events.append(("del", job.name, job.status.phase))

    stop_updater = threading.Event()
    update_ok = [0]
    store = K8sJobStore(_client(base), watch_timeout_seconds=5.0)
    store.create(_job())

    def updater():
        # a controller's status writeback: the armed 409s are absorbed by
        # the store's conflict retry
        while not stop_updater.is_set():
            status = store.get("demo").status
            status.phase = JobPhase.RUNNING
            store.update_status("demo", status)
            update_ok[0] += 1
            stop_updater.wait(0.25)

    updater_t = None
    try:
        server_a.start()
        server_b.start()
        admin_a = server_a.client("admin")
        admin_a.add_tasks(shard_names("ax", N_ALPHA))
        admin_b = server_b.client("admin")
        shards_b = shard_names("bx", N_BETA)
        admin_b.add_tasks(shards_b)
        store.watch(Recorder(), replay=True)
        updater_t = threading.Thread(target=updater, daemon=True)
        updater_t.start()
        with ChaosProxy(server_b.port, seed=11) as proxy:
            raw_b = CoordinatorClient(port=proxy.port, worker="w-beta",
                                      retry=RetryPolicy(deadline=0.5, seed=11))
            cfg_b = ElasticConfig(
                checkpoint_dir=str(tmp_path / "ck-beta"), checkpoint_interval=4,
                heartbeat_interval=0.0, metrics_port=0,
                ft_policy=FTPolicyConfig(outage_budget=6.0, min_history=3, min_wait=1.0,
                                         storm_retry_deadline=0.5),
                trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05))
            worker_b = ElasticWorker(model, raw_b, PacedCounting(
                model, batch_size=8, batches_per_shard=BETA_BATCHES), cfg_b, device="cpu")
            beta_out = {}

            def run_beta():
                try:
                    beta_out["metrics"] = worker_b.run()
                except BaseException as e:  # edl: noqa[EDL005] re-raised via assert in the main thread
                    beta_out["error"] = e

            scraped = threading.Event()
            policy = worker_b.policy

            def hist(k):
                return lambda: policy.state()["history"] >= k

            def make_demo2():
                job2 = _job()
                job2.name = "demo2"
                store.create(job2)

            sc = (ChaosScenario("composed")
                  .register_proxy("beta", proxy)
                  .register("alpha.kill", kill_alpha)
                  .register("alpha.respawn", lambda: alpha_procs.append(
                      spawn_alpha(alpha_names[1])))
                  .register("api.conflicts", lambda n: setattr(srv, "status_conflicts", n))
                  .register("api.break_watch",
                            lambda: setattr(srv, "watch_error_410_after", 1))
                  .register("api.create_demo2", make_demo2)
                  .predicate("alpha_progress",
                             lambda: int(admin_a.status().get("done", 0)) >= 2)
                  .predicate("beta_warm", lambda: worker_b.steps_done >= 2)
                  .predicate("hist1", hist(1))
                  .predicate("hist2", hist(2))
                  .predicate("hist3", hist(3))
                  .predicate("scraped", scraped.is_set)
                  .add("api.conflicts", n=2, note="arm /status 409s")
                  .add("alpha.kill", when="alpha_progress",
                       note="SIGKILL the trainer mid-queue")
                  .add("alpha.respawn", after=0.2,
                       note="Job-controller reconcile: replacement pod")
                  .add("beta.partition", when="beta_warm", note="blip 1")
                  .add("beta.heal", after=1.2)
                  .add("beta.partition", when="hist1", note="blip 2")
                  .add("beta.heal", after=1.2)
                  .add("api.break_watch", note="410 mid-stream: etcd compaction")
                  .add("beta.partition", when="hist2", note="blip 3")
                  .add("beta.heal", after=1.2)
                  .add("api.create_demo2", note="the relisted informer must deliver this")
                  .add("beta.partition", when="hist3",
                       note="the storm: held until beta parks")
                  .add("beta.heal", when="scraped", timeout=180.0,
                       note="heal only after checkpoint-and-park + live scrape"))
            alpha_procs.append(spawn_alpha(alpha_names[0]))
            beta_t = threading.Thread(target=run_beta, daemon=True)
            beta_t.start()
            sc.start()
            deadline = time.time() + 300
            while policy.decisions[PARK] < 1:
                assert time.time() < deadline, (policy.state(), sc.events)
                assert sc.failed is None, (sc.failed, sc.spec())
                assert "error" not in beta_out, beta_out
                time.sleep(0.05)
            url = getattr(worker_b, "metrics_url", None)
            assert url, "metrics server never came up"
            families = parse_prometheus(_scrape(url + "/metrics"))
            assert {"edl_ft_policy_decisions_total", "edl_ft_policy_mode",
                    "edl_ft_policy_incidents_total",
                    "edl_ft_policy_park_threshold_seconds"} <= set(families)
            health = json.loads(_scrape(url + "/healthz"))
            assert health["ft_policy"]["mode"] == PARK, health["ft_policy"]
            scraped.set()
            sc.join(timeout=180)
            assert sc.completed, (sc.failed, sc.events, sc.spec())
            beta_t.join(timeout=300)
            assert not beta_t.is_alive(), "beta never drained after heal"
            assert "error" not in beta_out, beta_out["error"]
            metrics_b = beta_out["metrics"]
        st_b = admin_b.status()
        audit_raw = admin_b.kv_get(FT_POLICY_KEY.format(worker="w-beta"))
        _out, err = alpha_procs[1].communicate(timeout=240)
        assert alpha_procs[1].returncode == 0, f"alpha replacement failed:\n{err[-3000:]}"
        st_a = admin_a.status()
    finally:
        stop_updater.set()
        if updater_t is not None:
            updater_t.join(timeout=10)
        store.stop()
        for p in alpha_procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server_a.stop()
        server_b.stop()
        srv.close()

    # axis 1: exactly once through the kill
    assert (int(st_a["done"]), int(st_a["queued"]), int(st_a["leased"])) == (N_ALPHA, 0, 0)
    # axis 2: >= 2 distinct modes (blips reconnect in place, the storm parks)
    decisions = worker_b.policy.decisions
    assert len([m for m, n in decisions.items() if n > 0]) >= 2, decisions
    assert decisions[RECONNECT] >= 3 and decisions[PARK] >= 1, decisions
    assert worker_b.policy.incidents >= 4 and metrics_b["policy_park"] >= 1.0
    spans = worker_b.tracer.find(name="ft_decision")
    assert len(spans) >= worker_b.policy.incidents
    for s in spans:
        for key in ("mode", "threshold", "elapsed", "park_breakeven",
                    "failure_rate_per_min"):
            assert key in s.attrs, s.attrs
    assert {s.attrs["mode"] for s in spans} >= {WAIT, RECONNECT, PARK}
    audit = json.loads(audit_raw)
    assert audit["policy"] == "adaptive" and audit["incidents"] >= 4, audit
    assert (int(st_b["done"]), int(st_b["queued"]), int(st_b["leased"])) == (N_BETA, 0, 0)
    assert set(counts) == set(shards_b), counts
    replayed = [s for s, n in counts.items() if n > 1]
    assert len(replayed) <= 1 and all(counts[s] == 2 for s in replayed), counts
    # axis 3: the apiserver faults were absorbed
    assert update_ok[0] >= 3 and srv.status_conflicts == 0
    assert any(e[0] == "add" and e[1] == "demo2" for e in watch_events), watch_events
    assert any(e[0] == "update" and e[2] == JobPhase.RUNNING for e in watch_events)
    # loss parity: chaos cost time, not training math
    coord = InProcessCoordinator(task_lease_sec=120.0, heartbeat_ttl_sec=120.0)
    twin_admin = coord.client("admin")
    twin_admin.register()
    twin_admin.add_tasks(shards_b)
    twin = ElasticWorker(model, coord.client("w-twin"),
                         SyntheticShardSource(model, batch_size=8,
                                              batches_per_shard=BETA_BATCHES),
                         ElasticConfig(checkpoint_dir=str(tmp_path / "ck-twin"),
                                       checkpoint_interval=4, heartbeat_interval=0.0,
                                       trainer=TrainerConfig(optimizer="sgd",
                                                             learning_rate=0.05)),
                         device="cpu")
    metrics_twin = twin.run()
    extra = metrics_b["steps"] - metrics_twin["steps"]
    assert 0 <= extra <= BETA_BATCHES, (metrics_b, metrics_twin)
    assert metrics_b["final_loss"] == pytest.approx(metrics_twin["final_loss"], rel=0.05)
