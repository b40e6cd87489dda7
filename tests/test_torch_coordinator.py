"""The port's coordinator copies (`edl_tpu_torch.coordinator`) against the
same suite as the JAX package's: the cases of `tests/test_coordinator.py`
that run through the ``inprocess``/``native`` fixture, against the port's
`InProcessCoordinator` and the port's `CoordinatorServer` + client driving
the same native binary (membership epochs, dense re-ranking, lease requeue,
barriers, KV, sync rendezvous). The cases that start the binary by hand
(bind address, durability) exercise the binary, not a Python module, and
stay in the JAX package's file. Semantics are exact; the timing bounds are
the JAX suite's.
"""

import threading
import time

import pytest

from edl_tpu_torch.coordinator import CoordinatorServer, InProcessCoordinator
from edl_tpu_torch.coordinator.server import ensure_built


def has_toolchain():
    try:
        ensure_built()
        return True
    except Exception:
        return False


@pytest.fixture(params=["inprocess", "native"])
def coord(request):
    """Yields a factory: client(worker_name) -> client object."""
    if request.param == "native":
        if not has_toolchain():
            pytest.skip("no C++ toolchain / build failed")
        server = CoordinatorServer(task_lease_sec=1.0, heartbeat_ttl_sec=1.5)
        server.start()
        yield server
        server.stop()
    else:
        yield InProcessCoordinator(task_lease_sec=1.0, heartbeat_ttl_sec=1.5)


def test_register_rank_epoch_world(coord):
    a = coord.client("worker-a")
    b = coord.client("worker-b")
    ra = a.register()
    rb = b.register()
    assert ra["rank"] == 0 and rb["rank"] == 1
    assert rb["world"] == 2
    assert rb["epoch"] > ra["epoch"]
    assert a.members() == ["worker-a", "worker-b"]
    a.leave()
    b.leave()


def test_leave_reranks_and_bumps_epoch(coord):
    names = ["w0", "w1", "w2"]
    clients = [coord.client(n) for n in names]
    for c in clients:
        c.register()
    epoch_before = clients[0].heartbeat()["epoch"]
    clients[0].leave()  # rank-0 departs
    hb = clients[1].heartbeat()
    assert hb["epoch"] > epoch_before
    assert hb["world"] == 2
    assert hb["rank"] == 0  # dense re-rank: w1 slides into rank 0
    assert clients[2].heartbeat()["rank"] == 1
    for c in clients[1:]:
        c.leave()


def test_heartbeat_expiry_drops_member(coord):
    a = coord.client("hb-a")
    b = coord.client("hb-b")
    a.register()
    b.register()
    # Only b heartbeats; a expires after ttl (1.5s).
    deadline = time.monotonic() + 3.0
    while time.monotonic() < deadline and "hb-a" in b.members():
        b.heartbeat()
        time.sleep(0.2)
    assert b.members() == ["hb-b"]
    assert b.heartbeat()["rank"] == 0
    b.leave()


def test_task_queue_lease_complete_and_requeue(coord):
    w = coord.client("tq-w")
    w.register()
    assert w.add_tasks(["shard-0", "shard-1", "shard-2"]) == 3
    t1 = w.acquire_task()
    assert t1 == "shard-0"
    w.complete_task(t1)
    t2 = w.acquire_task()
    w.fail_task(t2)  # explicit fail -> requeued at the back
    seen = {w.acquire_task(), w.acquire_task()}
    assert seen == {"shard-1", "shard-2"} - {t2} | {t2}
    # duplicates of completed tasks are not re-added
    assert w.add_tasks(["shard-0"]) == 0
    w.leave()


def test_lease_timeout_requeues(coord):
    w = coord.client("lt-w")
    w.register()
    w.add_tasks(["slow-shard"])
    t = w.acquire_task()
    assert t == "slow-shard"
    time.sleep(1.3)  # lease is 1.0s
    # after expiry another worker can take it
    w2 = coord.client("lt-w2")
    w2.register()
    got = None
    deadline = time.monotonic() + 2.0
    while got is None and time.monotonic() < deadline:
        got = w2.acquire_task()
        time.sleep(0.1)
    assert got == "slow-shard"
    w2.complete_task(got)
    w.leave()
    w2.leave()


def test_departed_worker_leases_requeue_immediately(coord):
    a = coord.client("dep-a")
    b = coord.client("dep-b")
    a.register()
    b.register()
    a.add_tasks(["chunk-x"])
    assert a.acquire_task() == "chunk-x"
    a.leave()  # departure returns the lease without waiting for expiry
    assert b.acquire_task() == "chunk-x"
    b.complete_task("chunk-x")
    b.leave()


@pytest.mark.sanitizer
def test_barrier_releases_all(coord):
    n = 3
    clients = [coord.client(f"bar-{i}") for i in range(n)]
    for c in clients:
        c.register()
    results = [None] * n

    def arrive(i):
        results[i] = clients[i].barrier("step-sync", n, timeout=10.0)

    threads = [threading.Thread(target=arrive, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert all(r is not None and r["ok"] for r in results), results
    # reusable: second generation works too
    threads = [threading.Thread(target=arrive, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=15)
    assert all(r["ok"] for r in results)
    for c in clients:
        c.leave()


def test_kv_roundtrip(coord):
    c = coord.client("kv-w")
    c.kv_put("checkpoint/latest", "step-1000")
    assert c.kv_get("checkpoint/latest") == "step-1000"
    c.kv_del("checkpoint/latest")
    assert c.kv_get("checkpoint/latest") is None
    assert c.kv_get("never-set") is None


def test_status_counts(coord):
    c = coord.client("st-w")
    c.register()
    st = c.status()
    assert st["ok"] and st["world"] >= 1
    c.leave()


def test_stale_worker_cannot_complete_others_lease(coord):
    """Lease ownership: after expiry + re-lease, the late original worker's
    complete must be rejected, not steal the new lease."""
    a = coord.client("own-a")
    b = coord.client("own-b")
    a.register()
    b.register()
    a.add_tasks(["contested"])
    assert a.acquire_task() == "contested"
    time.sleep(1.3)  # a's lease (1.0s) expires
    got = None
    deadline = time.monotonic() + 2.0
    while got is None and time.monotonic() < deadline:
        got = b.acquire_task()
        time.sleep(0.05)
    assert got == "contested"
    late = a.complete_task("contested")
    assert late["ok"] is False  # rejected: b owns it now
    assert b.complete_task("contested")["ok"] is True
    a.leave()
    b.leave()


def test_kv_non_ascii_and_control_chars_roundtrip(coord):
    c = coord.client("enc-w")
    c.kv_put("path", "café/中文")
    assert c.kv_get("path") == "café/中文"
    c.kv_put("ctl", "a\x01b\x0bc")
    assert c.kv_get("ctl") == "a\x01b\x0bc"


@pytest.mark.sanitizer
def test_sync_rendezvous_all_members(coord):
    """Epoch sync: released only when every member arrives; a joiner mid-wait
    forces resync with the new epoch."""
    a = coord.client("sy-a")
    b = coord.client("sy-b")
    ea = a.register()["epoch"]
    eb = b.register()["epoch"]
    results = {}

    def arrive(name, cli, epoch):
        results[name] = cli.sync(epoch, timeout=10.0)

    # a syncs at its stale epoch -> immediate resync reply
    stale = a.sync(ea, timeout=5.0)
    assert stale["ok"] is False and stale.get("resync") is True
    assert stale["epoch"] == eb

    ta = threading.Thread(target=arrive, args=("a", a, eb))
    tb = threading.Thread(target=arrive, args=("b", b, eb))
    ta.start()
    time.sleep(0.2)
    tb.start()
    ta.join(timeout=15)
    tb.join(timeout=15)
    assert results["a"]["ok"] and results["b"]["ok"], results
    assert results["a"]["world"] == 2
    a.leave()
    b.leave()


def test_sync_released_with_resync_on_join(coord):
    """A parked sync waiter is woken with resync when membership moves."""
    a = coord.client("syj-a")
    b = coord.client("syj-b")
    a.register()
    epoch = b.register()["epoch"]
    result = {}

    def waiter():
        # a parks: b never arrives at this epoch
        result["r"] = a.sync(epoch, timeout=10.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.3)
    c = coord.client("syj-c")  # join bumps the epoch -> waiter gets resync
    c.register()
    t.join(timeout=15)
    r = result["r"]
    assert r["ok"] is False and r.get("resync") is True and r["world"] == 3
    for cli in (a, b, c):
        cli.leave()


def test_barrier_count_mismatch_rejected(coord):
    """Two cohorts sharing a barrier name with different counts must not
    release each other: the first arrival of a cycle fixes the count
    (VERDICT weak #5)."""
    a = coord.client("a")
    b = coord.client("b")
    a.register()
    b.register()

    results = {}

    def arrive(cl, name, count, key):
        results[key] = cl.barrier(name, count=count)

    ta = threading.Thread(target=arrive, args=(a, "step", 2, "a"))
    ta.start()
    time.sleep(0.3)  # a arrived first: count fixed at 2
    mismatch = b.barrier("step", count=3)
    assert mismatch.get("ok") is False
    assert "mismatch" in mismatch.get("error", "")
    # agreeing cohort still completes
    ok = b.barrier("step", count=2)
    ta.join(timeout=10)
    assert ok.get("ok") is True
    assert results["a"].get("ok") is True


def test_heartbeat_renews_leases(coord):
    """A LIVE worker keeps its leases (etcd-keepalive semantics): heartbeats
    extend lease deadlines, so completion-lag holds — shards completed only
    after a covering checkpoint — can outlive task_lease_sec without healthy
    runs retraining shards. Expiry fires only when the heartbeat also stops
    (covered by test_lease_requeue_on_expiry)."""
    a = coord.client("alive")
    a.register()
    a.add_tasks(["renew0"])
    assert a.acquire_task() == "renew0"
    # fixture lease TTL is 1.0 s: hold the lease across 2.4 s of heartbeats
    for _ in range(6):
        time.sleep(0.4)
        a.heartbeat()
    st = a.status()
    assert int(st["leased"]) == 1 and int(st["queued"]) == 0, st
    assert a.complete_task("renew0").get("ok") is True
    a.leave()


def test_register_requeues_predecessors_leases(coord):
    """Register is an incarnation boundary: a warm-restarted worker (same
    pod name) must get its dead predecessor's leases REQUEUED, not renewed.
    Renewal-on-register let the successor's heartbeats keep stale leases
    alive forever — rank 0 then deadlocked in 'stop: wait' rounds on leases
    that were its own (caught live by the multi-job scale-down e2e)."""
    a = coord.client("podA")
    a.register(takeover=True)
    a.add_tasks(["inc0", "inc1", "inc2"])
    assert a.acquire_task() is not None
    assert a.acquire_task() is not None
    st = a.status()
    assert int(st["leased"]) == 2 and int(st["queued"]) == 1, st
    # a plain mid-run refresh must NOT forfeit in-flight leases (elastic
    # workers re-register after compile-stall expiry while still training)
    a.register()
    st = a.status()
    assert int(st["leased"]) == 2 and int(st["queued"]) == 1, st
    # the pod warm-restarts: a fresh incarnation claims the name
    a.register(takeover=True)
    st = a.status()
    assert int(st["leased"]) == 0 and int(st["queued"]) == 3, st
    # and can lease everything back itself (no double-lease residue)
    got = {a.acquire_task() for _ in range(3)}
    assert got == {"inc0", "inc1", "inc2"}
    a.leave()


def test_client_families_are_the_jax_packages_on_the_port_registry():
    """The port's client counts into the port's registry, under the JAX
    package's family names letter for letter."""
    from edl_tpu.coordinator import client as jax_client
    from edl_tpu_torch.coordinator import client
    from edl_tpu_torch.obs.metrics import get_registry

    names = sorted(v.name for v in vars(client).values() if hasattr(v, "name")
                   and str(getattr(v, "name", "")).startswith("edl_client_"))
    jax_names = sorted(v.name for v in vars(jax_client).values() if hasattr(v, "name")
                       and str(getattr(v, "name", "")).startswith("edl_client_"))
    assert names == jax_names and len(names) == 7
    assert set(names) <= set(get_registry().snapshot())
