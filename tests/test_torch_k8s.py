"""The port's Kubernetes backend (`edl_tpu_torch.k8s`) against the shared
in-process fake apiserver (`tests/fake_apiserver.py`, which imports nothing
of either package).

The cases of `tests/test_k8s.py`, mirrored onto the port, with nodes that
carry ``nvidia.com/gpu``: the port's accelerator resource, which maps to the
autoscaler's internal ``tpu`` key both ways as the JAX package maps
``google.com/tpu``. Then parity: the same job materialized by both packages'
`K8sCluster` against two fake apiservers leaves equal Deployments, Services,
Jobs and pods once the accelerator's resource name is swapped. Every wait
has its own deadline (``DEADLINE``).
"""

import base64
import json
import textwrap
import threading
import time

import pytest

from edl_tpu_torch.api.quantity import ResourceList
from edl_tpu_torch.api.types import JobPhase, TrainingJob
from edl_tpu_torch.api.validation import normalize
from edl_tpu_torch.controller.jobparser import (
    ROLE_COORDINATOR,
    ROLE_TRAINER,
    parse_to_coordinator,
    parse_to_trainer,
)
from edl_tpu_torch.k8s import ApiClient, ApiError, K8sCluster, K8sJobStore, KubeConfig
from edl_tpu_torch.k8s.cluster import (ACCELERATOR_RESOURCE, resources_from_k8s,
                                       resources_to_k8s)
from tests.fake_apiserver import FakeApiServer

#: the accelerator's node resource in each package
RESOURCE = {"jax": "google.com/tpu", "torch": ACCELERATOR_RESOURCE}
#: how long a watch or a controller loop may take to deliver what a case waits for
DEADLINE = 15.0

JOB_YAML = textwrap.dedent(
    """
    metadata: {name: demo, namespace: default}
    spec:
      image: edl-tpu:latest
      fault_tolerant: true
      tpu: {accelerator_type: v5e, chips_per_trainer: 4}
      trainer:
        entrypoint: "python -m edl_tpu_torch.launcher start_trainer"
        min_instance: 2
        max_instance: 4
        resources:
          requests: {cpu: 1, memory: 1Gi}
          limits: {cpu: 2, memory: 2Gi}
      data_shards: [s0, s1, s2, s3]
    """
)


def _server(resource: str):
    srv = FakeApiServer()
    base = srv.serve()
    for i in range(4):
        srv.add_node(f"host{i}", {"cpu": "16", "memory": "64Gi", resource: "4"})
    return srv, base


@pytest.fixture()
def apiserver():
    srv, base = _server(ACCELERATOR_RESOURCE)
    yield srv, base
    srv.close()


def _client(base: str) -> ApiClient:
    return ApiClient(KubeConfig(host=base), timeout=5.0)


def _job() -> TrainingJob:
    return normalize(TrainingJob.from_yaml(JOB_YAML))


def _wait(pred, what):
    deadline = time.monotonic() + DEADLINE
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    assert pred(), what


# -- config --------------------------------------------------------------------


def test_kubeconfig_parsing(tmp_path):
    import yaml

    ca_pem = "-----BEGIN CERTIFICATE-----\nZZZZ\n-----END CERTIFICATE-----\n"
    kubeconfig = {
        "current-context": "prod",
        "contexts": [{"name": "prod",
                      "context": {"cluster": "c1", "user": "u1", "namespace": "ml"}}],
        "clusters": [{"name": "c1", "cluster": {
            "server": "https://10.0.0.1:6443",
            "certificate-authority-data": base64.b64encode(ca_pem.encode()).decode()}}],
        "users": [{"name": "u1", "user": {"token": "sekrit"}}],
    }
    path = tmp_path / "config"
    path.write_text(yaml.safe_dump(kubeconfig))
    cfg = KubeConfig.from_kubeconfig(str(path))
    assert cfg.host == "https://10.0.0.1:6443"
    assert cfg.namespace == "ml"
    assert cfg.ca_cert_data == ca_pem
    assert cfg.auth_headers() == {"Authorization": "Bearer sekrit"}


def test_in_cluster_config(tmp_path, monkeypatch):
    (tmp_path / "token").write_text("tok-1\n")
    (tmp_path / "namespace").write_text("kube-system")
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "10.96.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", "443")
    cfg = KubeConfig.in_cluster(sa_dir=str(tmp_path))
    assert cfg.host == "https://10.96.0.1:443"
    assert cfg.namespace == "kube-system"
    assert cfg.bearer_token() == "tok-1"
    (tmp_path / "token").write_text("tok-2")  # rotation: re-read a request
    assert cfg.bearer_token() == "tok-2"


def test_bearer_token_sent_and_checked(apiserver):
    srv, base = apiserver
    srv.token = "letmein"
    assert ApiClient(KubeConfig(host=base, token="letmein"), timeout=5.0).get(
        "/api/v1/nodes")["items"]
    with pytest.raises(ApiError) as err:
        ApiClient(KubeConfig(host=base, token="wrong"), timeout=5.0).get("/api/v1/nodes")
    assert err.value.status == 401


def test_quantity_roundtrip():
    rl = resources_from_k8s({"cpu": "500m", "memory": "2Gi", "nvidia.com/gpu": "4"})
    assert rl.get_q("cpu") == 0.5
    assert rl.get_q("memory") == 2 * 2**30
    assert rl.get_q("tpu") == 4.0
    back = resources_to_k8s(rl)
    assert back["nvidia.com/gpu"] == "4" and "tpu" not in back
    assert resources_from_k8s(back) == rl


def test_resource_maps_equal_the_jax_package_but_the_accelerator_name():
    from edl_tpu.k8s.cluster import resources_from_k8s as jax_from
    from edl_tpu.k8s.cluster import resources_to_k8s as jax_to

    for k8s in ({"cpu": "250m", "memory": "128Mi"},
                {"cpu": "2", "memory": "3Gi", "tpu-unrelated": "1", "ACC": "8"}):
        jax_in = {RESOURCE["jax"] if k == "ACC" else k: v for k, v in k8s.items()}
        port_in = {RESOURCE["torch"] if k == "ACC" else k: v for k, v in k8s.items()}
        assert dict(resources_from_k8s(port_in)) == dict(jax_from(jax_in))
        rl = resources_from_k8s(port_in)
        swapped = {RESOURCE["torch"] if k == RESOURCE["jax"] else k: v
                   for k, v in jax_to(jax_from(jax_in)).items()}
        assert resources_to_k8s(rl) == swapped


# -- K8sCluster ----------------------------------------------------------------


def test_inquire_scans_nodes_and_pods(apiserver):
    srv, base = apiserver
    snap = K8sCluster(_client(base)).inquire()
    assert snap.total.get_q("tpu") == 16.0
    assert snap.total.get_q("cpu") == 64.0
    assert snap.free("tpu") == 16.0
    assert set(snap.node_idle) == {f"host{i}" for i in range(4)}


def test_create_role_and_scale(apiserver):
    srv, base = apiserver
    cluster = K8sCluster(_client(base))
    trainer = parse_to_trainer(_job())
    cluster.create_role("demo", ROLE_TRAINER, trainer.replicas, trainer.requests,
                        trainer.limits, workload=trainer)
    pods = cluster.job_pods("demo", ROLE_TRAINER)
    assert len(pods) == 2
    assert all(p.phase == "Running" and p.requests.get_q("tpu") == 4.0 for p in pods)
    assert cluster.get_trainer_parallelism("demo") == 2
    container = srv.jobs[("default", "demo-trainer")]["spec"]["template"]["spec"][
        "containers"][0]
    assert container["resources"]["requests"][ACCELERATOR_RESOURCE] == "4"
    cluster.set_trainer_parallelism("demo", 4)
    assert cluster.get_trainer_parallelism("demo") == 4
    assert len(cluster.job_pods("demo", ROLE_TRAINER)) == 4
    assert cluster.inquire().free("tpu") == 0.0  # 4 trainers x 4 cards
    cluster.set_trainer_parallelism("demo", 1)
    assert len(cluster.job_pods("demo", ROLE_TRAINER)) == 1
    with pytest.raises(KeyError):
        cluster.set_trainer_parallelism("nosuch", 3)


def test_coordinator_role_gets_deployment_and_service(apiserver):
    srv, base = apiserver
    cluster = K8sCluster(_client(base))
    coord = parse_to_coordinator(_job())
    for _ in range(2):  # re-creating adopts (controller restart replay)
        cluster.create_role("demo", ROLE_COORDINATOR, 1, coord.requests, coord.limits,
                            workload=coord)
    assert ("default", "demo-coordinator") in srv.deployments
    assert ("default", "demo-coordinator") in srv.services
    container = srv.deployments[("default", "demo-coordinator")]["spec"]["template"][
        "spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in container["env"]}
    assert env["EDL_JOB_NAME"] == "demo"
    assert env["EDL_ROLE"] == ROLE_COORDINATOR
    cluster.delete_role("demo", ROLE_COORDINATOR)
    assert ("default", "demo-coordinator") not in srv.deployments
    assert not cluster.job_pods("demo", ROLE_COORDINATOR)


@pytest.mark.parametrize("pvc", ["", "demo-coord-state"], ids=["empty_dir", "claim"])
def test_coordinator_state_volume(apiserver, pvc):
    """``spec.coordinator.state_pvc`` mounts a PersistentVolumeClaim at the
    coordinator's workspace; without it a pod-lifetime emptyDir."""
    srv, base = apiserver
    cluster = K8sCluster(_client(base))
    job = _job()
    job.spec.coordinator.workspace = "/state"
    job.spec.coordinator.state_pvc = pvc
    coord = parse_to_coordinator(job)
    cluster.create_role("demo", ROLE_COORDINATOR, 1, coord.requests, coord.limits,
                        workload=coord)
    pod_spec = srv.deployments[("default", "demo-coordinator")]["spec"]["template"]["spec"]
    volume = ({"persistentVolumeClaim": {"claimName": pvc}} if pvc else {"emptyDir": {}})
    assert pod_spec["volumes"] == [{"name": "coordinator-state", **volume}]
    assert pod_spec["containers"][0]["volumeMounts"] == [
        {"name": "coordinator-state", "mountPath": "/state"}]
    cluster.delete_role("demo", ROLE_COORDINATOR)


def test_unplaceable_pods_stay_pending(apiserver):
    srv, base = apiserver
    cluster = K8sCluster(_client(base))
    trainer = parse_to_trainer(_job())
    # 5 trainers x 4 cards > 16 cards in the cluster -> one Pending
    cluster.create_role("demo", ROLE_TRAINER, 5, trainer.requests, trainer.limits,
                        workload=trainer)
    phases = sorted(p.phase for p in cluster.job_pods("demo", ROLE_TRAINER))
    assert phases.count("Running") == 4 and phases.count("Pending") == 1


# -- the manifests against the JAX package's --------------------------------------


def _materialize(side: str) -> dict:
    """Both roles of the job through ``side``'s K8sCluster (a fixed auth
    token stamped), scaled 2 -> 5 (one pod pends) -> 3, against a fresh
    fake apiserver whose nodes carry ``side``'s accelerator; returns what
    the apiserver holds, as JSON text."""
    import importlib

    pkg = {"jax": "edl_tpu", "torch": "edl_tpu_torch"}[side]
    api = importlib.import_module(f"{pkg}.api")
    parser = importlib.import_module(f"{pkg}.controller.jobparser")
    k8s = importlib.import_module(f"{pkg}.k8s")
    srv, base = _server(RESOURCE[side])
    try:
        cluster = k8s.K8sCluster(k8s.ApiClient(k8s.KubeConfig(host=base), timeout=5.0))
        job = importlib.import_module(f"{pkg}.api.validation").normalize(
            api.TrainingJob.from_yaml(JOB_YAML))
        job.spec.auth_token = "f" * 32
        job.spec.coordinator.workspace = "/state"
        for w in parser.parse_job(job):
            cluster.create_role(job.name, w.role, w.replicas, w.requests, w.limits,
                                workload=w)
        cluster.set_trainer_parallelism(job.name, 5)
        cluster.set_trainer_parallelism(job.name, 3)
        pods = cluster.job_pods(job.name, "trainer")
        seen = {"pods": [(p.name, p.phase, p.node, dict(p.requests)) for p in pods],
                "parallelism": cluster.get_trainer_parallelism(job.name),
                "free": cluster.inquire().free("tpu")}
        with srv.lock:
            held = {kind: {"/".join(k): v for k, v in getattr(srv, kind).items()}
                    for kind in ("deployments", "services", "jobs", "pods")}
        return {"held": json.dumps(held, sort_keys=True), "seen": seen}
    finally:
        srv.close()


def test_manifests_equal_the_jax_package_but_the_accelerator_name():
    """Every Deployment, Service, Job and pod manifest the port's backend
    creates equals the JAX package's once ``google.com/tpu`` is read as
    ``nvidia.com/gpu``; the cluster views (pods, parallelism, free chips)
    are equal."""
    want = _materialize("jax")
    got = _materialize("torch")
    assert RESOURCE["jax"] in want["held"] and RESOURCE["jax"] not in got["held"]
    assert json.loads(got["held"]) == json.loads(
        want["held"].replace(RESOURCE["jax"], RESOURCE["torch"]))
    assert got["seen"] == want["seen"]


def test_default_pod_image_is_the_port_trainer_image():
    """A role created without a workload runs the port's trainer image,
    ``edl-tpu-torch:latest``; its Job equals the JAX package's but for the
    image's name and the accelerator's."""
    import importlib

    held = {}
    for side, pkg in (("jax", "edl_tpu"), ("torch", "edl_tpu_torch")):
        k8s = importlib.import_module(f"{pkg}.k8s")
        srv, base = _server(RESOURCE[side])
        try:
            cluster = k8s.K8sCluster(k8s.ApiClient(k8s.KubeConfig(host=base), timeout=5.0))
            cluster.create_role("demo", ROLE_TRAINER, 1,
                                ResourceList.make({"cpu": 1, "tpu": 4}), ResourceList())
            held[side] = srv.jobs[("default", "demo-trainer")]
        finally:
            srv.close()
    image = held["torch"]["spec"]["template"]["spec"]["containers"][0]["image"]
    assert image == "edl-tpu-torch:latest"
    want = json.dumps(held["jax"], sort_keys=True).replace(RESOURCE["jax"], RESOURCE["torch"])
    assert json.loads(want.replace('"edl-tpu:latest"', '"edl-tpu-torch:latest"')) == held["torch"]


# -- K8sJobStore ---------------------------------------------------------------


class Recorder:
    def __init__(self, with_phase=True):
        self.events, self.with_phase = [], with_phase

    def _add(self, kind, job):
        self.events.append((kind, job.name, job.status.phase) if self.with_phase
                           else (kind, job.name))

    def on_add(self, job):
        self._add("add", job)

    def on_update(self, job):
        self._add("update", job)

    def on_del(self, job):
        self._add("del", job)


def test_store_crud_and_status_subresource(apiserver):
    srv, base = apiserver
    store = K8sJobStore(_client(base))
    job = _job()
    assert store.create(job).name == "demo"
    with pytest.raises(KeyError):
        store.create(job)
    got = store.get("demo")
    assert got.spec.trainer.min_instance == 2
    got.status.phase = JobPhase.RUNNING
    store.update_status("demo", got.status)
    got.spec.trainer.max_instance = 8
    store.update(got)
    again = store.get("demo")
    assert again.spec.trainer.max_instance == 8
    assert again.status.phase == JobPhase.RUNNING
    assert [j.name for j in store.list()] == ["demo"]
    store.delete("demo")
    with pytest.raises(KeyError):
        store.get("demo")


def test_store_watch_delivers_events(apiserver):
    srv, base = apiserver
    store = K8sJobStore(_client(base), watch_timeout_seconds=5.0)
    rec = Recorder()
    store.create(_job())
    store.watch(rec, replay=True)
    assert rec.events[0] == ("add", "demo", JobPhase.NONE)
    status = store.get("demo").status
    status.phase = JobPhase.RUNNING
    store.update_status("demo", status)
    store.delete("demo")
    _wait(lambda: len(rec.events) >= 3, "the watch never delivered 3 events")
    store.stop()
    assert ("update", "demo", JobPhase.RUNNING) in rec.events
    assert rec.events[-1][0] == "del"


def test_status_conflict_retried_transparently(apiserver):
    srv, base = apiserver
    store = K8sJobStore(_client(base))
    store.create(_job())
    status = store.get("demo").status
    status.phase = JobPhase.RUNNING
    srv.status_conflicts = 2
    assert store.update_status("demo", status).status.phase == JobPhase.RUNNING
    assert srv.status_conflicts == 0


def test_status_conflict_exhaustion_surfaces_and_updater_survives(apiserver):
    from edl_tpu_torch.controller import FakeCluster, NodeInfo
    from edl_tpu_torch.controller.updater import JobUpdater

    srv, base = apiserver
    store = K8sJobStore(_client(base))
    store.create(_job())
    status = store.get("demo").status
    status.phase = JobPhase.RUNNING
    srv.status_conflicts = 99
    with pytest.raises(ApiError) as ei:
        store.update_status("demo", status)
    assert ei.value.conflict
    srv.status_conflicts = 0
    cluster = FakeCluster([NodeInfo("n0", ResourceList.make({"cpu": "8", "memory": "16Gi"}))])
    updater = JobUpdater(store.get("demo"), cluster, store)
    srv.status_conflicts = 99
    updater._set_phase(JobPhase.CREATING)  # must not raise
    srv.status_conflicts = 0
    updater._set_phase(JobPhase.RUNNING)
    assert store.get("demo").status.phase == JobPhase.RUNNING


def test_watch_survives_midstream_410(apiserver):
    srv, base = apiserver
    store = K8sJobStore(_client(base), watch_timeout_seconds=5.0)
    rec = Recorder()
    srv.watch_error_410_after = 1  # every stream dies after one event
    store.create(_job())
    store.watch(rec, replay=True)
    for phase in (JobPhase.CREATING, JobPhase.RUNNING):
        status = store.get("demo").status
        status.phase = phase
        store.update_status("demo", status)
        time.sleep(0.1)
    job2 = _job()
    job2.name = "demo2"
    store.create(job2)
    _wait(lambda: any(e[:2] == ("add", "demo2") for e in rec.events),
          f"demo2's add never arrived: {rec.events}")
    store.stop()
    assert ("update", "demo", JobPhase.RUNNING) in rec.events, rec.events


def test_watch_tolerates_bookmarks_and_slow_lists(apiserver):
    srv, base = apiserver
    srv.send_bookmarks = True
    srv.list_delay_sec = 0.5
    store = K8sJobStore(_client(base), watch_timeout_seconds=2.0)
    rec = Recorder(with_phase=False)
    store.create(_job())
    store.watch(rec, replay=True)
    # the replayed add comes after the slow list, later than that under load
    _wait(lambda: rec.events, "the replayed add never arrived")
    time.sleep(1.0)  # an idle-watch cycle of bookmarks
    n_before = len(rec.events)
    status = store.get("demo").status
    status.phase = JobPhase.RUNNING
    store.update_status("demo", status)
    _wait(lambda: len(rec.events) > n_before, "the update never arrived")
    store.stop()
    assert rec.events[:n_before] == [("add", "demo")]
    assert ("update", "demo") in rec.events


# -- the controller loop on the Kubernetes backend ------------------------------


def _flip_trainers(srv, phase="Succeeded"):
    with srv.lock:
        for p in srv.pods.values():
            if (p["metadata"]["labels"].get("edl.tpu/role") == ROLE_TRAINER
                    and p["status"]["phase"] == "Running"):
                p["status"]["phase"] = phase


def test_controller_loop_on_k8s_backend(apiserver):
    """The controller drives the TrainingJob to Running with a coordinator
    Deployment + Service and a trainer Job behind it, the autoscaler may
    grow it toward 4 by patching ``spec.parallelism``, and once every
    trainer succeeds the job is Succeeded and the coordinator released."""
    from edl_tpu_torch.controller import Controller
    from edl_tpu_torch.controller.updater import UpdaterConfig

    srv, base = apiserver
    api = _client(base)
    cluster = K8sCluster(api)
    store = K8sJobStore(api, watch_timeout_seconds=5.0)
    controller = Controller(cluster, store=store, updater_config=UpdaterConfig(
        convert_seconds=0.2, poll_seconds=0.05, create_timeout=10.0))
    controller.start()
    try:
        store.create(_job())
        _wait(lambda: store.get("demo").status.phase == JobPhase.RUNNING, "never Running")
        assert ("default", "demo-coordinator") in srv.deployments
        assert ("default", "demo-trainer") in srv.jobs
        parallelism = cluster.get_trainer_parallelism("demo")
        assert 2 <= parallelism <= 4
        assert len(cluster.job_pods("demo", ROLE_TRAINER)) == parallelism
        _flip_trainers(srv)
        _wait(lambda: store.get("demo").status.phase.terminal(), "never terminal")
        assert store.get("demo").status.phase == JobPhase.SUCCEEDED
        assert ("default", "demo-coordinator") not in srv.deployments
    finally:
        controller.stop()
        store.stop()


def test_cli_run_selects_k8s_backend(apiserver, tmp_path):
    """``python -m edl_tpu_torch run --kubeconfig`` drives the job on the
    Kubernetes backend to Succeeded."""
    import yaml

    from edl_tpu_torch.cli import main

    srv, base = apiserver
    cfg_path = tmp_path / "kubeconfig"
    cfg_path.write_text(yaml.safe_dump({
        "current-context": "test",
        "contexts": [{"name": "test", "context": {"cluster": "fake", "user": "u"}}],
        "clusters": [{"name": "fake", "cluster": {"server": base}}],
        "users": [{"name": "u", "user": {}}],
    }))
    job_path = tmp_path / "job.yaml"
    job_path.write_text(JOB_YAML)

    def succeed_soon():
        # the autoscaler may keep growing the job: flip until it is terminal
        deadline = time.monotonic() + 25.0
        while time.monotonic() < deadline:
            with srv.lock:
                tj = srv.trainingjobs.get(("default", "demo"))
                if tj and tj.get("status", {}).get("phase") in ("Succeeded", "Failed"):
                    return
            _flip_trainers(srv)
            time.sleep(0.2)

    flipper = threading.Thread(target=succeed_soon, daemon=True)
    flipper.start()
    rc = main(["run", "-f", str(job_path), "--kubeconfig", str(cfg_path),
               "--timeout", "30", "--collect-period", "60"])
    flipper.join(timeout=30)
    assert not flipper.is_alive()
    assert rc == 0
    assert srv.trainingjobs[("default", "demo")]["status"]["phase"] == "Succeeded"
