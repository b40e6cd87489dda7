"""The port's batch serving tier against the JAX package's, on the CPU.

Artifacts are written by the JAX package (`save_inference_model`) and
served by both tiers; request rows come from numpy generators. Tolerances:

- fit_a_line, all f32: each served row within rtol 1e-5 / atol 1e-6 of the
  JAX replica's (measured: at most 7.5e-9 absolute, of outputs up to 0.098).
- CTR at sparse dim 512, its MLP in bf16 on both sides, each rounding at
  its own places: rtol 2e-2 / atol 2e-3 (`tests/test_torch_ctr.py`'s logit
  tolerance; measured: at most 4.2e-4 absolute, of logits up to 0.30).

The behaviour tests mirror `tests/test_serving.py`: every bucket warmed
before the first request and no other shape dispatched
(``jit_cache_size() == 0``), a rolling swap under traffic with zero failed
requests, typed overload, drain on stop, HTTP codes, the required metric
families, the autoscaler's scrape, and status publication through a
coordinator client.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from edl_tpu.models import ctr as jax_ctr
from edl_tpu.models import fit_a_line as jax_fit_a_line
from edl_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from edl_tpu.runtime.export import _serving_mesh, save_inference_model
from edl_tpu.serving import ServingConfig as JaxConfig
from edl_tpu.serving import ServingReplica as JaxReplica
from edl_tpu_torch.obs.metrics import MetricsRegistry, parse_prometheus
from edl_tpu_torch.runtime import load_inference_model
from edl_tpu_torch.serving import (
    SERVING_KV_PREFIX,
    ServeCompileError,
    ServeOverloadError,
    ServingConfig,
    ServingReplica,
    pad_batch,
    pick_bucket,
    plan_chunks,
    scrape_serve_signal,
    split_rows,
    validate_buckets,
)
from edl_tpu_torch.serving.__main__ import REQUIRED_FAMILIES

CTR_CONFIG = {"sparse_dim": 512}


def export_jax(directory, name, step=100, scale=1.0, config=None):
    """Write a versioned artifact of the JAX package's ``name`` model."""
    model = {"fit_a_line": jax_fit_a_line.MODEL,
             "ctr": jax_ctr.make_model(**(config or {}))}[name]
    params = model.init(jax.random.PRNGKey(0), _serving_mesh(model))
    if scale != 1.0:
        params = jax.tree_util.tree_map(lambda x: x * scale, params)
    save_inference_model(directory, name, params, config=config, step=step,
                         versioned=True)


def feature_row(seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(13).astype(np.float32)}


def ctr_rows(n, seed=0):
    batch = jax_ctr.synthetic_batch(np.random.default_rng(seed), n, CTR_CONFIG["sparse_dim"])
    return [{"dense": batch["dense"][i], "sparse": batch["sparse"][i]} for i in range(n)]


@pytest.fixture(scope="module")
def fit_artifact(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("fit"))
    export_jax(directory, "fit_a_line")
    return directory


@pytest.fixture(scope="module")
def replica(fit_artifact):
    """One started port replica on the JAX-written fit_a_line artifact,
    with its HTTP frontend, for the tests that do not swap or stop it."""
    r = ServingReplica(ServingConfig(model_dir=fit_artifact, buckets=(1, 4, 16),
                                     max_batch_delay_s=0.002, port=0,
                                     name="serve-shared", device="cpu"),
                       registry=MetricsRegistry())
    r.start()
    yield r
    r.stop()


@pytest.fixture
def replica_factory(tmp_path):
    """Builds started port replicas against a fresh artifact; stops them."""
    live = []
    export_dir = str(tmp_path / "art")
    export_jax(export_dir, "fit_a_line")

    def make(**overrides):
        kwargs = dict(model_dir=export_dir, buckets=(1, 4, 16),
                      max_batch_delay_s=0.002, version_poll_s=0.05, device="cpu",
                      name=f"serve-t{len(live)}")
        kwargs.update(overrides)
        r = ServingReplica(ServingConfig(**kwargs), registry=MetricsRegistry())
        live.append(r)
        return r.start()

    make.export_dir = export_dir
    yield make
    for r in live:
        r.stop()


def serve_both(directory, rows, buckets):
    """Every row through the JAX replica and the port's, concurrently."""
    out = {}
    for side, replica in (
            ("jax", JaxReplica(JaxConfig(model_dir=directory, buckets=buckets,
                                         name="jax-side"), registry=JaxRegistry())),
            ("port", ServingReplica(ServingConfig(model_dir=directory, buckets=buckets,
                                                  name="port-side", device="cpu"),
                                    registry=MetricsRegistry()))):
        with replica:
            futures = [replica.submit(row) for row in rows]
            out[side] = np.stack([np.asarray(f.result(timeout=60)) for f in futures])
            if side == "port":
                assert replica.jit_cache_size() == 0
    return out["port"], out["jax"]


# -- the tier against the JAX package's ----------------------------------------


def test_fit_a_line_rows_match_the_jax_replica(fit_artifact):
    got, want = serve_both(fit_artifact, [feature_row(i) for i in range(24)], (1, 8))
    assert got.shape == want.shape == (24, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_narrow_ctr_rows_match_the_jax_replica(tmp_path):
    """CTR's JAX replica needs buckets divisible by the serving mesh's data
    axis (8 virtual devices), so both tiers use (8, 32)."""
    directory = str(tmp_path / "ctr")
    export_jax(directory, "ctr", config=CTR_CONFIG)
    got, want = serve_both(directory, ctr_rows(40), (8, 32))
    assert got.shape == want.shape == (40,)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


def test_served_rows_match_the_module_predict(replica, fit_artifact):
    art = load_inference_model(fit_artifact, device="cpu")
    rows = [feature_row(i) for i in range(7)]
    served = [np.asarray(replica.predict(r)) for r in rows]
    direct = art.predict({"x": np.stack([r["x"] for r in rows])}).numpy()
    np.testing.assert_allclose(np.stack(served), direct, rtol=1e-6, atol=0)


# -- batcher units (copies of the JAX package's) -------------------------------


def test_bucket_ladder_math():
    assert validate_buckets([1, 8, 32]) == (1, 8, 32)
    for bad in ((), (0, 4), (4, 4), (8, 4)):
        with pytest.raises(ValueError):
            validate_buckets(bad)
    assert [pick_bucket(n, (1, 8, 32)) for n in (1, 2, 8, 9, 64)] == [1, 8, 8, 32, 32]
    assert plan_chunks(70, (1, 8, 32)) == [32, 32, 6]
    assert plan_chunks(0, (1, 8, 32)) == []


def test_pad_batch_and_split_rows_take_tensors():
    avals = {"x": ((13,), np.dtype(np.float32))}
    rows = [feature_row(i) for i in range(3)]
    batch = pad_batch(rows, 8, avals)
    assert batch["x"].shape == (8, 13)
    np.testing.assert_array_equal(batch["x"][3:], 0.0)
    out = split_rows(torch.from_numpy(batch["x"]) * 2, 3)
    assert len(out) == 3 and isinstance(out[1], np.ndarray)
    np.testing.assert_array_equal(out[1], rows[1]["x"] * 2)
    tree = split_rows({"a": torch.arange(8), "b": (torch.ones(8, 2),)}, 2)
    assert tree[1]["a"] == 1 and tree[1]["b"][0].tolist() == [1.0, 1.0]


# -- replica core --------------------------------------------------------------


def test_warm_contract_every_bucket_before_the_first_request(replica):
    """Every bucket ran once before ``start()`` returned (its gauge is set),
    and bucketed traffic dispatches no other shape."""
    text = replica.registry.render_prometheus()
    for bucket in (1, 4, 16):
        assert f'edl_serve_compile_seconds{{bucket="{bucket}"}}' in text
    assert replica.jit_cache_size() == 0
    futures = [replica.submit(feature_row(i)) for i in range(40)]
    for f in futures:
        f.result(timeout=10)
    assert replica.jit_cache_size() == 0


def test_concurrent_submit_correct_per_request_rows(replica, fit_artifact):
    art = load_inference_model(fit_artifact, device="cpu")
    rows = [feature_row(i) for i in range(64)]
    expected = art.predict({"x": np.stack([r["x"] for r in rows])}).numpy()
    results, errors = [None] * 64, []

    def call(i):
        try:
            results[i] = np.asarray(replica.predict(rows[i]))
        except Exception as e:  # pragma: no cover - surfaced via assert
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(64):
        np.testing.assert_allclose(results[i], expected[i], rtol=1e-6)


def test_rejects_malformed_features(replica):
    with pytest.raises(KeyError):
        replica.submit({"nope": np.zeros(13, np.float32)})
    with pytest.raises(ValueError):
        replica.submit({"x": np.zeros(7, np.float32)})
    with pytest.raises(TypeError):
        replica.submit([1, 2, 3])
    assert replica.predict(feature_row()) is not None


def test_overload_rejects_synchronously(fit_artifact):
    r = ServingReplica(ServingConfig(model_dir=fit_artifact, buckets=(1,),
                                     queue_capacity=2, device="cpu"),
                       registry=MetricsRegistry())
    # not started: the dispatcher isn't draining, so the queue fills
    r._started = True
    r._feature_avals = {"x": ((13,), np.dtype(np.float32))}
    r.submit(feature_row(0))
    r.submit(feature_row(1))
    with pytest.raises(ServeOverloadError):
        r.submit(feature_row(2))
    assert r.status()["rejected"] == 1


def test_stop_drains_accepted_requests(replica_factory):
    r = replica_factory(max_batch_delay_s=0.0)
    futures = [r.submit(feature_row(i)) for i in range(32)]
    r.stop(drain=True)
    for f in futures:
        assert f.result(timeout=1) is not None
    assert r.status()["completed"] == 32


def test_rolling_swap_under_traffic_fails_nothing(replica_factory):
    """A new version published while requests flow: the watcher warms it
    and swaps between batches; no request fails, and the answers after the
    swap are the new version's."""
    r = replica_factory()
    stop, failures, served = threading.Event(), [], [0]

    def traffic():
        i = 0
        while not stop.is_set():
            try:
                r.predict(feature_row(i % 8))
                served[0] += 1
            except Exception as e:  # pragma: no cover - surfaced via assert
                failures.append(e)
                return
            i += 1

    t = threading.Thread(target=traffic)
    t.start()
    time.sleep(0.2)
    export_jax(replica_factory.export_dir, "fit_a_line", step=200, scale=2.0)
    deadline = time.monotonic() + 10
    while r.status()["model_step"] != 200:
        assert time.monotonic() < deadline, "swap never landed"
        time.sleep(0.02)
    time.sleep(0.2)
    stop.set()
    t.join(timeout=10)
    assert not failures and served[0] > 0
    status = r.status()
    assert status["errors"] == 0 and status["swaps"] == 1
    assert status["last_swap_step"] == 200
    assert r.jit_cache_size() == 0
    row = feature_row(99)
    art = load_inference_model(replica_factory.export_dir, device="cpu")
    assert art.step == 200
    np.testing.assert_allclose(np.asarray(r.predict(row)),
                               art.predict({"x": row["x"][None]}).numpy()[0], rtol=1e-6)


def test_failed_warm_up_raises_a_serving_error_naming_the_bucket(replica_factory,
                                                                 monkeypatch):
    from edl_tpu_torch.runtime.export import InferenceModel

    def broken(self, batch):
        raise RuntimeError("no kernel for this shape")

    monkeypatch.setattr(InferenceModel, "predict", broken)
    with pytest.raises(ServeCompileError, match="bucket 1"):
        replica_factory(name="bad-bucket")


# -- HTTP frontend, metrics and status -----------------------------------------


def http_post(url, payload, timeout=10):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def test_http_predict_single_and_batch(replica):
    url = replica.url + "/predict"
    single = http_post(url, {"features": {"x": feature_row()["x"].tolist()}})
    assert isinstance(single["outputs"], list)
    assert single["model_step"] == 100 and single["version"].startswith("v")
    multi = http_post(url, {"features": [{"x": feature_row(i)["x"].tolist()}
                                         for i in range(5)]})
    assert len(multi["outputs"]) == 5


def test_http_error_codes(replica):
    url = replica.url + "/predict"
    for payload, target in (({"features": {"x": [1.0, 2.0]}}, url),
                            ({"nope": 1}, url)):
        with pytest.raises(urllib.error.HTTPError) as e:
            http_post(target, payload)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        http_post(replica.url + "/elsewhere", {"features": {}})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        http_post(replica.url + "/generate", {"prompt": [1]})
    assert e.value.code == 404  # a batch replica serves no LM generation


def test_http_metrics_health_and_the_autoscaler_scrape(replica):
    http_post(replica.url + "/predict", {"features": {"x": feature_row()["x"].tolist()}})
    with urllib.request.urlopen(replica.url + "/metrics", timeout=5) as r:
        families = parse_prometheus(r.read().decode())
    assert [f for f in REQUIRED_FAMILIES if f not in families] == []
    with urllib.request.urlopen(replica.url + "/healthz", timeout=5) as r:
        assert json.loads(r.read())["completed"] >= 1
    signal = scrape_serve_signal(replica.url)
    assert signal is not None and signal.latency_count >= 1
    assert signal.latency_buckets[-1][0] == float("inf")
    assert scrape_serve_signal("http://127.0.0.1:1/metrics") is None


def test_replica_publishes_status_through_a_coordinator_client(fit_artifact):
    """Any client with ``register``, ``heartbeat`` and ``kv_put`` carries
    the status: here the JAX package's in-process coordinator's."""
    from edl_tpu.coordinator.inprocess import InProcessCoordinator

    coord = InProcessCoordinator(heartbeat_ttl_sec=300.0)
    client = coord.client("serve-a")
    r = ServingReplica(ServingConfig(model_dir=fit_artifact, buckets=(1, 4),
                                     name="serve-a", version_poll_s=0.05,
                                     publish_interval_s=0.0, device="cpu"),
                       client=client, registry=MetricsRegistry())
    with r:
        r.predict(feature_row())
        deadline, status = time.monotonic() + 5, {}
        while time.monotonic() < deadline:
            raw = client.kv_get(SERVING_KV_PREFIX + "serve-a")
            status = json.loads(raw) if raw else {}
            if status.get("completed", 0) >= 1:
                break
            time.sleep(0.05)
        assert status["completed"] >= 1 and status["model_step"] == 100
        assert status["kind"] == "batch"
        assert "serve-a" in client.members()


def test_replica_raises_without_cuda_unless_the_cpu_is_asked_for(fit_artifact):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is real")
    r = ServingReplica(ServingConfig(model_dir=fit_artifact))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        r.start()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_inference_model(fit_artifact)
