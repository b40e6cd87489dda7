"""The port's `DevicePrefetcher` against the JAX package's contract, on the
CPU.

The contract cases mirror `tests/test_device_pipeline.py`: source order at
any depth, exceptions (``SystemExit`` included) re-raised in the consumer,
an early break or close leaking no pump thread, ``close`` idempotent, an
early source return drained cleanly, placement overlapping the step, and
``prefetch_iter``. Where both packages run the same source, the items
(order, payloads, sample counts) are equal. Trainer cases: the pipelined
loop's losses equal the synchronous loop's exactly (tolerance 0: the same
batches in the same order through the same ops), with and without the wire
codec, across a codec widening while batches are in flight. The CUDA
stream/event hand-over runs only on a card (marked ``cuda``).
"""

import threading
import time

import numpy as np
import pytest
import torch

from edl_tpu.runtime.pipeline import DevicePrefetcher as JaxPrefetcher
from edl_tpu_torch.models import ctr, fit_a_line
from edl_tpu_torch.runtime import Trainer, TrainerConfig
from edl_tpu_torch.runtime.data import prefetch_iter
from edl_tpu_torch.runtime.pipeline import DevicePrefetcher, PlacedItem
from edl_tpu_torch.runtime.wire import WireRestartRequired

PUMP_PREFIX = "edl-place-pump"


def pump_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(PUMP_PREFIX) and t.is_alive()]


def assert_no_leaked_pumps():
    deadline = time.monotonic() + 5.0
    while pump_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not pump_threads(), threading.enumerate()


# -- pump contract -------------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 3])
def test_ordering_equals_the_jax_prefetcher(depth):
    items = [{"x": np.full((4, 1), i)} for i in range(20)]

    def place(b):
        return {"x": b["x"] * 2}

    out = list(DevicePrefetcher(items, place, depth=depth))
    want = list(JaxPrefetcher(items, place, depth=depth))
    assert [int(i.payload["x"][0, 0]) for i in out] == list(range(0, 40, 2))
    assert [(int(i.payload["x"][0, 0]), i.samples) for i in out] == [
        (int(i.payload["x"][0, 0]), i.samples) for i in want]
    assert all(isinstance(i, PlacedItem) and i.samples == 4 and i.ready is None
               for i in out)
    assert_no_leaked_pumps()


def test_place_fn_runs_on_pump_and_times_itself():
    pump_names = set()

    def place(batch):
        pump_names.add(threading.current_thread().name)
        time.sleep(0.01)
        return ("placed", batch)

    out = list(DevicePrefetcher([{"x": np.zeros((2, 1))} for _ in range(5)], place, depth=2))
    assert all(i.payload[0] == "placed" for i in out)
    assert all(i.place_seconds >= 0.005 for i in out)
    assert pump_names and all(n.startswith(PUMP_PREFIX) for n in pump_names)
    assert_no_leaked_pumps()


def test_source_exception_reraises_in_consumer():
    def source():
        yield {"x": np.zeros((2, 1))}
        raise WireRestartRequired("sparse_id")

    got = []
    with pytest.raises(WireRestartRequired):
        for item in DevicePrefetcher(source(), depth=2):
            got.append(item)
    assert len(got) == 1
    assert_no_leaked_pumps()


def test_place_fn_exception_reraises_in_consumer():
    def place(batch):
        raise ValueError("bad placement")

    with pytest.raises(ValueError, match="bad placement"):
        list(DevicePrefetcher([{"x": np.zeros((2, 1))}], place, depth=2))
    assert_no_leaked_pumps()


def test_system_exit_relays_to_consumer():
    def source():
        yield {"x": np.zeros((2, 1))}
        raise SystemExit(42)

    with pytest.raises(SystemExit) as e:
        list(DevicePrefetcher(source(), depth=1))
    assert e.value.code == 42
    assert_no_leaked_pumps()


def test_early_break_shuts_pump_down():
    def source():
        for i in range(10_000):
            yield {"x": np.full((2, 1), i)}

    pf = DevicePrefetcher(source(), depth=2)
    for _ in pf:
        break  # generator finalizer -> close() -> pump joined
    assert_no_leaked_pumps()


def test_close_is_idempotent_and_reentrant():
    pf = DevicePrefetcher([{"x": np.zeros((2, 1))}], depth=1)
    pf.close()
    pf.close()
    assert list(pf) == []
    assert_no_leaked_pumps()


def test_early_source_return_drains_cleanly():
    def source():
        yield {"x": np.full((2, 1), 0)}
        yield {"x": np.full((2, 1), 1)}

    out = list(DevicePrefetcher(source(), depth=4))
    assert [int(i.payload["x"][0, 0]) for i in out] == [0, 1]
    assert_no_leaked_pumps()


def test_overlap_pipelined_faster_than_sync():
    """With a slow placement and a slow step, the pipelined loop takes less
    than the synchronous one minus half the placement time."""
    n, place_s, step_s = 15, 0.02, 0.02

    def place(batch):
        time.sleep(place_s)
        return batch

    batches = [{"x": np.zeros((2, 1))} for _ in range(n)]
    t0 = time.perf_counter()
    place_total = 0.0
    for item in DevicePrefetcher(batches, place, depth=2):
        time.sleep(step_s)
        place_total += item.place_seconds
    pipe_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    for batch in batches:
        place(batch)
        time.sleep(step_s)
    sync_wall = time.perf_counter() - t0
    assert pipe_wall < sync_wall - 0.5 * place_total, (pipe_wall, sync_wall, place_total)
    assert_no_leaked_pumps()


def test_prefetch_iter_yields_raw_items_and_relays_errors():
    assert list(prefetch_iter(iter(range(7)))) == list(range(7))

    def source():
        yield 0
        raise SystemExit(3)

    it = prefetch_iter(source())
    assert next(it) == 0
    with pytest.raises(SystemExit):
        next(it)
    assert_no_leaked_pumps()


# -- the Trainer's pipelined loop -------------------------------------------------


def _run(model, batches, **cfg):
    trainer = Trainer(model, device="cpu", config=TrainerConfig(
        **{"optimizer": "sgd", "learning_rate": 0.1, **cfg}))
    losses = []
    _, metrics = trainer.run(trainer.init_state(), iter(batches),
                             on_step=lambda n, loss: losses.append(loss))
    return losses, metrics, trainer


@pytest.mark.parametrize("wire", [False, True], ids=["raw", "wire"])
def test_trainer_run_pipelined_matches_sync(wire):
    rng = np.random.default_rng(0)
    batches = [fit_a_line.MODEL.synthetic_batch(rng, 64) for _ in range(20)]
    sync, sync_m, _ = _run(fit_a_line.MODEL, batches, wire_transport=wire)
    piped, piped_m, _ = _run(fit_a_line.MODEL, batches, wire_transport=wire,
                             pipeline_depth=2)
    assert piped == sync and len(piped) == 20
    assert set(piped_m) == set(sync_m)
    assert piped_m["steps"] == 20 and piped_m["place_seconds"] > 0
    assert piped_m["retraces"] == 0
    assert_no_leaked_pumps()


def test_codec_widening_in_flight_keeps_each_batch_on_its_codec():
    """Batch 0's ids fit u8, batch 1's need u24: with two batches in
    flight, batch 0 is still decoded as u8 after the codec has widened,
    and the losses equal the synchronous loop's."""
    model = ctr.make_model(sparse_dim=1000)
    rng = np.random.default_rng(1)
    batches = [model.synthetic_batch(rng, 32) for _ in range(6)]
    batches[0]["sparse"] %= 200
    sync, _, trainer = _run(model, batches, optimizer="adagrad", wire_transport=True)
    assert trainer._codec.keys["sparse"].encoding == "u24"
    piped, _, _ = _run(model, batches, optimizer="adagrad", wire_transport=True,
                       pipeline_depth=2)
    assert piped == sync
    assert_no_leaked_pumps()


def test_profiler_waits_for_its_port():
    """The profiler is ported: in the pipelined loop (depth 2) `Trainer.run`
    feeds a `StepProfiler` one record a batch, each with the pump's
    placement seconds, and its losses stay the synchronous loop's."""
    from edl_tpu_torch.tools import StepProfiler

    rng = np.random.default_rng(0)
    batches = [fit_a_line.MODEL.synthetic_batch(rng, 32) for _ in range(6)]
    runs = {}
    for depth in (0, 2):
        trainer = Trainer(fit_a_line.MODEL, device="cpu")
        prof = StepProfiler(warmup=1)
        losses = []
        trainer.run(trainer.init_state(), iter(batches), pipeline_depth=depth,
                    profiler=prof, on_step=lambda n, loss: losses.append(loss))
        runs[depth] = (prof, losses)
        assert [r.samples for r in prof.records] == [32] * 6
        assert all(r.place_seconds is not None and r.place_seconds >= 0
                   for r in prof.records)
        summary = prof.summary()
        assert summary["steps"] == 6.0 and summary["steady_steps"] == 5.0
        assert "place_time_mean_s" in summary
    assert runs[2][1] == runs[0][1]
    assert_no_leaked_pumps()


@pytest.mark.cuda
def test_cuda_placement_orders_the_copy_on_a_side_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    trainer = Trainer(fit_a_line.MODEL, device=device)
    rng = np.random.default_rng(0)
    batches = [fit_a_line.MODEL.synthetic_batch(rng, 4096) for _ in range(8)]
    streams = set()

    def place(b):
        streams.add(torch.cuda.current_stream(device).cuda_stream)
        return trainer.place_bound(b)

    out = list(DevicePrefetcher(batches, place, depth=2, device=device))
    assert torch.cuda.current_stream(device).cuda_stream not in streams
    for item, b in zip(out, batches):
        assert item.ready is not None
        placed, _ = item.payload
        np.testing.assert_array_equal(placed["x"].cpu().numpy(), b["x"])
    assert_no_leaked_pumps()
