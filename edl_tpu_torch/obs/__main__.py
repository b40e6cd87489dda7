"""The obs smoke: ``python -m edl_tpu_torch.obs [--device cpu]``, the port
of ``python -m edl_tpu.obs``.

Boots the real pieces end to end — the native coordinator, an elastic
worker with its embedded `/metrics` endpoint and a `StepProfiler`, the
coordinator status bridge — and scrapes over HTTP while training runs.
Exits 0 only when the scrape parses as Prometheus text exposition AND
every required metric family from all four layers (profiler, worker,
client, bridged coordinator) is present: the JAX smoke's gate. The worker
trains on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

#: One family per instrumented layer, plus depth within the worker: a scrape
#: missing any of these means a layer's wiring regressed (the JAX smoke's).
REQUIRED_FAMILIES = (
    # data plane (StepProfiler -> registry)
    "edl_step_time_seconds",
    "edl_step_samples_total",
    # worker runtime (WorkerInstruments)
    "edl_worker_heartbeat_latency_seconds",
    "edl_worker_epoch",
    "edl_worker_steps_total",
    # transport (CoordinatorClient)
    "edl_client_calls_total",
    # control plane (CoordinatorStatusBridge over op_status)
    "edl_coordinator_up",
    "edl_coordinator_ops",
    "edl_coordinator_journal_records",
)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="obs smoke: scrape a training worker")
    parser.add_argument("--device", default=None,
                        help="device to train on (default: the card; 'cpu' asks "
                             "for the CPU)")
    args = parser.parse_args(argv)

    import os
    import tempfile
    import threading
    import time

    from edl_tpu_torch.coordinator.server import CoordinatorServer
    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import parse_prometheus
    from edl_tpu_torch.runtime.data import SyntheticShardSource, shard_names
    from edl_tpu_torch.runtime.elastic import ElasticConfig, ElasticWorker
    from edl_tpu_torch.runtime.train_loop import TrainerConfig
    from edl_tpu_torch.tools.profiler import StepProfiler

    model = fit_a_line.MODEL
    last_scrape = {"text": ""}
    done = threading.Event()

    with tempfile.TemporaryDirectory() as td, CoordinatorServer() as server:
        server.client("admin").add_tasks(shard_names("smoke", 4))
        cfg = ElasticConfig(
            checkpoint_dir=os.path.join(td, "ck"),
            checkpoint_interval=50,
            heartbeat_interval=0.05,
            metrics_port=0,  # ephemeral: the point is the endpoint exists
            trainer=TrainerConfig(optimizer="sgd", learning_rate=0.05),
        )
        worker = ElasticWorker(
            model,
            server.client("smoke-worker"),
            SyntheticShardSource(model, batch_size=32, batches_per_shard=4),
            cfg,
            device=args.device,
            profiler=StepProfiler(warmup=1),
        )

        def scrape_loop() -> None:
            # Scrape WHILE training runs — a live endpoint, not a post-hoc
            # dump. The last successful scrape is what gets asserted.
            while not done.is_set():
                url = getattr(worker, "metrics_url", None)
                if url:
                    try:
                        last_scrape["text"] = scrape_metrics(url, timeout=5.0)
                    except OSError:
                        pass  # server still booting / already torn down
                time.sleep(0.1)

        scraper = threading.Thread(target=scrape_loop, daemon=True,
                                   name="obs-smoke-scraper")
        scraper.start()
        try:
            metrics = worker.run()
        finally:
            done.set()
            scraper.join(timeout=5)

    text = last_scrape["text"]
    if not text:
        print("obs-smoke: FAIL — no successful scrape during the run",
              file=sys.stderr)
        return 1
    families = parse_prometheus(text)  # raises ValueError on malformed text
    missing = [f for f in REQUIRED_FAMILIES if f not in families]
    if missing:
        print(f"obs-smoke: FAIL — missing families: {missing}\n"
              f"present: {sorted(families)}", file=sys.stderr)
        return 1
    print(f"obs-smoke: OK — {len(families)} families exposed, "
          f"{int(metrics['steps'])} steps trained on {worker.device}, "
          f"required families present: {list(REQUIRED_FAMILIES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
