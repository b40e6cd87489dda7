"""The elastic-rebalance experiment: the reference's published result, redone.

Reproduces the scenario behind the reference's boss tutorial numbers
(`doc/boss_tutorial.md:259-301`; BASELINE.md): an idle cluster, then

1. job1 (elastic 2..10) submitted — the autoscaler grows it to the cluster's
   capacity ceiling (ref: 18.4% -> 54.4% CPU util),
2. job2 (elastic 2..8) submitted — both share, utilization climbs
   (ref: -> 86.4%),
3. job3 submitted with NO free capacity — running jobs shrink to admit it;
   nothing stays pending (ref: job1 10->3, job2 8->4, new=4, 0 pending,
   -> 88.4%).

Here the schedulable currency is chips on a hermetic FakeCluster; the
collector records the utilization trajectory exactly as the reference's
`collector.py` measurement harness did. Prints one JSON line per stage plus
a final summary line.

The port of the JAX package's ``examples/elastic_demo.py``: the same 10 hosts
x 4 chips, the same three jobs and the same lines, over this package's
controller; the trainers' entrypoint names the port's CTR entry, which a
FakeCluster never runs. Run as ``python -m edl_tpu_torch.examples.elastic_demo``.
"""

from __future__ import annotations

import json
import sys
import time

from edl_tpu_torch.api.quantity import ResourceList
from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.api.validation import normalize
from edl_tpu_torch.controller import Controller
from edl_tpu_torch.controller.autoscaler import AutoscalerConfig
from edl_tpu_torch.controller.cluster import FakeCluster, NodeInfo
from edl_tpu_torch.controller.updater import UpdaterConfig
from edl_tpu_torch.tools.collector import Collector


def make_job(name: str, min_inst: int, max_inst: int) -> TrainingJob:
    return normalize(TrainingJob.from_dict({
        "metadata": {"name": name, "namespace": "default"},
        "spec": {
            "image": "edl-tpu:latest",
            "passes": 1,
            "fault_tolerant": True,
            "tpu": {"accelerator_type": "v5e", "chips_per_trainer": 4},
            "trainer": {
                "entrypoint": "python -m edl_tpu_torch.examples.ctr.train",
                "min_instance": min_inst,
                "max_instance": max_inst,
                "resources": {
                    "requests": {"cpu": "1", "memory": "1Gi"},
                    "limits": {"cpu": "2", "memory": "2Gi"},
                },
            },
            "parallelism": {"data": 4},
        },
    }))


def wait_settled(controller, collector, seconds: float = 6.0) -> dict:
    """Let the autoscaler reach its fixed point, then sample."""
    time.sleep(seconds)
    s = collector.sample()
    return s.to_dict()


def main() -> int:
    # 10 hosts x 4 chips = 40 chips; job shapes chosen so job1's max (10
    # trainers x 4 chips) saturates the ceiling and job3 forces a rebalance.
    nodes = [
        NodeInfo(
            name=f"host{i}",
            allocatable=ResourceList.make({"cpu": 16.0, "memory": "64Gi", "tpu": 4}),
        )
        for i in range(10)
    ]
    cluster = FakeCluster(nodes)
    controller = Controller(
        cluster,
        max_load_desired=0.9,  # the deployed value (k8s/edl_controller.yaml)
        autoscaler_config=AutoscalerConfig(loop_seconds=0.5, max_load_desired=0.9),
        updater_config=UpdaterConfig(convert_seconds=0.5, poll_seconds=0.2),
    )
    controller.start()
    collector = Collector(controller.store, cluster, period_seconds=0.5)
    collector.start()

    trajectory = []

    def stage(label: str, sample: dict) -> None:
        entry = {
            "stage": label,
            "tpu_utilization": sample["tpu_utilization"],
            "pending_jobs": sample["pending_jobs"],
            "running_trainers": sample["running_trainers"],
        }
        trajectory.append(entry)
        print(json.dumps(entry))

    try:
        stage("idle", collector.sample().to_dict())

        controller.submit(make_job("job1", 2, 10))
        stage("job1-scaled", wait_settled(controller, collector))

        controller.submit(make_job("job2", 2, 8))
        stage("job2-admitted", wait_settled(controller, collector))

        controller.submit(make_job("job3", 4, 6))
        stage("job3-rebalanced", wait_settled(controller, collector, 10.0))

        final = trajectory[-1]
        ok = (
            trajectory[0]["tpu_utilization"] == 0.0
            and trajectory[1]["tpu_utilization"] > 0.5
            and trajectory[2]["tpu_utilization"] >= trajectory[1]["tpu_utilization"]
            and final["pending_jobs"] == 0
            and all(n >= 1 for n in final["running_trainers"].values())
            and len(final["running_trainers"]) == 3
        )
        print(json.dumps({
            "experiment": "elastic-rebalance",
            "ok": ok,
            "trajectory": [t["tpu_utilization"] for t in trajectory],
            "final_trainers": final["running_trainers"],
        }))
        return 0 if ok else 2
    finally:
        collector.stop()
        controller.stop()


if __name__ == "__main__":
    sys.exit(main())
