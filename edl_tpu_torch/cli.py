"""The ``edl-tpu-torch`` command-line interface: ``python -m edl_tpu_torch``.

Equivalent of the reference's CLI entrypoint (`cmd/edl/edl.go:16-51`) plus the
kubectl-side workflow its docs walk through (`doc/usage.md:81-118`):

- ``controller`` — run the control plane (flags mirror `edl.go:17-20`:
  ``--log-level``, ``--max-load-desired``).
- ``validate``  — admission-check a TrainingJob YAML.
- ``run``       — submit a YAML to an in-process control plane and follow it
  to a terminal phase (the `kubectl create -f && watch` loop, hermetic).
- ``train``     — run a model from the zoo locally on one device: the card
  unless ``--device cpu`` (the `train_local.py` twin,
  `example/fit_a_line/train_local.py:41-109`).
- ``status``    — query a running coordinator's counters (ops, fsyncs,
  journal records, per-worker leases) over the wire protocol, plus any
  serving replicas' published state (version, queue, bucket hit-rates).
- ``serve``     — run one inference replica over an exported artifact:
  the continuous-batching frontend (`edl_tpu_torch.serving`) with /predict,
  /metrics and rolling model-version swap.

``--log-format json`` (anywhere on the command line) switches every
subcommand to one-JSON-object-per-line logging (`edl_tpu_torch.obs.logs`).

``controller``/``run`` pick their backend the way `cmd/edl/edl.go:31-36`
does: ``--in-cluster`` uses the pod serviceaccount, ``--kubeconfig`` (or a
bare ``--k8s``) a kubeconfig file — both select the Kubernetes-backed
``K8sCluster`` + ``K8sJobStore``. Without either flag the in-memory
FakeCluster twin runs, hermetic and chip-quota-shaped, as in tests.

A copy of the JAX package's ``edl_tpu/cli.py``: the same subcommands, flags
and JSON, over this package's modules. The departures: ``train`` and
``serve`` take ``--device`` (default: the card; they raise without one unless
given ``cpu``), ``train`` logs the device it trains on, and the defaults that
were a TPU's figures are an H100's: ``--chips-per-host 8`` (an HGX host),
``plan --slices 8,8 --chip-flops`` the card's bf16 peak and ``--hbm-gib 80``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys
import time
from typing import List, Optional

from edl_tpu_torch.api.types import TrainingJob
from edl_tpu_torch.api.validation import ValidationError, normalize
from edl_tpu_torch.tools.peaks import H100_PEAK_BF16_TFLOPS


def _add_nodes_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--hosts", type=int, default=4, help="fake-cluster host count")
    p.add_argument("--chips-per-host", type=int, default=8,
                   help="cards per host (an HGX H100 host holds 8)")
    p.add_argument("--cpu-per-host", type=float, default=16.0)
    p.add_argument("--memory-per-host", default="64Gi")


def _add_backend_flags(p: argparse.ArgumentParser) -> None:
    """Backend selection (ref: cmd/edl/edl.go:17-36 kubeconfig flag +
    in-cluster fallback, made explicit). Any of these flags selects the
    Kubernetes backend; without them the in-memory FakeCluster twin runs."""
    p.add_argument("--k8s", action="store_true",
                   help="use the Kubernetes backend with the default kubeconfig")
    p.add_argument("--kubeconfig", default=None,
                   help="kubeconfig path (implies the Kubernetes backend)")
    p.add_argument("--context", default=None,
                   help="kubeconfig context (implies the Kubernetes backend)")
    p.add_argument("--in-cluster", action="store_true",
                   help="use the pod serviceaccount (implies Kubernetes backend)")
    p.add_argument("--namespace", default=None,
                   help="namespace to manage (implies the Kubernetes backend; "
                        "default: from config)")


def _make_backend(args):
    """(cluster, store) for the selected backend; store None = in-memory.

    May raise ``edl_tpu_torch.k8s.config.ConfigError`` — callers turn that into a
    CLI error, not a traceback.
    """
    wants_k8s = (
        args.in_cluster or args.kubeconfig or args.k8s
        or args.context or args.namespace
    )
    if wants_k8s:
        from edl_tpu_torch.k8s import ApiClient, K8sCluster, K8sJobStore, KubeConfig

        if args.in_cluster:
            cfg = KubeConfig.in_cluster()
        else:
            cfg = KubeConfig.from_kubeconfig(args.kubeconfig, args.context)
        api = ApiClient(cfg)
        ns = args.namespace
        return K8sCluster(api, namespace=ns), K8sJobStore(api, namespace=ns)
    return _make_fake_cluster(args), None


def _make_fake_cluster(args):
    from edl_tpu_torch.api.quantity import ResourceList
    from edl_tpu_torch.controller.cluster import FakeCluster, NodeInfo

    nodes = [
        NodeInfo(
            name=f"host{i}",
            allocatable=ResourceList.make(
                {
                    "cpu": args.cpu_per_host,
                    "memory": args.memory_per_host,
                    "tpu": args.chips_per_host,
                }
            ),
        )
        for i in range(args.hosts)
    ]
    return FakeCluster(nodes)


def _load_job(path: str) -> TrainingJob:
    with open(path) as f:
        return TrainingJob.from_yaml(f.read())


# -- subcommands ---------------------------------------------------------------


def cmd_validate(args) -> int:
    try:
        job = normalize(_load_job(args.file))
    except (ValidationError, ValueError, KeyError) as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print(json.dumps(job.to_dict(), indent=2))
    return 0


@contextlib.contextmanager
def _control_plane(args, sink):
    """Backend + Controller + Collector with symmetric teardown (shared by
    ``run`` and ``controller``). Raises ConfigError on bad backend flags."""
    from edl_tpu_torch.controller import Controller
    from edl_tpu_torch.tools.collector import Collector

    cluster, store = _make_backend(args)
    controller = Controller(cluster, store=store,
                            max_load_desired=args.max_load_desired)
    controller.start()
    collector = Collector(controller.store, cluster,
                          period_seconds=args.collect_period, sink=sink)
    collector.start()
    try:
        yield controller
    finally:
        collector.stop()
        controller.stop()
        if store is not None:
            store.stop()


def cmd_run(args) -> int:
    from edl_tpu_torch.k8s.config import ConfigError

    try:  # parse + admission-validate before the control plane spins up
        parsed = normalize(_load_job(args.file))
    except (ValidationError, ValueError, KeyError) as e:
        print(f"INVALID: {e}", file=sys.stderr)
        return 1

    try:
        with _control_plane(args, sink=sys.stderr) as controller:
            try:
                job = controller.submit(parsed)
            except KeyError as e:
                # K8s mode: the CRD of a previous run may still exist.
                print(f"ERROR: {e.args[0] if e.args else e} "
                      "(delete the existing TrainingJob first)", file=sys.stderr)
                return 1
            deadline = time.monotonic() + args.timeout
            while time.monotonic() < deadline:
                status = controller.job_status(job.name, job.namespace).status
                if status.phase.terminal():
                    break
                time.sleep(0.5)
            final = controller.job_status(job.name, job.namespace)
            print(json.dumps(final.to_dict()["status"], indent=2))
            return 0 if final.status.phase.value == "Succeeded" else 2
    except ConfigError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def cmd_controller(args) -> int:
    from edl_tpu_torch.k8s.config import ConfigError

    server = None
    if args.metrics_port is not None:
        # One scrape covers the whole control plane: the collector's cluster
        # gauges, autoscaler decisions, and actuation counters all live in
        # the process registry this endpoint serves.
        from edl_tpu_torch.obs.http import MetricsServer

        server = MetricsServer(port=args.metrics_port).start()
        logging.getLogger("edl_tpu_torch.cli").info(
            "controller metrics at %s/metrics", server.url)
    try:
        with _control_plane(args, sink=sys.stdout):
            logging.getLogger("edl_tpu_torch").info("controller running; Ctrl-C to stop")
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                return 0
    except ConfigError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    finally:
        if server is not None:
            server.stop()


def cmd_status(args) -> int:
    """Pretty-print (or JSON-dump) a live coordinator's status counters."""
    from edl_tpu_torch.coordinator.client import CoordinatorClient, CoordinatorError

    try:
        client = CoordinatorClient(
            args.host, args.port, worker="edl-cli-status",
            connect_timeout=args.timeout, retry=None, token=args.token,
        )
        with client:
            status = client.call("status", timeout=args.timeout)
            # Workers publish their live fault-tolerance policy state under
            # edl/ft_policy/<worker> (runtime.ft_policy); read it back per
            # member. Best-effort: an old coordinator without members/kv
            # just shows no policy section.
            policies = {}
            # Serving replicas publish their queue/bucket/swap state under
            # edl/serving/<worker> (serving.worker) the same way.
            serving = {}
            try:
                for member in client.members():
                    raw = client.kv_get(f"edl/ft_policy/{member}")
                    if raw:
                        policies[member] = json.loads(raw)
                    raw = client.kv_get(f"edl/serving/{member}")
                    if raw:
                        serving[member] = json.loads(raw)
            except (CoordinatorError, ValueError):
                policies = {}
                serving = {}
    except (CoordinatorError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    ok = bool(status.get("ok"))
    if args.json:
        if policies:
            status = dict(status, ft_policy=policies)
        if serving:
            status = dict(status, serving=serving)
        print(json.dumps(status, indent=2, sort_keys=True))
        return 0 if ok else 1
    counters = [
        "epoch", "world", "queued", "leased", "done",
        "ops", "batch_frames", "batch_subops",
        "fsyncs", "snapshots", "journal_records", "turns",
        "uptime_seconds",
    ]
    present = [k for k in counters if k in status]
    width = max((len(k) for k in present), default=1)
    print(f"coordinator {args.host}:{args.port} "
          f"({'ok' if ok else 'NOT OK'})")
    for k in present:
        v = status[k]
        if isinstance(v, float):
            v = int(v) if float(v).is_integer() else round(v, 3)
        print(f"  {k:<{width}}  {v}")
    holders = status.get("lease_holders") or []
    if holders:
        print("  per-worker leases:")
        for item in holders:
            worker, _, count = str(item).rpartition("=")
            print(f"    {worker:<24} {count}")
    preempts = status.get("preempts") or []
    if preempts:
        print("  pending revocations:")
        for item in preempts:
            worker, _, notice = str(item).rpartition("=")
            print(f"    {worker:<24} notice={notice}s")
    if policies:
        print("  fault-tolerance policy:")
        for worker, st in sorted(policies.items()):
            print(f"    {worker:<24} policy={st.get('policy')} "
                  f"mode={st.get('mode')} "
                  f"threshold={st.get('threshold')}s "
                  f"incidents={st.get('incidents')} "
                  f"storm={st.get('storm')}")
    if serving:
        print("  serving replicas:")
        for worker, st in sorted(serving.items()):
            if st.get("kind") == "lm":
                # LM replicas publish stream/token/KV state instead of a
                # request queue — render the decode-native numbers.
                kv = st.get("kv") or {}
                print(f"    {worker:<24} kind=lm "
                      f"version={st.get('version')} "
                      f"step={st.get('model_step')} "
                      f"streams={st.get('active_streams')} "
                      f"tokens/s={st.get('tokens_per_s')} "
                      f"kv_blocks={kv.get('used_blocks')}/"
                      f"{kv.get('n_blocks')} "
                      f"free={kv.get('free_blocks')} "
                      f"frag={kv.get('fragmentation')} "
                      f"served={st.get('completed')}")
                continue
            hits = st.get("bucket_hits") or {}
            hits_s = ",".join(f"{k}:{v}" for k, v in sorted(
                hits.items(), key=lambda kv: int(kv[0]))) or "-"
            print(f"    {worker:<24} version={st.get('version')} "
                  f"step={st.get('model_step')} "
                  f"queue={st.get('queue_depth')} "
                  f"buckets={hits_s} "
                  f"last_swap_step={st.get('last_swap_step')} "
                  f"served={st.get('completed')}")
    return 0 if ok else 1


def cmd_plan(args) -> int:
    """Dump the layout planner's scored candidate table for a chip count —
    the cost model made inspectable without running a job."""
    from edl_tpu_torch.parallel import ModelProfile, Topology, plan_layout
    from edl_tpu_torch.parallel.planner import data_only_plan

    try:
        slices = tuple(int(s) for s in args.slices.split(",") if s)
        topology = Topology(
            slices=slices,
            chip_flops=args.chip_flops,
            hbm_bytes=args.hbm_gib * 2**30,
        )
        profile = ModelProfile(
            param_bytes=args.param_mb * 1e6,
            replicated_bytes=args.replicated_mb * 1e6,
            n_layers=args.layers,
            flops_per_sample=args.flops_per_sample,
            activation_bytes_per_microbatch=args.activation_mb * 1e6,
        )
        schedules = None
        if args.no_pipeline:
            schedules = ()
        chips = args.chips if args.chips else topology.chips
        plan = plan_layout(chips, topology, profile, args.global_batch,
                           schedules=schedules)
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    baseline = data_only_plan(chips, topology, profile, args.global_batch)
    if args.json:
        print(json.dumps(dict(plan.to_dict(),
                              data_only=baseline.to_dict()), indent=2))
        return 0
    print(f"plan for {chips} chips on slices {slices}, "
          f"batch {args.global_batch}:")
    print(f"  chosen   : {plan.describe()}  "
          f"({plan.step_seconds * 1e3:.3f} ms/step modeled)")
    base_ms = (f"{baseline.step_seconds * 1e3:.3f} ms"
               if baseline.feasible else f"infeasible ({baseline.reason})")
    print(f"  data-only: {baseline.candidate.describe()}  ({base_ms})")
    print()
    header = (f"  {'layout':<30} {'step_ms':>9} {'compute':>8} "
              f"{'bubble':>7} {'coll_ms':>8} {'p2p_ms':>7}  note")
    print(header)
    for sc in plan.table:
        d = sc.to_dict()
        step = f"{d['step_ms']:.3f}" if d["step_ms"] is not None else "-"
        note = "" if sc.feasible else f"INFEASIBLE: {sc.reason}"
        if sc.feasible and sc.candidate.axes == plan.mesh_axes \
                and sc.candidate.schedule == plan.schedule \
                and sc.candidate.microbatches == plan.microbatches:
            note = "<- chosen"
        print(f"  {d['layout']:<30} {step:>9} {d['compute_ms']:>8.3f} "
              f"{d['bubble_fraction']:>7.3f} {d['collective_ms']:>8.3f} "
              f"{d['p2p_ms']:>7.3f}  {note}")
    return 0


def cmd_train(args) -> int:
    import numpy as np

    from edl_tpu_torch import models as model_zoo
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    model = model_zoo.get(args.model)
    trainer = Trainer(
        model, config=TrainerConfig(optimizer=args.optimizer, learning_rate=args.lr),
        device=args.device,
    )
    logging.getLogger("edl_tpu_torch.cli").info(
        "training %s on %s", args.model, trainer.device)
    state = trainer.init_state()
    rng = np.random.default_rng(args.seed)

    def batches():
        for _ in range(args.steps):
            yield model.synthetic_batch(rng, args.batch_size)

    state, metrics = trainer.run(state, batches())
    print(json.dumps({k: round(v, 4) for k, v in metrics.items()}))
    return 0


def cmd_serve(args) -> int:
    """Run one serving replica over an exported artifact until Ctrl-C."""
    from edl_tpu_torch.serving import ServingConfig, ServingReplica

    client = None
    if args.coordinator:
        from edl_tpu_torch.coordinator.client import CoordinatorClient

        host, _, port = args.coordinator.partition(":")
        client = CoordinatorClient(host, int(port or 7164), worker=args.name,
                                   token=args.token)
    config = ServingConfig(
        model_dir=args.model_dir,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        max_batch_delay_s=args.max_batch_delay / 1000.0,
        port=args.port,
        name=args.name,
        version_poll_s=args.version_poll,
        device=args.device,
    )
    replica = ServingReplica(config, client=client).start()
    log = logging.getLogger("edl_tpu_torch")
    log.info("serving %s at %s (buckets %s); Ctrl-C to stop",
             args.model_dir, replica.url, config.buckets)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        return 0
    finally:
        replica.stop()


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: every subcommand and flag, each subcommand's
    handler as ``fn``."""
    parser = argparse.ArgumentParser(prog="edl-tpu-torch",
                                     description="elastic training framework on the card")
    parser.add_argument("--log-level", default="info",
                        choices=["debug", "info", "warning", "error"])
    parser.add_argument("--log-format", default="text",
                        choices=["text", "json"],
                        help="json = one JSON object per log line "
                             "(machine-parsed pod logs)")
    # Accept --log-level on either side of the subcommand (deploy manifests
    # put flags after it, k8s-style). SUPPRESS keeps the child from
    # overwriting a value parsed by the root.
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--log-level", default=argparse.SUPPRESS,
                        choices=["debug", "info", "warning", "error"])
    common.add_argument("--log-format", default=argparse.SUPPRESS,
                        choices=["text", "json"])
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("validate", help="admission-check a TrainingJob YAML",
                       parents=[common])
    p.add_argument("-f", "--file", required=True)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("run", help="run a TrainingJob on an in-process control plane",
                       parents=[common])
    p.add_argument("-f", "--file", required=True)
    p.add_argument("--max-load-desired", type=float, default=0.97)
    p.add_argument("--timeout", type=float, default=600.0)
    p.add_argument("--collect-period", type=float, default=10.0)
    _add_nodes_flags(p)
    _add_backend_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("controller", help="run the control plane", parents=[common])
    p.add_argument("--max-load-desired", type=float, default=0.97)
    p.add_argument("--collect-period", type=float, default=10.0)
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve /metrics + /healthz on this port (0 = ephemeral)")
    _add_nodes_flags(p)
    _add_backend_flags(p)
    p.set_defaults(fn=cmd_controller)

    p = sub.add_parser("status", help="query a running coordinator's counters",
                       parents=[common])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7164)
    p.add_argument("--token", default=None,
                   help="job auth token (default: $EDL_COORD_TOKEN)")
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--json", action="store_true", help="print the raw status reply")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("serve",
                       help="serve an exported artifact (continuous batching)",
                       parents=[common])
    p.add_argument("--model-dir", required=True,
                   help="export directory (versioned LATEST or flat layout)")
    p.add_argument("--buckets", default="1,8,32",
                   help="comma-separated batch bucket ladder")
    p.add_argument("--port", type=int, default=8476,
                   help="HTTP port for /predict + /metrics (0 = ephemeral)")
    p.add_argument("--max-batch-delay", type=float, default=5.0,
                   help="batch coalesce window, milliseconds (0 = off)")
    p.add_argument("--version-poll", type=float, default=0.25,
                   help="LATEST-pointer poll period, seconds")
    p.add_argument("--name", default="serve-0",
                   help="replica name (coordinator member + KV status key)")
    p.add_argument("--coordinator", default="",
                   help="host:port to publish status to (optional)")
    p.add_argument("--token", default=None,
                   help="job auth token (default: $EDL_COORD_TOKEN)")
    p.add_argument("--device", default=None,
                   help="device to serve on (default: the card; 'cpu' asks "
                        "for the CPU)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "plan",
        help="score hybrid-parallel layouts for a chip count (cost model)",
        parents=[common])
    p.add_argument("--slices", default="8,8",
                   help="cards per NVLink node, comma-separated (the fabric)")
    p.add_argument("--chips", type=int, default=0,
                   help="chips to plan for (default: all of --slices)")
    p.add_argument("--global-batch", type=int, default=1024)
    p.add_argument("--param-mb", type=float, default=400.0,
                   help="ZeRO-shardable parameter megabytes")
    p.add_argument("--replicated-mb", type=float, default=0.0,
                   help="megabytes of leaves that stay replicated")
    p.add_argument("--layers", type=int, default=1,
                   help="stackable layer count (bounds pipeline depth)")
    p.add_argument("--flops-per-sample", type=float, default=0.0,
                   help="train-step FLOPs per sample (0 = collective-bound)")
    p.add_argument("--activation-mb", type=float, default=0.0,
                   help="stage-boundary activation megabytes per microbatch")
    p.add_argument("--chip-flops", type=float, default=H100_PEAK_BF16_TFLOPS * 1e12,
                   help="a card's peak FLOP/s (default: the H100's bf16 peak)")
    p.add_argument("--hbm-gib", type=float, default=80.0,
                   help="a card's memory, GiB")
    p.add_argument("--no-pipeline", action="store_true",
                   help="search dp shapes only (no pipeline schedules)")
    p.add_argument("--json", action="store_true",
                   help="dump the full scored table as JSON")
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("train", help="train a zoo model locally", parents=[common])
    p.add_argument("--model", default="fit_a_line")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="device to train on (default: the card; 'cpu' asks "
                        "for the CPU)")
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from edl_tpu_torch.obs.logs import configure_logging

    configure_logging(level=args.log_level, fmt=args.log_format)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
