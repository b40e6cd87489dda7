"""The serve smokes: ``python -m edl_tpu_torch.serving`` (batch tier) and
``python -m edl_tpu_torch.serving lm`` (LM tier), on the CUDA device unless
``--device cpu`` is given.

Boots the serving tier end to end the way a pod would see it: export a real
artifact (versioned layout, atomic ``LATEST``), start a
:class:`ServingReplica` with its HTTP frontend, push requests through ``POST
/predict`` over real sockets, then scrape `/metrics` and assert

- the metric families the JAX package's autoscaler and router read
  (`REQUIRED_FAMILIES`) are present,
- every bucket was warmed before the first request and no other dispatch
  shape was used (``jit_cache_size() == 0``),
- a model-version swap landed mid-traffic with zero dropped requests.

The ``lm`` mode does the same for the LM tier: export a small transformer,
boot an :class:`LMServingReplica`, decode a prompt batch through ``POST
/generate`` concurrently, then assert zero dropped streams, exact token
accounting, the LM metric families (`REQUIRED_LM_FAMILIES`), a
fully-recycled KV block pool, and ``jit_cache_size() == 0`` across both
phases.

Exit 0 only when all of it holds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

#: a scrape missing any of these means the serving telemetry regressed —
#: the first two are the autoscaler's inputs (the JAX package's tuple)
REQUIRED_FAMILIES = (
    "edl_serve_request_latency_seconds",
    "edl_serve_queue_depth",
    "edl_serve_requests_total",
    "edl_serve_batches_total",
    "edl_serve_model_step",
    "edl_serve_model_swaps_total",
)

#: the LM tier's telemetry contract — the first two are the LM autoscaler's
#: inputs, the KV families the router's affinity source
REQUIRED_LM_FAMILIES = (
    "edl_lm_token_latency_seconds",
    "edl_lm_kv_occupancy",
    "edl_lm_tokens_total",
    "edl_lm_kv_blocks_free",
    "edl_lm_prefill_batch_size",
    "edl_lm_decode_batch_size",
    "edl_lm_decode_steps_total",
)

N_REQUESTS = 48
N_STREAMS = 12
MAX_NEW_TOKENS = 8
LM_KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_ff=64,
             seq_len=64, flash=False)


def _post(url: str, payload: dict, timeout: float = 30.0) -> dict:
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _report(name: str, failures, ok_line: str) -> int:
    if failures:
        print(f"{name} FAILED:")
        for f in failures:
            print(f"  - {f}")
        return 1
    print(f"{name} OK: {ok_line}")
    return 0


def main_lm(device) -> int:
    import numpy as np
    import torch

    from edl_tpu_torch.models import transformer
    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import parse_prometheus
    from edl_tpu_torch.runtime.export import save_inference_model
    from edl_tpu_torch.serving import LMServingConfig, LMServingReplica

    module = transformer.make_model(**LM_KW).build(
        device="cpu", generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as td:
        art_dir = os.path.join(td, "artifact")
        save_inference_model(art_dir, "transformer", module, config=LM_KW, step=100)
        replica = LMServingReplica(LMServingConfig(
            model_dir=art_dir, batch_buckets=(1, 4), seq_buckets=(16, 32),
            kv_blocks=32, kv_block_tokens=8, port=0, name="smoke-lm",
            device=device)).start()
        try:
            cache0 = replica.jit_cache_size()
            rng = np.random.default_rng(0)
            prompts = [rng.integers(1, 60, size=3 + i % 9).tolist()
                       for i in range(N_STREAMS)]

            def one_stream(prompt):
                return _post(replica.url + "/generate",
                             {"prompt": prompt, "max_new_tokens": MAX_NEW_TOKENS})

            # concurrent submission: streams join and leave the decode
            # batch at step boundaries, not request boundaries
            with ThreadPoolExecutor(max_workers=6) as pool:
                results = list(pool.map(one_stream, prompts))
            status = replica.status()
            families = parse_prometheus(scrape_metrics(replica.url))
        finally:
            replica.stop()

    failures = []
    short = [r for r in results
             if len(r["tokens"]) != MAX_NEW_TOKENS or r["finish_reason"] != "length"]
    if short:
        failures.append(f"{len(short)}/{N_STREAMS} streams returned wrong "
                        f"token counts: {short[:2]}")
    missing = [f for f in REQUIRED_LM_FAMILIES if f not in families]
    if missing:
        failures.append(f"missing LM metric families: {missing}")
    cache_now = replica.jit_cache_size()
    if cache0 != 0 or cache_now != 0:
        failures.append(f"unwarmed dispatch shapes (start={cache0}, end={cache_now})")
    if status["completed"] != N_STREAMS or status["rejected"]:
        failures.append(f"dropped/rejected streams: {status}")
    kv = status["kv"]
    if kv["used_blocks"] != 0 or kv["free_blocks"] != kv["n_blocks"]:
        failures.append(f"KV block pool leaked: {kv}")
    expected = N_STREAMS * MAX_NEW_TOKENS
    if status["tokens_generated"] != expected:
        failures.append(f"token accounting off: generated "
                        f"{status['tokens_generated']}, expected {expected}")
    return _report("serve-lm-smoke", failures, (
        f"{N_STREAMS} streams x {MAX_NEW_TOKENS} tokens over HTTP /generate on "
        f"{replica._art.device}, 0 dropped, KV pool fully recycled (peak "
        f"{kv['peak_blocks_used']}/{kv['n_blocks']} blocks), no unwarmed "
        f"shape across prefill+decode, {len(REQUIRED_LM_FAMILIES)} required "
        f"families present"))


def main(device) -> int:
    import numpy as np
    import torch

    from edl_tpu_torch.models import fit_a_line
    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import parse_prometheus
    from edl_tpu_torch.runtime.export import save_inference_model
    from edl_tpu_torch.serving import ServingConfig, ServingReplica

    module = fit_a_line.MODEL.build(device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory() as td:
        art_dir = os.path.join(td, "artifact")
        save_inference_model(art_dir, "fit_a_line", module, step=100, versioned=True)
        replica = ServingReplica(ServingConfig(
            model_dir=art_dir, buckets=(1, 4, 16), max_batch_delay_s=0.002,
            port=0, version_poll_s=0.05, name="smoke-serve",
            device=device)).start()
        try:
            cache0 = replica.jit_cache_size()
            rng = np.random.default_rng(0)
            ok = 0
            for i in range(N_REQUESTS):
                reply = _post(replica.url + "/predict", {"features": {
                    "x": rng.standard_normal(13).tolist()}}, timeout=10)
                if np.isfinite(np.asarray(reply["outputs"])).all():
                    ok += 1
                if i == N_REQUESTS // 2:
                    # rolling swap mid-traffic: publish a newer artifact and
                    # keep the requests flowing
                    scaled = {k: v * 1.5 for k, v in module.state_dict().items()}
                    save_inference_model(art_dir, "fit_a_line", scaled,
                                         step=200, versioned=True)
            deadline = time.monotonic() + 5
            while replica.status()["swaps"] < 1 and time.monotonic() < deadline:
                time.sleep(0.05)
            status = replica.status()
            families = parse_prometheus(scrape_metrics(replica.url))
        finally:
            replica.stop()

    failures = []
    if ok != N_REQUESTS:
        failures.append(f"{N_REQUESTS - ok}/{N_REQUESTS} requests failed")
    missing = [f for f in REQUIRED_FAMILIES if f not in families]
    if missing:
        failures.append(f"missing metric families: {missing}")
    cache_now = replica.jit_cache_size()
    if cache0 != 0 or cache_now != 0:
        failures.append(f"unwarmed dispatch shapes (start={cache0}, end={cache_now})")
    if status["swaps"] < 1 or status["model_step"] != 200:
        failures.append(f"model swap did not land: {status}")
    if status["completed"] != N_REQUESTS or status["errors"]:
        failures.append(f"dropped/errored requests: {status}")
    if sum(status["bucket_hits"].values()) <= 0:
        failures.append("no batches dispatched")
    return _report("serve-smoke", failures, (
        f"{ok} requests over HTTP on {replica._art.device}, bucket hits "
        f"{status['bucket_hits']}, {status['swaps']} rolling swap(s) to step "
        f"{status['model_step']}, no unwarmed shape, {len(REQUIRED_FAMILIES)} "
        f"required families present"))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m edl_tpu_torch.serving",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("tier", nargs="?", choices=("batch", "lm"), default="batch")
    parser.add_argument("--device", default=None,
                        help="where the replica runs (default: the CUDA device)")
    args = parser.parse_args()
    sys.exit(main_lm(args.device) if args.tier == "lm" else main(args.device))
