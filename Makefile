# Developer entry points. The analyze target is the same command CI and
# pre-commit run; exit 1 means new findings or stale baseline entries.

PYTHON ?= python

ANALYZE_SCOPE = edl_tpu edl_tpu/serving edl_tpu/serving/kvcache.py edl_tpu/serving/router.py edl_tpu/ckpt_plane edl_tpu/parallel/planner.py edl_tpu/runtime/compile_cache.py bench.py bench_rescale.py bench_pipeline.py bench_coord.py bench_collective.py bench_serve.py

.PHONY: analyze analyze-json baseline test chaos chaos-composed chaos-preempt lint obs-smoke serve-smoke serve-lm-smoke ckpt-plane-smoke modelcheck modelcheck-native tsan-smoke bench-coord-smoke bench-replan-smoke bench-spot-smoke verify bench-pipeline bench-coord bench-collective bench-serve

analyze:
	$(PYTHON) -m edl_tpu.analysis $(ANALYZE_SCOPE)

analyze-json:
	$(PYTHON) -m edl_tpu.analysis $(ANALYZE_SCOPE) --format json

## Regenerate accepted-debt baseline — only after consciously accepting or
## fixing findings; the diff IS the review artifact.
baseline:
	$(PYTHON) -m edl_tpu.analysis edl_tpu --write-baseline

test:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/ -q -m 'not slow'

## Fault-injection suite: every chaos-marked test, INCLUDING the slow
## process-kill soaks tier-1 skips.
chaos:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/ -q -m chaos

## Composed cross-axis chaos: trainer SIGKILL x apiserver 409/410 x
## coordinator partitions, overlapping under one scripted ChaosScenario.
## Exercises the adaptive fault-tolerance policy end to end (blips
## reconnect in place, the storm checkpoint-and-parks) — see
## doc/robustness.md. Sanitizer-compatible: run with
## EDL_COORD_SANITIZER=tsan to put the native coordinator under TSan.
chaos-composed:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/test_chaos_composed.py -q -m chaos

## Revocation wave: two jobs revoked by one scripted ChaosScenario; both
## drain inside their notice with steps_lost == 0 and exact step
## accounting, and the fault timeline replays from its JSON spec.
chaos-preempt:
	JAX_PLATFORMS=cpu $(PYTHON) -m pytest tests/test_chaos_preempt.py -q

## Telemetry-plane deploy gate: boots a worker with its /metrics endpoint
## against a real coordinator, scrapes over HTTP while training runs, and
## asserts every required metric family (worker, client, bridged
## coordinator) is present. See doc/observability.md.
obs-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) -m edl_tpu.obs

## Serving-path deploy gate: exports a real artifact, boots a ServingReplica
## with its HTTP frontend, pushes requests through POST /predict, swaps a
## model version mid-traffic, then scrapes /metrics and asserts the latency
## + queue-depth families (the autoscaler's signals), zero dropped requests,
## and the empty-jit-dispatch-cache AOT contract. See doc/serving.md.
serve-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) -m edl_tpu.serving

## LM-serving deploy gate: exports a small transformer, boots an
## LMServingReplica (prefill + decode AOT-compiled per (batch bucket, seq
## bucket)), decodes a concurrent prompt batch through POST /generate,
## then asserts zero dropped streams, exact token accounting, the
## edl_lm_* metric families, a fully-recycled KV block pool, and the
## empty-jit-dispatch-cache contract across both phases. See
## doc/serving.md ("LM serving").
serve-lm-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) -m edl_tpu.serving lm

## Checkpoint-plane deploy gate: trains a twin, replicates ZeRO shards to
## the coordinator's memory-resident store, kills the live state, peer-
## restores (zero blob reads) and finishes — final loss must EQUAL the
## twin's. Then drops a whole replica group and proves recovery demotes to
## the blob store with the identical result. See doc/robustness.md.
ckpt-plane-smoke:
	XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
		$(PYTHON) -m edl_tpu.ckpt_plane

## Protocol behavior gate: bounded explicit-state exploration of every
## interleaving of the default faulty 2-worker schedule (crash+restart,
## duplicate delivery, batch frame) PLUS the EDL010 durability schedules
## (crash points between persistence effects: clean / pre-ack / torn tail
## / during compaction, recovery replay as a schedule step), each trace
## replayed against the in-process oracle (the durability rows use its
## file-backed persistence twin). Exit 1 on any invariant violation
## (epoch monotonicity, exactly-once across crash, acked-implies-durable,
## lease exclusivity, progress) or model/oracle divergence. See
## doc/analysis.md (EDL009 + EDL010).
modelcheck:
	JAX_PLATFORMS=cpu $(PYTHON) -m edl_tpu.analysis.modelcheck --timings

## Crash-injected native oracle lane: the same durability schedules, but
## every trace replays against the REAL edl-coordinator binary — the
## modeled crash point is realized by env-gated _exit(2) hooks in
## coordinator.cc (EDL_COORD_CRASH_AFTER_APPENDS / _CRASH_TORN /
## _CRASH_IN_SNAPSHOT), with a genuine kill + recovery-from-disk per
## trace. Proves the C++ journal replay (torn-tail truncation, dedup
## rebuild, snapshot+suffix equivalence) matches the model bit-for-bit.
## TSan-aware (EDL_COORD_SANITIZER=tsan instruments the binary); skips
## cleanly when no C++ toolchain is installed.
modelcheck-native:
	@if ! command -v $${CXX:-g++} >/dev/null 2>&1; then \
		echo "modelcheck-native: no C++ toolchain ($${CXX:-g++} not found) — skipping"; \
	else \
		JAX_PLATFORMS=cpu $(PYTHON) -m edl_tpu.analysis.modelcheck \
			--native --timings; \
	fi

## Native race gate: rebuild the coordinator under ThreadSanitizer and rerun
## the sanitizer-marked lane (chaos/outage/batch/hammer tests) against it.
## EDL_COORD_SANITIZER=tsan makes every CoordinatorServer in the run spawn
## the instrumented binary; a TSan report fails the child (exitcode=66) and
## the tests assert sanitizer_report() is clean. Skips cleanly when no C++
## toolchain is installed.
tsan-smoke:
	@if ! command -v $${CXX:-g++} >/dev/null 2>&1; then \
		echo "tsan-smoke: no C++ toolchain ($${CXX:-g++} not found) — skipping"; \
	else \
		EDL_COORD_SANITIZER=tsan JAX_PLATFORMS=cpu \
			$(PYTHON) -m pytest tests/ -q -m 'sanitizer and not slow'; \
	fi

## Bench-harness deploy gate: a <60 s slice of bench_coord.py — both
## topologies (single vs sharded, N=500, multiplexed connections) plus a
## fast pull-vs-push epoch-propagation pair — written to a throwaway path
## with plausibility assertions (every cell beats, push faster than pull).
## Catches harness rot without paying for the full sweep; skips cleanly
## when the native toolchain is absent.
bench-coord-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) bench_coord.py --smoke

## Replanner deploy gate: the live 8->6->8 rescale-with-layout-change arm
## ({dcn:2,data:4} -> {data:6} -> back through join/leave/re-join) plus the
## modeled sweep (planner must STRICTLY beat data-only resize at every
## point). Asserts the return leg is served by the persistent AOT compile
## cache (warm_compile ~ 0, compile_cache_hits_total >= 1) and every leg's
## recovery is phase-attributed; merges replan_arm/replan_sweep into
## BENCH_RESCALE.json + RESCALE_TIMELINE.json.
bench-replan-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) bench_rescale.py --replan

## Spot-revocation arm only: a worker revoked mid-training drains inside
## its notice (steps_lost == 0, peer-sourced restore on the shrunk
## replanned mesh); merges spot_arm into BENCH_RESCALE.json +
## RESCALE_TIMELINE.json.
bench-spot-smoke:
	JAX_PLATFORMS=cpu $(PYTHON) bench_rescale.py --spot

## Everything a PR must pass: static analysis (EDL001-EDL010 vs baseline +
## protocol_schema.json ratchet), tier-1 tests, protocol + durability model
## checks (in-process AND crash-armed native oracle), serving smoke, TSan
## lane, revocation-wave chaos, bench-harness smokes (coordinator +
## replanner + spot drain). Tier-2 (slow, run before cutting a release):
## `make chaos` / `make chaos-composed`.
verify: analyze test modelcheck modelcheck-native serve-smoke serve-lm-smoke ckpt-plane-smoke tsan-smoke chaos-preempt bench-coord-smoke bench-replan-smoke bench-spot-smoke

## Pipeline-schedule crossover sweep at CPU-sim scale; regenerates
## BENCH_PIPELINE.json (the artifact behind BENCH_NOTES.md's table).
bench-pipeline:
	$(PYTHON) bench_pipeline.py

## Coordinator control-plane load bench at 100/1k/10k simulated workers;
## regenerates BENCH_COORD.json (doc/performance.md, control-plane section).
bench-coord:
	$(PYTHON) bench_coord.py

## Data-plane collective arms (implicit psum / explicit reduce-scatter /
## bucketed-overlap accumulation) on flat + hierarchical meshes;
## regenerates BENCH_COLLECTIVE.json (doc/performance.md, data-plane section).
bench-collective:
	$(PYTHON) bench_collective.py

## Serving-tier arms: open-loop load vs batching-on/off, per-bucket-config
## p50/p99 + QPS/chip, and rescale-under-traffic (replica added + drained
## mid-load, zero dropped requests); regenerates BENCH_SERVE.json.
bench-serve:
	$(PYTHON) bench_serve.py

lint: analyze

## The PyTorch port (edl_tpu_torch): its analyzer, tests and CPU deploy
## gates, the on-card smoke and the port's images. These targets name only
## the port; the JAX package's targets above name only edl_tpu.
.PHONY: analyze-torch test-torch obs-smoke-torch serve-smoke-torch serve-lm-smoke-torch ckpt-plane-smoke-torch modelcheck-torch chip-smoke images-torch verify-torch

## Static analysis of the port against its own accepted-debt baseline (the
## scope and baseline of tests/test_torch_analysis.py's repo gate).
analyze-torch:
	$(PYTHON) -m edl_tpu_torch.analysis edl_tpu_torch --baseline edl_tpu_torch/analysis/baseline.json

## The port's CPU tests (each held against the JAX package where it has a
## counterpart; tests marked cuda skip without a card).
test-torch:
	$(PYTHON) -m pytest tests/test_torch_*.py -q -m 'not slow'

## The port's deploy gates on the CPU: the telemetry plane, the batch and LM
## serving tiers, the checkpoint plane, and the protocol model check.
obs-smoke-torch:
	$(PYTHON) -m edl_tpu_torch.obs --device cpu

serve-smoke-torch:
	$(PYTHON) -m edl_tpu_torch.serving --device cpu

serve-lm-smoke-torch:
	$(PYTHON) -m edl_tpu_torch.serving lm --device cpu

ckpt-plane-smoke-torch:
	$(PYTHON) -m edl_tpu_torch.ckpt_plane --device cpu

modelcheck-torch:
	$(PYTHON) -m edl_tpu_torch.analysis.modelcheck --timings

## Every phase of the port on one card (needs a CUDA device and nvcc; run
## from the repo root): builds the kernels, holds each against its plain
## version, trains, serves, and runs the LM job from the trainer image's
## staged file tree.
chip-smoke:
	python3 chip_smoke.py

## The port's controller and trainer images (needs docker and network
## access; see deploy/torch/).
images-torch:
	sh deploy/torch/build.sh

## Everything of the port that runs on the CPU.
verify-torch: analyze-torch test-torch modelcheck-torch obs-smoke-torch serve-smoke-torch serve-lm-smoke-torch ckpt-plane-smoke-torch
