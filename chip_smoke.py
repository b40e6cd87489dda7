#!/usr/bin/env python3
"""Drive the PyTorch port (``edl_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout on a machine with one CUDA device:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # phases 1-3 only: build, check, time, sweep
    python3 chip_smoke.py --lm-d128  # phases 1-3 and lm_d128 (the LM at head dim 128)
    python3 chip_smoke.py --lm-d256  # phases 1-3 and lm_d256 (the LM at head dim 256)
    python3 chip_smoke.py --lm-d512  # phases 1-3 and lm_d512 (the LM at head dim 512)
    python3 chip_smoke.py --kernels --tile-table PATH  # also write the sweep's winners
    python3 chip_smoke.py --mp       # phases 1-3 and 14 (mp) only
    python3 chip_smoke.py --elastic  # phases 1-3 and 13 (elastic) only
    python3 chip_smoke.py --entries  # phases 1-4 and 15 (entries) only
    python3 chip_smoke.py --deploy   # phases 1 and 16 (deploy) only
    python3 chip_smoke.py --controller  # phases 1-3 and 17 (controller) only
    python3 chip_smoke.py --chaos    # phases 1-3 and 18 (chaos) only
    python3 chip_smoke.py --turns ROOT  # time the f32 forward of the checkout at ROOT

``--turns`` compares two trees on one card: run it on each in turn, parent,
tree, tree, parent, each in a process of its own (`turns_main`).

It imports nothing of JAX and nothing of ``edl_tpu``. Phases, in order (each
phase's wall seconds printed as it ends, and all of them in a
``{"phase_seconds": ...}`` line); a phase that fails raises, and the script
exits non-zero without its last line:

1. Device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them; turns TF32 off for f32 matmuls
   and convolutions.
2. Build: compiles the CUDA sources for ``sm_90a``, one ``nvcc`` process
   a unit, all at once (each unit's seconds printed), prints ptxas's
   registers and spills of every variant, and counts with ``cuobjdump
   -sass`` (on a thread while phase 3 runs, checked after it) each
   kernel's wgmma (``HGMMA``), TMA load (``UTMALDG``), mbarrier
   (``SYNCS``), ``mma.sync`` (``HMMA``), f32 FMA (``FFMA``) and
   local-memory load and store (``LDL``, ``STL``) instructions and the
   highest register it names, beside ptxas's line; every bf16 and f16
   flash kernel must have wgmma and TMA loads and no ``mma.sync``, the
   variants of all three kernels up to 256 and of the three sliced ones (a
   producer warpgroup and two consumer warpgroups with setmaxnreg, so
   ptxas reports their registers at launch) no local-memory access and no
   spill, and every variant compiled
   for head dims up to 256 and the sliced ones past 256
   (``flash_sliced.cuh``) must be in the library; every variant of the
   three f32 kernels (3xTF32, setmaxnreg: up to 128, up to 256, and sliced
   past 256) must have ``mma.sync`` and TMA loads and neither local-memory
   access nor spill.
3. Kernels: each of the three flash-attention kernels against its plain
   PyTorch version on the same inputs (the forward at every tile compiled
   for the case), at the slice's shape, the deploy phase's trainer's shape
   (``DEPLOY_ATTENTION``, D 32), a ragged shape, the ring's offset
   cases (with an lse cotangent), cases with rows that see no key (one with
   a whole 128-row query block that sees none), head dims 8, 16, 32, 40,
   80, 96, 128, 136, 192, 200 and 256 (at 256 a whole 64-row block that
   sees no key, and a 128-row block whose first 64 rows see none), past 256 through the sliced kernels 264, 320, 512, 576
   and 1024, f16 at 64, 128, 192, 256, 320 and 512, f32 at 40, 64, 128,
   192, 200, 256, 264, 512, 576 and 1024 (and at 64, 256 and 512 with each
   row's maximum rising in every key tile, in the tile's last 32 keys:
   ``RISING_MAX_CASES``), and fewer queries than keys, row by row
   and element by element, f32 outputs also within the f32 bound
   (``TOL_ROW_F32``, ``TOL_ELEM_F32``), which the plain versions on inputs
   rounded to TF32 must fail at every f32 case; the JAX on-chip check's
   five cases (``ONCHIP_CASES``) through `flash_attention`, forward and
   backward, against the plain forward in f32 within that check's relative
   errors (2e-3 f32, 3e-2 bf16); views the kernels' loads cannot read,
   copied or padded by the wrapper and served (``SERVED_VIEWS``), each
   backward kernel call held against the plain backward on its own inputs;
   then proof that the comparison rejects two planted faults (one key tile
   left out for the later query tiles; the later rows off by 2 %) at the
   slice's shape, at D 128, at the D-256 LM's attention and a ragged D-256
   ring case, and at the D-512 LM's attention; then
   the ring's
   per-hop engine on one card:
   the slice's q, k, v cut into 2 and 4 blocks, each query block's offset
   hops through the kernels with ``return_lse=True`` merged by the ring's
   ``merge_hops``, output and gradients against the plain full causal
   attention; then each kernel's time (``ms``: one call at a time;
   ``ms_back_to_back``: ten launches in a row), its wrapper's host time a
   call (and, at the slice's shape, the whole backward's, inputs checked
   once), its plain version's time, one library call's (timed both ways)
   and the card's bound, at the slice's shape (bf16 and f16, D 64), the
   deploy phase's trainer's attention (bf16, D 32), the D-128 LM's
   attention (bf16 and f16), the D-256 LM's attention (bf16 and
   f16) and the same shape at D 192 (bf16 and f16), the D-512 LM's attention
   (bf16), and the JAX check's D-128 shape (bf16) and its f32 shape, also
   at D 128, 192, 256 and 512 (each f32 row with its FMA and its 3xTF32
   bound, the smaller its bound), with whether SDPA's flash backend takes
   each and which of SDPA's backends serves it; then the
   tile sweep (``SWEEP_SHAPES``): every compiled forward tile timed,
   forward and forward plus backward, the winners printed (and written as
   a tile table with ``--tile-table PATH``), and the wrapper must resolve
   each shape to the committed table's tile, and the D-256 shape to its one
   compiled tile.
4. The LM: the GPT-2-small-width transformer LM (12 layers, d_model 768,
   seq 1024, vocab 32000, batch 8) trained by the ``Trainer`` with Adam at lr
   3e-4 on one repeated synthetic batch. Losses must be finite and fall, and
   each kernel's launch count over the timed steps must be 12 x steps. Then
   one more step under ``torch.profiler``: its device time by kernel. Then
   the step profiler on the card (the entries phase's part (c),
   `profiler_on_card`): one step under `tools.profiler.trace`, whose
   written trace must name the three flash kernels; `device_memory_stats()`
   against ``torch.cuda.max_memory_allocated``; `Trainer.run` over 22 steps
   with a `StepProfiler`, its host-clock step p50 and MFU beside the
   synchronised step.
   Then the ``moe`` phase: the same LM with 8 experts at capacity factor
   1.25, in two arms from one seed (top-1 without aux, top-2 with aux
   0.01). A no-grad forward before the first step gives each layer's
   dropped share and aux and layer 0's input ``h``; on that ``h`` the index
   form of the MoE FFN is held against its einsum form (slot buffers and
   output bit for bit, aux and gradients within tolerance), and in the
   top-2 arm the check must reject a planted fault (a second choice served
   ahead of a first choice). Then the timed steps (12 launches of each
   flash kernel a step, a finite, falling loss), a profiled step split by
   MoE function, and the einsum form's steps timed as a diagnostic.
5. The same width at depth 2, one step through the kernels and one through
   the plain attention path from the same weights: loss and every gradient
   compared. Then the ``lm_d128`` phase: the LM at Pythia-1.4B's widths
   (d_model 2048, 16 heads, so head dim 128; d_ff 8192, seq 2048, vocab
   50304) at 12 of its 24 layers, batch 4, Adam at 3e-4, trained by the
   ``Trainer``: finite, falling losses over 5 timed steps, exactly 12
   launches of each kernel a step, all of the D-128 bf16 variants; a
   profiled step (tokens/s, MFU, peak memory, each kernel's device ms a
   call, the busy share); the same widths at depth 2 through the kernels
   and the plain path; and the ring's per-hop engine at its attention
   shape. Then the ``lm_d256`` phase, the same at GPT-J-6B's widths
   (d_model 4096, 16 heads, so head dim 256; d_ff 16384, seq 2048, vocab
   50400) at 4 of its 28 layers: 4 launches of each kernel a step, all of
   the D-256 bf16 variants. Then the
   ``lm_d512`` phase, the same widths with 8 heads, so head dim 512, at 12
   layers: 12 calls of each sliced kernel a step, all of the D-512 bf16
   variants (one launch a call: two 256-column slices of O and of dK and
   dV, one 512-column slice of dQ).
6. CTR, the flagship, at its published width (tables of 1000192 rows,
   embed 10, MLP 400-400-400) and batch 8192, trained with adagrad at lr
   0.05: a finite, falling loss; the padded table rows and a sample of rows
   no id reaches bit for bit unchanged; step ms, samples/s, MFU, peak
   memory and the profiled step's busy share and top device ops.
7. CTR on the card against the port on the CPU: the same state_dict and a
   batch of 1024, the loss and each param's update after one adagrad step.
8. The data path (``data_path``): CTR at phase 6's width and batch, fed
   from 4 shard files (the port's ``write_shard``) through an
   ``InProcessCoordinator``, ``LeaseReader(prefetch=True)`` and
   ``FileShardSource(shuffle_seed=1)`` into a Trainer with wire transport
   and ``pipeline_depth=2``: every lease completed, none pending. Then three
   arms from the same weights on the same batches, interleaved: raw
   transport synchronous, wire synchronous, wire with depth 2. The wire arms
   must agree bit for bit (if a probe finds the card's embedding backward
   deterministic; else to ``TOL_NONDETERMINISTIC``), raw within
   ``TOL_RAW_WIRE``; the card's decode must equal the host's. Each arm's
   samples/s, placement time a step and profiled busy share, and the wire
   bytes a step. Arm (c) saves a checkpoint mid-run and trains on; a fresh
   Trainer restores it and its next two losses must equal the run's. Then
   the LM of phase 4 with ``grad_accum_microbatches=4`` against 1 from the
   same weights: first loss, every gradient, four times the flash launches
   a step, lower peak memory, step times.
9. fit_a_line, word2vec, MNIST and ResNet-50 (224 px, batch 64) at their
   default widths, 10 timed steps each: a finite, falling loss and the same
   numbers as CTR's.
10. The LM of phase 4 with ``remat=True``: the flash forward launched
    twice a block (fwd 240, dq 120, dkv 120 over the timed steps), lower
    peak memory and the same losses as phase 4's.
11. Serve (`edl_tpu_torch.serving`): phase 4's LM, exported right after
    its run, served by an ``LMServingReplica`` on the card to 16 streams in
    three staggered waves (four through HTTP ``/generate``), each to its
    full token count; its decode held against a re-prefill per token on the
    card (tokens and K/V cache), which must reject a planted fault (the new
    K/V written one slot late), and against the port's prefill on the CPU;
    prefill and decode step times, tokens/s, TTFT and a profiled window of
    decode steps. Then phase 6's CTR, exported right after its run, served
    by a ``ServingReplica`` to 512 single-row requests (16 through HTTP
    ``/predict``), with version 2 (two more adagrad steps) exported
    mid-traffic and swapped in with no failed request; every answer against
    the module's ``predict``. The serving path launches no flash kernel.
Phases 12-16 run at once, in groups of processes of their own
(``PHASE_GROUPS``: 13's part (c) then 12; 13's parts (a) and (b) then 14;
15 then 16; each group ``chip_smoke.py --phases JOB``, its standard output
printed whole as it ends), so that their processes' start-ups overlap;
their times are taken beside the other groups' load. Phases 17 and 18 run
after them, each alone.

12. Data parallelism (``dp``): (a) an NCCL process group at world 1,
    formed by the port's ``distributed_init`` against an
    ``InProcessCoordinator``, and over it a ``Mesh``; phase 4's LM and
    phase 6's CTR each trained from seed 0 on one batch by the one-device
    Trainer and by the mesh Trainer with ``shard_opt_state`` in both
    grad_sync modes (2 warm-up and 5 timed steps and a profiled step an
    arm): losses, params and moments bit for bit against the one-device
    run (CTR: if the card's embedding backward is deterministic), 60
    launches of each flash kernel in each mesh arm's timed steps, each
    arm's step time, peak memory and busy share, and ``data_plane()`` for
    8 ranks (analytic). (b) Two ranks on the one card over gloo with CUDA
    tensors, one process each (``chip_smoke.py --dp-rank R JOB``): both
    rows at world 2 (CTR's tables 500096 rows a rank), the same global
    batch, in both modes; every rank's losses equal, within
    ``TOL_DP_LOSS`` of (a)'s one-device losses, the two modes' params
    equal; CTR exported from both ranks (rank 0 writes) and served on one
    device against the ranks' own predict; a checkpoint saved at world 2
    and restored bit for bit. A rank that fails fails the phase.
13. Elasticity (``elastic``): (a) the ``ElasticWorker`` on the card
    against an ``InProcessCoordinator``, its membership driven from
    ``step_callback``: CTR at phase 6's width over 6 shards of 8 batches
    (a second member registers after step 10 and leaves after step 30:
    rescales 1 -> 2 and 2 -> 1), then phase 4's LM over 3 shards of 4
    batches (a join after step 6). Each rescale must carry all eight
    ``RESCALE_PHASES`` under its trace id and restore bit for bit the
    state its barrier saved (params and moments); every shard done, none
    queued or leased; finite, falling losses; the LM's flash launches 12 a
    forward (its steps' and each warm-up's) and 12 a backward kernel a
    step. The LM row's layout comes from the planner (``plan_layout`` over
    one card with the H100 defaults and the LM's profile): every ``replan``
    span carries its plan, and its modeled step time is printed beside the
    measured one. Printed: each rescale's recovery and warm-up seconds, its
    phases' seconds, the checkpoint's bytes and samples/s before and
    after. (b) The CTR entry (``python -m edl_tpu_torch.examples.ctr.train
    --dist-backend auto``) under two ``python -m edl_tpu_torch.launcher``
    processes against the native ``CoordinatorServer`` (built with
    ``make``): two ranks on the one card over gloo (4096 rows and 500096
    table rows a rank, ZeRO-1 moments), a checkpoint a round; once one
    covers a round, SIGTERM to rank 1's launcher. Rank 1 leaves at a round
    boundary and exits 0, rank 0 exits 75 once and is relaunched, forms a
    world-1 group (NCCL, as ``auto`` picks), restores the world-2
    checkpoint and drains the queue: both launchers exit 0, every shard
    done, the world-1 incarnation trains exactly the shards its restored
    checkpoint lacked, and that checkpoint (hard-linked as it landed)
    restores into a world-1 Trainer bit for bit. Printed: recovery (epoch
    move to the world-1 incarnation's first round plan), each
    incarnation's start-up, a world-2 round's and a world-1 step's time.
    Then the checkpoint plane's smoke (``python -m edl_tpu_torch.ckpt_plane``
    on the card): the twin, the peer restore and the group death's blob
    fallback, the last two exactly the twin's loss. (c) The LM entry at
    phase 4's width at ``RANKS_LM_LAYERS`` (4) of its 12 layers (``--axes
    {"pipe": 2}`` interleaved, v 2, 4
    microbatches, ``--zero1``) under four launchers: four ranks on the
    card over gloo as ``{"data": 2, "pipe": 2}``, each running the entry
    through ``chip_smoke.py --el-mp-entry`` (its steps' flash launches,
    losses and times recorded, its restore held against the checkpoint it
    read), a checkpoint a round; once one covers a round, SIGTERM to both
    launchers of data index 1. They exit 0; ranks 0 and 1 exit 75 once and
    come back as ``{"data": 1, "pipe": 2}``, restore the world-4
    checkpoint bit for bit (ZeRO-1 moments regrouped) and drain the queue:
    every shard done, the world-2 incarnation trains exactly the shards the
    restored checkpoint lacked, every rank's losses equal within an
    incarnation, finite and falling, each step's flash launches on each
    rank exactly `mp_expected_launches` (16/8/8) at both worlds, and that
    checkpoint restores bit for bit into a one-device Trainer too.
    Printed: recovery, each incarnation's start-up, a world-4 round and
    step, a world-2 step, each rank's peak memory.
14. Model parallelism (``mp``): phase 4's LM at its full width and
    ``MP_LAYERS`` (4) of its 12 layers trained by the mesh Trainer on
    ranks that share the one card, one process a rank over gloo with CUDA
    tensors (``chip_smoke.py --mp-rank R JOB``):
    (a) ``{"seq": 2}``, the flash ring; (b) ``{"model": 2}``; (c)
    ``{"pipe": 2}`` GPipe, (d) 1F1B and (e) interleaved 1F1B (v 2), each
    at 4 microbatches; (f) ``{"expert": 2}``, the MoE phase's arm B (8
    experts, top-2, aux 0.01); (g) ``{"seq": 2, "model": 2}`` on four
    ranks. Each arm from the seed-0 params of a one-device run on the same
    global batch, one warm-up and three timed steps: every rank's losses
    equal and within ``TOL_MP_LOSS`` of the one-device Trainer's, each
    leaf's first-step gradient (a rank's part, after the reductions)
    within ``TOL_MP_GRAD`` of the one-device gradient's part, and each
    step's flash launches on each rank exactly the arm's count
    (`mp_expected_launches`: in (a) 2 hops x 4 layers of the forward, and
    twice that of each backward kernel, which a hop's f32 dO runs twice).
    Printed: each rank's step time and peak memory, rank 0's busy share
    from one profiled step, and ``data_plane()`` (analytic). A rank that
    fails fails the phase.
15. The zoo's other entries (``entries``): (a) each entry as a
    subprocess in local mode on the card (``python -m
    edl_tpu_torch.examples.<name>.<file>``, the independent ones at once):
    fit_a_line ``train_local`` and ``train_elastic`` at their defaults,
    MNIST ``train`` then ``infer`` (accuracy above 0.9), ResNet tiny
    ``train`` then ``infer`` (above 0.2), ResNet-50 ``--imagenet`` at batch
    64 over 6 shards of 4 batches (run through ``chip_smoke.py
    --entry-record``, which writes its per-step losses: all finite, the
    last shard's mean below the first's), word2vec ``train_ft`` (80 steps,
    79 steady profiled steps, final loss below 7.7); the JAX example
    tests' bounds. (b) The word2vec entry under two launchers against the
    native coordinator (the harness of phase 13's part (b),
    `churn_two_launchers`): two ranks on the card over gloo, the table
    row-sharded over ``data``, 16 shards, a checkpoint a round, SIGTERM to
    rank 1 once one covers a round; rank 0 exits 75, is relaunched at
    world 1, restores and drains the queue, every shard trained exactly
    once into the final state; recovery and start-up seconds printed. (c)
    Is phase 4's step profiler part. (d) The obs smoke, ``python -m
    edl_tpu_torch.obs`` on the card, exits 0. The phase's own seconds are
    printed.
16. Deploy (``deploy``): first, alone before the groups start (its
    ``nvcc`` processes would load the host under their start-up times),
    the trainer image's file tree, staged from this
    checkout in a temporary root by `stage_deploy` and `stage_image`, which applies
    ``deploy/torch/Dockerfile.trainer``'s WORKDIR, ENV and COPY lines
    there (``/usr/local/bin`` under the root, first on PATH) and runs its
    RUN lines, each timed: ``make -C native/coordinator`` and the kernels'
    bake (``_build.build()``, nvcc only) for real, the apt-get and pip
    lines checked on the host instead (each package's command on PATH,
    each module imported, torch at the pinned version); an instruction it
    does not know fails the phase. Then, in group 3, the port's LM manifest
    (``edl_tpu_torch/examples/lm/job.yaml``, loaded from the staged tree
    and validated) runs through the port's `Controller` over a
    `ProcessCluster` of one node of one card, in a process of its own
    (``chip_smoke.py --deploy-drive JOB``) whose working directory and
    only PYTHONPATH are the staged WORKDIR, with the overrides it prints
    and no others (one card, one trainer, no model axes, 2 shards, a free
    port, the checkpoint dir and workspace under the root, the
    coordinator at 127.0.0.1): the coordinator pod runs the jobparser's
    default, ``edl-launch start_coordinator``, through the staged shim,
    the trainer the manifest's entrypoint unchanged. Holds: the job
    Succeeded; the trainer's metrics line shows the expected steps and a
    finite loss, the line before it its flash launches, each kernel steps
    x layers (the forward twice: ``--remat``), all bf16 at D 32 (the kernels line's
    D-32 rows carry them as ``launches`` and ``launches_deploy``); the
    coordinator ran the staged binary; the baked library
    and libcuda were mapped into the trainer while it trained (its
    ``/proc/<pid>/maps``); no pod compiled (the baked library, its log
    and the coordinator binary unchanged, no ``*.objs``). Printed: each
    RUN line's seconds, the seconds from the trainer pod's process start
    to its first step's loss (the entry's ``first_step_at``) and to the
    library's mapping (its first flash call; polled every 50 ms), the
    steps, the loss, the launches and the overrides.
17. The control plane (``controller``): the port's `Controller` over a
    `ProcessCluster` of three one-chip nodes, all three the one card. (a)
    ``lm-grow`` (2..3 trainers: the LM entry at phase 4's width and 4
    layers, batch 8 a
    rank, gloo, 30 shards of one batch, a checkpoint a round) trains at
    world 2 while another tenant's accounting-only pod holds the third
    chip; once a round is committed that pod leaves, and the autoscaler
    alone grows the job 2 -> 3 (``edl/expected_world`` 3, the third pod
    spawned, the epoch nudged, both ranks exit 75 and come back at world
    3). (b) Once every world-3 rank has stepped, ``w2v-admit`` (one
    trainer, the word2vec entry, 4 shards) pends; the make-room pass
    shrinks lm-grow 3 -> 2 (``edl/expected_world`` 2; the newest pod gets
    SIGTERM and leaves at a round boundary, the others exit 75 and return
    at world 2); w2v-admit is placed and trains; once it ends, the
    autoscaler may grow lm-grow back to 3. Every trainer runs under
    ``chip_smoke.py --ctl-entry``, which records its restore, reads, steps
    and exit. Holds: the scale records (2, 3) then (3, 2), both jobs and
    every pod Succeeded, every LM shard trained exactly once into the final
    state, each LM step's flash launches 4/4/4 on every rank at worlds
    2 and 3, finite losses, the collector's samples at 2/3, then 3/3, then
    3/3 with both jobs, no pod's process group left. (c) The CLI: ``python
    -m edl_tpu_torch train --model transformer --steps 4 --batch-size 8``
    with no ``--device`` trains on the card, ``status --json`` answers
    against lm-grow's coordinator while it trains, ``plan --json`` with the
    H100 defaults exits 0. Printed: each scale decision's actuation latency
    (the record to the first step at the new world on every rank, split
    into the slowest rank's start-up and the rest), the LM's step ms at
    each world, each incarnation's peak memory, w2v-admit's wait from
    submit to its first step, the collector's samples and the wall time.
18. Composed chaos (``chaos``), the port's counterpart of
    ``tests/test_chaos_composed.py`` at phase 4's width and 4 layers: two
    LM jobs, each
    with its own native coordinator at the launcher's 10 s heartbeat TTL,
    under one `ChaosScenario` whose every fault gates on observed
    progress. Alpha (the SIGKILL axis) is the LM entry under the port's
    launcher as one `ProcessCluster` trainer pod (``--ctl-entry`` records
    it); once a shard has committed, `kill_pod` SIGKILLs its process group
    and `restart_failed` starts a replacement, which restores the durable
    checkpoint and drains the queue. Beta (the partition axis) is an
    `ElasticWorker` on the card whose client goes through the port's
    `ChaosProxy`, with the adaptive fault-tolerance policy, started once
    alpha is killed: three blips, each healed once beta has seen 1.2 s of
    it, then a storm held until beta has parked and its ``/metrics`` and
    ``/healthz`` have been scraped, then the heal. An unfaulted twin of
    beta trains on the card first, while alpha's pod starts. Holds: both queues done exactly once (the
    coordinators' ``status()``; alpha's lineage through its generations),
    beta's policy took at least two modes (three reconnects and a park, each
    decision a span), its audit record in the KV, beta's extra steps over
    the twin in [0, one shard's batches] and its final loss within rel
    0.05 of the twin's (the JAX test's bounds), 4 launches of each flash
    kernel every step of alpha, beta and the twin. Printed: alpha's
    kill-to-first-step recovery and its start-up share, beta's blip rides
    and its park decision, the steps and losses, the fired timeline's
    spec.
19. One JSON line ``{"kernels": [...]}`` (a row per kernel and variant
    timed, with its ``head_dim`` and ``dtype``), one ``{"kernel_checks":
    {...}}`` (the build's seconds, the JAX check's cases, the sweep), one
    ``{"phase_seconds": {...}}``, one ``{"zoo": [...]}`` (a row per model,
    the remat LM included), one ``{"lm_d128": {...}}``, one ``{"lm_d256":
    {...}}``, one ``{"lm_d512": {...}}``, one ``{"serve": {...}}``, one
    ``{"data_path": {...}}``, one ``{"moe": {...}}``, one ``{"dp":
    {...}}``, one ``{"elastic": {...}}``, one ``{"mp": {...}}``, one
    ``{"entries": {...}}``, one ``{"deploy": {...}}``, one ``{"controller":
    {...}}`` and one ``{"chaos": {...}}``.
20. The last line: ``{"ok": true, "device": {...}}``.

No process the script starts outlives it. It makes itself the reaper of
its orphaned descendants (``PR_SET_CHILD_SUBREAPER`` on its own process):
a pod's trainer whose launcher was SIGKILLed, a coordinator whose pod
leader left first. When it ends, passed or failed, it SIGKILLs and reaps
every descendant still there and reaps the zombies of those that ended
(`stop_descendants`); it names on its standard error any it found alive.

Every step time here is the host clock around one ``train_step`` and a
``torch.cuda.synchronize()``: the median of the timed steps after
``WARMUP_STEPS`` steps. MFU is `edl_tpu_torch.tools.mfu`'s: the model's
analytic FLOPs over the card's dense bf16 peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

#: NVIDIA H100 SXM data sheet: dense bf16 (and fp16) tensor-core peak, f32
#: outside the tensor cores (the f32 FMA bound), dense TF32 on the tensor
#: cores (an f32 product in 3xTF32 takes three: 165 TFLOP/s of f32 work),
#: and the HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12

#: kernel vs plain version, both on the card, compared row by row (a row is
#: one query's or one key's D outputs), so that the late rows of a causal
#: run, whose values are far smaller than the first rows', are held as
#: tightly: each row's ||kernel - plain|| / ||plain|| <= TOL_ROW, and each
#: element's |kernel - plain| <= TOL_ELEM * (|plain| + the rms of its row).
#: O, dQ, dK and dV are bf16 (one rounding: up to 2^-8 of the value), and the
#: kernels round P and dS to bf16 before their second product where the
#: plain version stays f32 (about 1e-3 of a row's norm, as a random walk of
#: roundings of up to 2^-9). A row's norm counts as at least ROW_FLOOR of the
#: tensor's rms row norm: a row that cancels to zero in exact arithmetic
#: (query 0 of a causal run has dQ = 0, as delta equals its one dP) is held
#: to rounding, not to its own vanishing size. Rows that are zero by the mask
#: (a query that sees no key, a key that no query sees) must be exactly zero.
TOL_ROW = 1e-2
TOL_ELEM = 2**-5
ROW_FLOOR = 1e-2
#: lse is f32 from f32 statistics in both versions (summation order only);
#: absolute, since an error in lse is a relative error of the softmax's sum
TOL_LSE = 1e-4
#: every f32 kernel output is also held to f32, by the same metrics: the
#: kernels multiply in 3xTF32 (about 2^-21 a product), where one TF32
#: rounding of the inputs (2^-11) puts a row off by 2e-3 to 5e-1 (the
#: planted TF32 fault, `tf32_fault_outputs`, which must fail the bound). A
#: kernel that
#: sums in another order is off the f32 plain version by the plain version's
#: own rounding, largest in a row whose dq cancels (the ROW_FLOOR clamp
#: weighs it): the function in f64 is off it by 6.8e-5 of a row at the D-512
#: case and 1.4e-3 at the D-512 LM shape. So an output's f32 bound
#: (`f32_bounds`) is the larger of TOL_*_F32 and F32_OWN_HEADROOM times the
#: plain version's own error against the function in f64 (`_exact_outputs`)
TOL_ROW_F32 = 1e-4
TOL_ELEM_F32 = 2e-4
F32_OWN_HEADROOM = 4
#: the planted faults that the comparison must reject at the slice's shape:
#: key tile FAULT_K_TILE left out for query tiles FAULT_Q_TILE and later, and
#: the rows of those query tiles (keys, for dK and dV) off by FAULT_SCALE
FAULT_K_TILE, FAULT_Q_TILE, FAULT_SCALE = 3, 8, 0.02
#: depth-2 step, kernel path against the plain attention path (dense_attention)
#: from the same weights: both round P to bf16 before P·V, at different
#: places, and the bf16 residual stream carries the difference through two
#: layers. Loss relative error, and each gradient's relative norm error.
TOL_STEP_LOSS = 2e-2
TOL_STEP_GRAD = 5e-2

#: the LM at Pythia-1.4B's widths (EleutherAI/pythia-1.4b ``config.json``:
#: hidden_size 2048, num_attention_heads 16, intermediate_size 8192,
#: max_position_embeddings 2048, vocab_size 50304), so head dim 128; the rest
#: is the repo's LM (learned positions, RMSNorm, a GELU FFN, an untied f32
#: head). num_hidden_layers 24 is cut to 12, for the script's time limit
#: (PERF.md §4). Batch 4, Adam at 3e-4, remat off, 2 warm-up and 5 timed steps
LM_D128 = dict(d_model=2048, n_layers=12, n_heads=16, d_ff=8192, seq_len=2048,
               vocab_size=50304)
LM_D128_BATCH = 4
LM_D128_STEPS = 5
#: its attention's causal (B, S, H, D)
LM_D128_ATTENTION = (4, 2048, 16, 128)
#: the attention of the deploy phase's trainer, the LM manifest's entry at
#: its defaults (batch 8, ``--seq-len 4096``, 8 heads of d_model 256): the
#: bf16 kernels at a padded head dim of 32
DEPLOY_ATTENTION = (8, 4096, 8, 32)

#: the LM at GPT-J-6B's widths (EleutherAI/gpt-j-6b ``config.json``: n_embd
#: 4096, n_head 16, n_inner null so 4 x 4096, n_positions 2048, vocab_size
#: 50400), so head dim 256, with the repo's LM's blocks as above. n_layer 28
#: is cut to 4, for the script's time limit once lm_d512 runs too (12 until
#: then; 28 layers' f32 parameters, gradients and Adam moments alone take 97
#: GB, past the card's 80 GB). Batch 4, Adam at 3e-4, remat off, 2 warm-up
#: and 5 timed steps
LM_D256 = dict(d_model=4096, n_layers=4, n_heads=16, d_ff=16384, seq_len=2048,
               vocab_size=50400)
LM_D256_BATCH = 4
LM_D256_STEPS = 5
#: its attention's causal (B, S, H, D)
LM_D256_ATTENTION = (4, 2048, 16, 256)
#: the D-192 kernels are timed at that shape with head dim 192
D192_ATTENTION = (4, 2048, 16, 192)

#: the LM at lm_d256's widths with 8 heads in place of 16, so head dim 512,
#: the head_dim of DeepSeek-V4-Flash's ``config.json`` (hidden_size 4096,
#: head_dim 512). Not a public model: DeepSeek-V4 pairs that head dim with
#: shared K/V heads, and no public model with full multi-head attention has
#: a head dim past 256, so this is the repo's own LM (full multi-head
#: attention, head_dim = d_model // n_heads) at that head dim. 12 layers,
#: cut from GPT-J-6B's 28 for memory as lm_d256 was (the same parameters,
#: 2.84 B, and state). Batch 4, Adam at 3e-4, remat off, 2 warm-up and 5
#: timed steps
LM_D512 = dict(d_model=4096, n_layers=12, n_heads=8, d_ff=16384, seq_len=2048,
               vocab_size=50400)
LM_D512_BATCH = 4
LM_D512_STEPS = 5
#: its attention's causal (B, S, H, D): the D-256 LM's FLOPs (H·D is equal)
LM_D512_ATTENTION = (4, 2048, 8, 512)
#: the f32 kernels are timed at the JAX check's f32 (B, S, H) at these head
#: dims too, and these rows and f16 at the D-256 and D-512 LMs' attention,
#: which no model runs, over OFF_PATH_REPS runs a time (the rest over 20)
F32_TIMED_HEAD_DIMS = (128, 192, 256, 512)
OFF_PATH_REPS = 5

SLICE = dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072, seq_len=1024,
             vocab_size=32000)
BATCH = 8
STEPS = 10
WARMUP_STEPS = 2
#: the remat LM against the remat-off LM from the same seed and batch: the
#: recompute runs the same kernels on the same inputs, so each step's loss
#: agrees to this relative error
TOL_REMAT_LOSS = 1e-5

#: CTR at its published width (`models/ctr.py`): sparse dim 1000001, padded
#: to a multiple of 256, and the benchmark's batch
CTR_BATCH = 8192
CTR_PADDED_ROWS = 1000192
#: rows of each table that no id of the batch reaches, sampled and held bit
#: for bit over the run, besides the padded rows
UNTOUCHED_ROWS = 4096
#: CTR on the card against the port on the CPU, one batch of PARITY_BATCH:
#: both run the MLP in bf16 with their own roundings (cuBLAS against the
#: CPU's), and the table gradient's duplicate ids add up in another order on
#: the card (atomics). The loss's relative error, and each param's update
#: after one adagrad step as a relative norm error; the LM's tolerances
PARITY_BATCH = 1024
TOL_CTR_LOSS = 2e-2
TOL_CTR_UPDATE = 5e-2
#: the other zoo models at their default widths: (batch, optimizer, lr)
ZOO = {
    "fit_a_line": (1024, "sgd", 0.1),
    "word2vec": (1024, "adam", 1e-2),
    "mnist": (256, "adam", 1e-3),
    "resnet50": (64, "adam", 1e-3),
}
#: device ops listed per profiled step
TOP_OPS = 10
#: launches in a row for the back-to-back kernel and library timings
BACK_TO_BACK = 10

KERNELS = {  # name -> (plain version, TPU kernel it replaces)
    "fwd": ("_fwd_reference", "edl_tpu/ops/flash_attention.py:88"),
    "bwd_dq": ("_bwd_dq_reference", "edl_tpu/ops/flash_attention.py:178"),
    "bwd_dkv": ("_bwd_dkv_reference", "edl_tpu/ops/flash_attention.py:219"),
}
SOURCE = "edl_tpu_torch/ops/csrc/flash_kernels.cuh"
SOURCE_SLICED = "edl_tpu_torch/ops/csrc/flash_sliced.cuh"
#: the f32 kernels up to a head dim of 256 and past it (3xTF32 on the tensor
#: cores), by kernel
SOURCE_F32 = {"fwd": "edl_tpu_torch/ops/csrc/flash_fwd_f32.cu",
              "bwd_dq": "edl_tpu_torch/ops/csrc/flash_bwd_dq_f32.cu",
              "bwd_dkv": "edl_tpu_torch/ops/csrc/flash_bwd_dkv_f32.cu"}
SOURCE_F32_SLICED = {"fwd": "edl_tpu_torch/ops/csrc/flash_fwd_f32_sliced.cu",
                     "bwd_dq": "edl_tpu_torch/ops/csrc/flash_bwd_dq_f32_sliced.cu",
                     "bwd_dkv": "edl_tpu_torch/ops/csrc/flash_bwd_dkv_f32_sliced.cu"}
FLASH_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
#: the 16-bit kernels past a head dim of 256 (wgmma and TMA, column slices)
FLASH_SLICED_NAMES = ("flash_fwd_sliced_kernel", "flash_bwd_dq_sliced_kernel",
                      "flash_bwd_dkv_sliced_kernel")
#: the f32 kernels, up to a head dim of 256 and past it
FLASH_F32_NAMES = ("flash_fwd_f32_kernel", "flash_bwd_dq_f32_kernel",
                   "flash_bwd_dkv_f32_kernel")
FLASH_F32_SLICED_NAMES = ("flash_fwd_f32_sliced_kernel", "flash_bwd_dq_f32_sliced_kernel",
                          "flash_bwd_dkv_f32_sliced_kernel")
#: the f32 kernels, up to a head dim of 256 and past it: 3xTF32 on the
#: tensor cores (mma.sync, HMMA), fed by TMA
FLASH_TF32_NAMES = FLASH_F32_NAMES + FLASH_F32_SLICED_NAMES
#: the ring's hop counts held on one card: the merged (out, lse) of this many
#: offset hops against the plain full attention (1: one kernel call on the
#: whole sequence, the baseline)
MERGED_HOPS = (1, 2, 4)
#: the merged hops' gradients against the plain full attention's: here the
#: backward's delta comes from the kernels' own forward output, not the
#: plain one as in the cases above, so the forward's error (the o check:
#: 2.7e-3 of a row) enters dS on every key of a row, and where a row's dq
#: nearly cancels (down to the ROW_FLOOR clamp) it weighs most. A forward
#: whose O was off by a scale (normalised by the sum of the unrounded P
#: while P·V multiplied the rounded P) made that up to 7.7e-2 of a row at D
#: 256; the forward now divides by the rounded P's sum, and one kernel call
#: on the whole sequence measured dq within 5.5e-3 of a row at D 64, 128 and
#: 256 on an H100 (PERF.md). Bounds for that composed path, and the ring's
#: decomposition may add at most a quarter to the one-call baseline's error
TOL_COMPOSED_ROW = 5e-2
TOL_COMPOSED_ELEM = 2**-4
COMPOSED_HOPS_OVER_ONE = 1.25
#: kernel -> (its function in the library, the design it is built on)
DESIGNS = {
    "fwd": ("flash_fwd_kernel", "wgmma+TMA, a producer warpgroup and two consumer warpgroups "
                                "(setmaxnreg), 128 rows a block, ping-pong"),
    "bwd_dq": ("flash_bwd_dq_kernel", "wgmma+TMA, a producer warpgroup and two consumer "
                                      "warpgroups (setmaxnreg), 128 rows a block, ping-pong"),
    "bwd_dkv": ("flash_bwd_dkv_kernel", "wgmma+TMA, a producer warpgroup and two consumer "
                                        "warpgroups (setmaxnreg), dV and dK in one pass"),
}
#: SASS instructions counted per kernel: wgmma, TMA tile load, mbarrier,
#: mma.sync, the f32 kernels' fused multiply-add, and local-memory loads and
#: stores (spills)
SASS_OPS = ("HGMMA", "UTMALDG", "SYNCS", "HMMA", "FFMA", "LDL", "STL")
#: the kernels that run a producer warpgroup and two consumer warpgroups
#: with setmaxnreg (the 16-bit ones of csrc/flash_kernels.cuh up to a padded
#: head dim of 256 and of csrc/flash_sliced.cuh past it, and the f32 ones
#: at every head dim): ptxas reports their registers at launch
#: (168), so their SASS must show no local-memory load or store, and ptxas
#: no spill
SETMAXNREG_NAMES = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                    "flash_fwd_sliced_kernel", "flash_bwd_dq_sliced_kernel",
                    "flash_bwd_dkv_sliced_kernel") + FLASH_TF32_NAMES

#: (name, (B, Sq, Sk, H, D), causal, q_offset, k_offset, return_lse, fused,
#: dtype): ``fused`` cases take q, k and v as strided slices of one
#: (B, S, 3, H, D) tensor, as the model hands them over
CASES = [
    ("slice", (8, 1024, 1024, 12, 64), True, 0, 0, False, True, "bfloat16"),
    ("ragged", (2, 300, 300, 2, 64), False, 0, 0, False, True, "bfloat16"),
    ("ragged_causal", (2, 300, 300, 2, 64), True, 0, 0, False, True, "bfloat16"),
    ("ring_diagonal", (2, 300, 300, 2, 64), True, 300, 300, True, False, "bfloat16"),
    ("ring_past", (2, 300, 300, 2, 64), True, 300, 0, True, False, "bfloat16"),
    ("no_key_rows", (1, 200, 200, 2, 64), True, 0, 69, True, False, "bfloat16"),
    # queries 0-199 see no key: the first 128-row dq block sees none, the
    # second has one warpgroup that sees none; keys 100-299 are seen by none
    ("no_key_block", (1, 300, 300, 2, 64), True, 0, 200, True, False, "bfloat16"),
    ("head_dim_8", (1, 100, 100, 2, 8), True, 0, 0, False, True, "bfloat16"),
    ("head_dim_16", (1, 100, 100, 2, 16), True, 0, 0, False, True, "bfloat16"),
    ("head_dim_32", (1, 100, 100, 2, 32), False, 0, 0, False, True, "bfloat16"),
    # the deploy phase's trainer, at the shape its entry gives the kernels
    ("deploy", (DEPLOY_ATTENTION[0], DEPLOY_ATTENTION[1], *DEPLOY_ATTENTION[1:]), True, 0, 0,
     False, True, "bfloat16"),
    # fewer queries than keys, the queries late in the sequence
    ("uneven", (1, 100, 260, 2, 32), True, 160, 0, True, False, "bfloat16"),
    # head dims past 64: 40 runs the D-64 kernels with its last 24 columns
    # loaded as zeros, 80 and 96 the D-128 ones with 48 and 32; ragged S, the
    # ring's offsets, an lse cotangent and rows that see no key
    ("head_dim_40", (2, 300, 300, 2, 40), True, 0, 0, True, True, "bfloat16"),
    ("head_dim_80_ring_past", (2, 300, 300, 2, 80), True, 300, 0, True, False, "bfloat16"),
    ("head_dim_96_ring_diagonal", (1, 300, 300, 2, 96), True, 300, 300, True, False,
     "bfloat16"),
    ("head_dim_128_ragged", (2, 300, 300, 2, 128), False, 0, 0, False, True, "bfloat16"),
    ("head_dim_128_no_key_block", (1, 300, 300, 2, 128), True, 0, 200, True, False,
     "bfloat16"),
    ("head_dim_128_uneven", (1, 100, 260, 2, 128), True, 160, 0, True, False, "bfloat16"),
    # head dims past 128: 136 runs the D-192 kernels with its last 56 columns
    # loaded as zeros, 200 the D-256 ones with 56; ragged S, the ring's
    # offsets, an lse cotangent, rows that see no key (at D 256 a whole
    # 64-row block), fewer queries than keys, fused slices
    ("head_dim_136_ring_past", (2, 300, 300, 2, 136), True, 300, 0, True, False, "bfloat16"),
    ("head_dim_192_ring_diagonal", (1, 300, 300, 2, 192), True, 300, 300, True, False,
     "bfloat16"),
    ("head_dim_192_no_key_rows", (1, 200, 200, 2, 192), True, 0, 69, True, False, "bfloat16"),
    ("head_dim_200_uneven", (1, 100, 260, 2, 200), True, 160, 0, True, False, "bfloat16"),
    ("head_dim_256_ragged", (2, 300, 300, 2, 256), False, 0, 0, False, True, "bfloat16"),
    ("head_dim_256_no_key_block", (1, 300, 300, 2, 256), True, 0, 200, True, True,
     "bfloat16"),
    ("f16_head_dim_64", (2, 300, 300, 2, 64), True, 0, 69, True, False, "float16"),
    ("f16_head_dim_128", (2, 300, 300, 2, 128), True, 300, 300, True, True, "float16"),
    ("f16_head_dim_192", (2, 300, 300, 2, 192), True, 0, 69, True, False, "float16"),
    ("f16_head_dim_256", (2, 300, 300, 2, 256), True, 300, 300, True, True, "float16"),
    ("f32_no_key_rows", (1, 200, 200, 2, 64), True, 0, 69, True, False, "float32"),
    ("f32_head_dim_128", (1, 300, 300, 2, 128), True, 300, 0, True, False, "float32"),
    ("f32_head_dim_192", (1, 300, 300, 2, 192), True, 0, 69, True, False, "float32"),
    ("f32_head_dim_256", (1, 300, 300, 2, 256), True, 300, 0, True, False, "float32"),
    # head dims past 256, through the sliced kernels: 264 has a last 64-column
    # chunk of 8 columns and a second O slice of one chunk, 576 a short last
    # slice of O (64 columns) and of dK and dV, 1024 four O slices and eight
    # dK/dV slices; ragged S, the ring's offsets, an lse cotangent, rows that
    # see no key (a whole 64-row block), fewer queries than keys, fused slices
    ("head_dim_264_ring_past", (2, 300, 300, 2, 264), True, 300, 0, True, False, "bfloat16"),
    ("head_dim_320_no_key_block", (1, 300, 300, 2, 320), True, 0, 200, True, True,
     "bfloat16"),
    ("head_dim_512_ragged", (2, 300, 300, 2, 512), False, 0, 0, False, True, "bfloat16"),
    ("head_dim_512_ring_diagonal", (1, 300, 300, 2, 512), True, 300, 300, True, False,
     "bfloat16"),
    ("head_dim_576_uneven", (1, 100, 260, 2, 576), True, 160, 0, True, False, "bfloat16"),
    ("head_dim_1024_no_key_rows", (1, 200, 200, 2, 1024), True, 0, 69, True, True,
     "bfloat16"),
    ("f16_head_dim_320", (2, 300, 300, 2, 320), True, 0, 69, True, False, "float16"),
    ("f16_head_dim_512", (2, 300, 300, 2, 512), True, 300, 300, True, True, "float16"),
    ("f32_head_dim_264", (1, 300, 300, 2, 264), True, 300, 0, True, False, "float32"),
    ("f32_head_dim_512", (1, 300, 300, 2, 512), True, 0, 69, True, False, "float32"),
]
#: the planted faults are also rejected at D 128, at the JAX on-chip check's
#: D-128 shape, at D 256, at the GPT-J-width LM's attention, and at D 512,
#: at lm_d512's
FAULT_CASES = (CASES[0], ("jax_check_d128", (1, 2048, 2048, 8, 128), True, 0, 0, False, True,
                          "bfloat16"),
               ("lm_d256", (4, 2048, 2048, 16, 256), True, 0, 0, False, True, "bfloat16"),
               ("lm_d512", (4, 2048, 2048, 8, 512), True, 0, 0, False, True, "bfloat16"))

#: cases and planted faults checked after the ring's merged hops, so that
#: every check before them draws the inputs it drew before they were added
#: (the composed checks' bounds are tight for a few rows of some draws:
#: PERF.md §7). The forward's 128-row block at D 256: in the first block,
#: queries 0-63 (consumer warpgroup 0) see no key and queries 64-127
#: (warpgroup 1) do; and the planted faults at D 256 at a ragged length with
#: the ring's offsets and an lse cotangent
LATE_CASES = [
    ("head_dim_256_no_key_warpgroup", (1, 300, 300, 2, 256), True, 0, 64, True, False,
     "bfloat16"),
    # the f32 backward past 256 (3xTF32): fewer queries than keys and a short
    # last slice of dQ (64 of 512 columns) and of dK and dV (64 of 256); two
    # slices of dQ and four of dK and dV, rows that see no key, fused slices
    ("f32_head_dim_576_uneven", (1, 100, 260, 2, 576), True, 160, 0, True, False, "float32"),
    ("f32_head_dim_1024_no_key_rows", (1, 200, 200, 2, 1024), True, 0, 69, True, True,
     "float32"),
    # the f32 backward up to 256 (3xTF32, all D columns a block): a last
    # 32-column chunk of 8 columns (D 40, fused slices; D 200 with fewer
    # queries than keys), and at D 256 a whole 64-key block that no query sees
    ("f32_head_dim_40", (2, 300, 300, 2, 40), True, 0, 0, True, True, "float32"),
    ("f32_head_dim_200_uneven", (1, 100, 260, 2, 200), True, 160, 0, True, False, "float32"),
    ("f32_head_dim_256_no_key_block", (1, 300, 300, 2, 256), True, 0, 200, True, False,
     "float32"),
]
LATE_FAULT_CASES = (
    ("head_dim_256_ring_ragged", (2, 700, 700, 2, 256), True, 300, 300, True, False,
     "bfloat16"),
)
#: f32 cases whose rows' maximum rises in every 64-key tile and lies in the
#: tile's last 32 keys, those of the f32 forward's consumer warpgroup 1
#: (`rising_max`), so that every tile's alpha rescales O and warpgroup 0
#: takes its rows' maximum from warpgroup 1: at D 64 unmasked with a ragged
#: last tile, at D 256 causal, and at D 512 through the sliced kernel.
#: Checked last, so that every check before them draws what it drew before
RISING_MAX_CASES = [
    ("f32_rising_max_64", (2, 300, 300, 2, 64), False, 0, 0, True, False, "float32"),
    ("f32_rising_max_256", (1, 300, 300, 2, 256), True, 0, 0, True, False, "float32"),
    ("f32_rising_max_512", (1, 300, 300, 2, 512), False, 0, 0, True, False, "float32"),
]
#: k's first column rises by RISING_MAX_SLOPE·sqrt(D) a key and q's first
#: column is at least 1, so each row's scores rise by at least
#: RISING_MAX_SLOPE a key: about twice the scores' own spread of 1 over 32
#: keys, with the largest score near 85
RISING_MAX_SLOPE = 0.06
#: of the (row, key tile) pairs whose row sees a key of the tile's last 32,
#: the least share whose tile maximum lies there (97 % and more at these
#: shapes) and the least share whose maximum rises past the earlier tiles'
RISING_MAX_SHARES = (0.95, 0.99)

#: the JAX package's on-chip check (`onchip_flash_check.py:22-28`), letter
#: for letter: (B, S, H, D, causal, dtype). Each runs forward and backward
#: (loss sum(out²)) through `flash_attention` and through the plain forward
#: in f32 on the same inputs (autograd); out, dq, dk and dv are held to its
#: relative error (max |kernel - plain| / max |plain|) within its bounds, and
#: lse (``return_lse=True``) must be finite
ONCHIP_CASES = [
    (2, 1024, 4, 64, True, "float32"),
    (2, 1024, 4, 64, True, "bfloat16"),
    (1, 640, 2, 64, True, "float32"),
    (1, 2048, 8, 128, True, "bfloat16"),
    (2, 512, 4, 64, False, "float32"),
]
ONCHIP_TOL = {"float32": 2e-3, "bfloat16": 3e-2}

#: views the kernels' loads cannot read, which `flash_attention` pads or
#: copies first and then serves: (name, D of the view, how it is cut)
SERVED_VIEWS = [
    ("stride_not_16B", 64, "head stride 68 elements (136 bytes)"),
    ("odd_stride", 64, "start 2 bytes past an allocation, head stride 65"),
    ("head_dim_20", 20, "a head dim that is not a multiple of 8 (padded to 24)"),
]

#: the tile sweep (the counterpart of `onchip_flash_sweep.py`): the JAX
#: sweep's four (B, S, H, D) and the D-128 LM's attention, bf16, causal
SWEEP_SHAPES = [(4, 1024, 8, 64), (4, 2048, 8, 64), (2, 4096, 8, 64), (1, 8192, 8, 128),
                (4, 2048, 16, 128)]


class SmokeFailure(RuntimeError):
    pass


def timed(seconds: dict, name: str, fn, *args, **kw):
    """Run one phase, then print its wall seconds and record them in
    ``seconds`` under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    seconds[name] = time.perf_counter() - t0
    print(f"seconds: the {name} phase took {seconds[name]:.1f} s")
    return out


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, reps: int = 20, warmup: int = 3, batch: int = 1) -> float:
    """Device time of one call of ``fn`` in ms, by CUDA events: the median of
    ``reps`` runs after a warm-up. A run is one call by default, so the
    host's work for the call shows in its time; with ``batch`` > 1 it is
    ``batch`` calls in a row, divided by ``batch``, so that the host's work
    for a call overlaps the device's work as it does in a step."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def host_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Host time of one call of ``fn`` in ms: the wall clock over ``reps``
    calls in a row with no synchronisation between them (the wrapper's
    Python, ctypes and tensor-map work and the launch itself), after a
    warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def _flash_module():
    """The module ``edl_tpu_torch.ops.flash_attention`` (the package's
    attribute of that name is the function)."""
    import importlib

    return importlib.import_module("edl_tpu_torch.ops.flash_attention")


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(ms, what bounds it): the least time the card could take, at ``peak``
    FLOP/s and the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# -- phases --------------------------------------------------------------------


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    print(card())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False)")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    return torch.device("cuda", 0)


def phase_build() -> dict:
    """Build the library, each unit in its own nvcc process; print ptxas's
    registers and spills of every variant, and start counting its SASS on a
    thread, which `check_sass` finishes (the disassembly takes tens of
    seconds of host time, which phase 3's device work hides). Returns
    ``{"seconds", "ptxas", "sass_counting"}``."""
    from concurrent.futures import ThreadPoolExecutor

    from edl_tpu_torch.ops import _build

    fa = _flash_module()
    t0 = time.perf_counter()
    path = _build.build()
    fa._kernels()
    seconds = time.perf_counter() - t0
    print(f"build: {path.name} from {len(_build._sources())} units compiled at once in "
          f"{seconds:.1f} s")
    log = path.with_suffix(".log").read_text()
    ptxas = ptxas_usage(log)
    for (fn, label), use in sorted(ptxas.items()):
        print(f"  ptxas: {fn} {label}: {use['registers']} registers, {use['spill_stores']} "
              f"bytes spill stores, {use['spill_loads']} bytes spill loads")
    for line in log.splitlines():
        if "warning" in line or line.startswith("nvcc: "):
            print(f"  {line.strip()}")
    require("setmaxnreg ignored" not in log, "ptxas ignored setmaxnreg (the warp roles rejoin)")
    pool = ThreadPoolExecutor(max_workers=1)
    counting = pool.submit(sass_counts, path)
    pool.shutdown(wait=False)
    return {"seconds": seconds, "sass_counting": counting,
            "ptxas": {f"{fn} {label}": use for (fn, label), use in ptxas.items()}}


def check_sass(build: dict) -> None:
    """The build's SASS counts (`phase_build`'s thread), printed beside
    ptxas's line and held: every bf16 and f16 flash kernel has wgmma and TMA
    loads and no ``mma.sync``; every f32 kernel at every head dim
    (``FLASH_TF32_NAMES``) has ``mma.sync`` and TMA loads; the setmaxnreg
    kernels (``SETMAXNREG_NAMES``) have no local-memory load or store in
    their SASS and no spill in ptxas's line; and every compiled variant is in
    the library. Stores the counts in ``build["sass"]``."""
    import torch

    from edl_tpu_torch.ops import flash_tuning

    fa = _flash_module()
    counts = build.pop("sass_counting").result()
    for fn, by_variant in counts.items():
        for label, ops in sorted(by_variant.items()):
            use = build["ptxas"].get(f"{fn} {label}", {})
            print(f"  sass: {fn} {label} " + ", ".join(f"{op} {n}" for op, n in ops.items())
                  + f" (ptxas: {use.get('registers')} registers, {use.get('spill_stores')} "
                  f"bytes spill stores)")
    for fn in FLASH_NAMES + FLASH_SLICED_NAMES:
        require(fn in counts, f"{fn} is not in the library's SASS")
        for label, ops in counts[fn].items():
            require(ops["HGMMA"] > 0 and ops["UTMALDG"] > 0 and ops["HMMA"] == 0,
                    f"{fn} {label} lacks wgmma or TMA loads, or has mma.sync, in its "
                    f"SASS: {ops}")
    for fn in FLASH_TF32_NAMES:
        require(fn in counts, f"{fn} is not in the library's SASS")
        for label, ops in counts[fn].items():
            require(ops["HMMA"] > 0 and ops["UTMALDG"] > 0,
                    f"{fn} {label} lacks mma.sync or TMA loads in its SASS: {ops}")
    for fn in SETMAXNREG_NAMES:
        for label, ops in counts[fn].items():
            use = build["ptxas"].get(f"{fn} {label}", {})
            require(ops["LDL"] == 0 and ops["STL"] == 0 and use.get("spill_stores") == 0
                    and use.get("spill_loads") == 0,
                    f"{fn} {label} spills: SASS {ops}, ptxas {use}")
    want = {fn: [] for fn in FLASH_NAMES}
    want.update({fn: [_label("float32", dp) for dp in (128, 256)] for fn in FLASH_F32_NAMES})
    # past 256 one variant a kernel and dtype, whatever the head dim
    want.update({fn: ["bf16 sliced", "f16 sliced"] for fn in FLASH_SLICED_NAMES})
    want.update({fn: ["f32 sliced"] for fn in FLASH_F32_SLICED_NAMES})
    for dtype in (torch.bfloat16, torch.float16):
        name = flash_tuning.dtype_name(dtype)
        for dp in fa._PADDED:
            want["flash_fwd_kernel"] += [_label(name, dp, bk)
                                         for _, bk in fa.compiled_blocks(dp, dtype)]
            want["flash_bwd_dq_kernel"] += [_label(name, dp)]
            want["flash_bwd_dkv_kernel"] += [_label(name, dp)]
    for fn, labels in want.items():
        missing = [label for label in labels if label not in counts.get(fn, {})]
        require(not missing, f"{fn} {missing} not in the library's SASS")
    build["sass"] = counts


def _label(dtype: str, dp: int, block_k=None) -> str:
    """A variant's label: its element type, padded head dim and the
    forward's keys a stage (``block_k``); the f32 kernels by the largest
    head dim they take, 128 or 256; past 256 the sliced kernels by their
    element type alone ("bf16 sliced"), one variant serving every head
    dim."""
    ty = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}[dtype]
    if dp > 256:
        return f"{ty} sliced"
    if dtype == "float32":
        return f"f32 D{128 if dp <= 128 else 256}"
    if block_k is None:
        return f"{ty} D{dp}"
    return f"{ty} D{dp} k{block_k}"


def _variant(mangled: str):
    """(kernel, variant label) of a flash kernel's mangled name, or None:
    its template arguments are (T, DP, KEYS) for the forward and dq, (T, DP)
    for dkv and (DMAX) for the f32 kernels; the sliced kernels' are (T), or
    none in f32."""
    sliced = next((n for n in FLASH_SLICED_NAMES + FLASH_F32_SLICED_NAMES if n in mangled), None)
    if sliced is not None:  # one variant a dtype serves every head dim past 256
        ty = ("f32" if sliced in FLASH_F32_SLICED_NAMES else
              "f16" if "6__half" in mangled else "bf16")
        return sliced, f"{ty} sliced"
    name = next((n for n in FLASH_NAMES + FLASH_F32_NAMES if n in mangled), None)
    if name is None:
        return None
    ints = [int(x) for x in re.findall(r"Li(\d+)E", mangled)]
    if name in FLASH_F32_NAMES:
        return name, _label("float32", ints[0])
    dtype = "float16" if "6__half" in mangled else "bfloat16"
    return name, _label(dtype, ints[0], ints[1] if name == "flash_fwd_kernel" else None)


def ptxas_usage(log: str) -> dict:
    """{(kernel, variant): registers and spill bytes} from ptxas -v's log."""
    usage, cur = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '([^']+)'", line)
        if hit:
            cur = _variant(hit.group(1))
            if cur is not None:
                usage[cur] = {"registers": None, "spill_stores": None, "spill_loads": None}
            continue
        if cur is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            usage[cur]["spill_stores"], usage[cur]["spill_loads"] = map(int, spill.groups())
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            usage[cur]["registers"] = int(regs.group(1))
    return usage


def sass_counts(path) -> dict:
    """{kernel: {variant: counts}} for the flash kernels, from ``cuobjdump
    -sass`` of the built library (`parse_sass`)."""
    from pathlib import Path

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run(
        [str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(path)],
        check=True, capture_output=True, text=True, timeout=300).stdout
    return parse_sass(sass)


def parse_sass(sass: str) -> dict:
    """{kernel: {variant: counts}} from a ``cuobjdump -sass`` listing: the
    instructions of each of ``SASS_OPS`` (an op with modifiers, such as
    ``LDL.64``, counts as its op) and ``max_register``, the highest general
    register (``R<n>``) the function names, or -1. Functions that are not
    flash kernels are skipped."""
    counts, ops = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            hit = _variant(line.split("Function :")[1].strip())
            ops = None
            if hit is not None:
                ops = counts.setdefault(hit[0], {}).setdefault(
                    hit[1], {**dict.fromkeys(SASS_OPS, 0), "max_register": -1})
        elif ops is not None:
            hit = re.search(r"\b(" + "|".join(SASS_OPS) + r")\b", line)
            if hit:
                ops[hit.group(1)] += 1
            for reg in re.findall(r"\bR(\d+)\b", line):
                ops["max_register"] = max(ops["max_register"], int(reg))
    return counts


def _case_inputs(shape, fused, return_lse, gen, device, dtype="bfloat16"):
    import torch

    B, Sq, Sk, H, D = shape
    dt = getattr(torch, dtype)

    def randn(*s):
        return torch.randn(s, generator=gen, device=device).to(dt)

    if fused:
        qkv = randn(B, Sq, 3, H, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
    out_dtype = torch.float32 if return_lse else dt
    do = torch.randn((B, Sq, H, D), generator=gen, device=device).to(out_dtype)
    dlse = (torch.randn((B, H, Sq), generator=gen, device=device) if return_lse
            else torch.zeros((B, H, Sq), device=device))
    return q, k, v, do, dlse, out_dtype


def _compare(got, want) -> dict:
    """Errors of ``got`` against ``want``, rows along the last dim: ``abs``,
    the largest |got - want|; ``row``, the worst ||got - want|| / ||want||
    of a row; ``elem``, the worst |got - want| / (|want| + rms of its row).
    A row's norm counts as at least ``ROW_FLOOR`` of the rms row norm."""
    g, w = got.float(), want.float()
    diff = g - w
    w_norm = w.norm(dim=-1)
    w_norm = w_norm.clamp_min(ROW_FLOOR * w_norm.square().mean().sqrt().item())
    row = diff.norm(dim=-1) / w_norm
    elem = diff.abs() / (w.abs() + (w_norm / math.sqrt(w.shape[-1]))[..., None])
    return {"abs": diff.abs().max().item(), "row": row.max().item(),
            "elem": elem.max().item()}


def _passes(err: dict) -> bool:
    return err["row"] <= TOL_ROW and err["elem"] <= TOL_ELEM


def _passes_f32(err: dict, bound: dict = None) -> bool:
    """The f32 bound (`f32_bounds`; ``TOL_*_F32`` if none is given), which
    f32 outputs are held to besides `_passes`."""
    bound = bound or {"row": TOL_ROW_F32, "elem": TOL_ELEM_F32}
    return err["row"] <= bound["row"] and err["elem"] <= bound["elem"]


def f32_bounds(outputs, want, exact) -> dict:
    """Each f32 output's bound: the larger of ``TOL_*_F32`` and
    ``F32_OWN_HEADROOM`` times the plain version's own error (``want``)
    against the function in f64 (``exact``, `_exact_outputs`), by metric,
    with that error under "own"."""
    out = {}
    for n, x in zip(outputs, exact):
        own = _compare(want[n], x)
        out[n] = {"row": max(TOL_ROW_F32, F32_OWN_HEADROOM * own["row"]),
                  "elem": max(TOL_ELEM_F32, F32_OWN_HEADROOM * own["elem"]), "own": own}
    return out


def case_f32_bounds(fa, q, k, v, want, opts) -> dict:
    """`f32_bounds` of a case's four outputs (o, dq, dk, dv; the backward
    given the plain forward's lse and delta)."""
    bwd = (q, k, v, want["do"], want["lse"], want["delta"])
    exact = (*_exact_outputs(fa, "fwd", q, k, v, None, None, None, opts),
             *_exact_outputs(fa, "bwd_dq", *bwd, opts), *_exact_outputs(fa, "bwd_dkv", *bwd, opts))
    return f32_bounds(("o", "dq", "dk", "dv"), want, exact)


def tf32_rounded(x):
    """``x`` in f32 with the low 13 bits of every mantissa cleared: its TF32
    value (rounded toward zero)."""
    import torch

    return (x.float().contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_fault_outputs(fa, q, k, v, want, out_dtype, opts) -> dict:
    """A planted fault for the f32 bound: the plain versions' outputs from
    q, k, v and dO rounded to TF32 (`tf32_rounded`), what a kernel that
    multiplied in one TF32 rounding would give; the backward given the true
    lse and delta (``want``, `_plain_outputs`)."""
    tq, tk, tv, tdo = (tf32_rounded(x) for x in (q, k, v, want["do"]))
    o, _ = fa._fwd_reference(tq, tk, tv, out_dtype=out_dtype, **opts)
    args = (tq, tk, tv, tdo, want["lse"], want["delta"])
    dk, dv = fa._bwd_dkv_reference(*args, **opts)
    return dict(o=o, dq=fa._bwd_dq_reference(*args, **opts), dk=dk, dv=dv)


def check_tf32_fault(fa, name, q, k, v, want, out_dtype, opts, bounds) -> dict:
    """Every output of the planted TF32 fault (`tf32_fault_outputs`) must
    fail its f32 bound (``bounds``, `case_f32_bounds`) against the true
    plain outputs; returns their errors."""
    got = tf32_fault_outputs(fa, q, k, v, want, out_dtype, opts)
    errs = {n: _compare(g, want[n]) for n, g in got.items()}
    print(f"planted TF32 fault ({name}): the plain versions on inputs rounded to TF32: "
          + "; ".join(f"{n} {_fmt(e)}" for n, e in errs.items()) + "; f32 bounds: "
          + "; ".join(f"{n} row {b['row']:.3e} elem {b['elem']:.3e}" for n, b in bounds.items()))
    for n, e in errs.items():
        require(not _passes_f32(e, bounds[n]), f"the f32 bound passes the planted TF32 fault "
                                               f"({name} {n}: {_fmt(e)})")
    return errs


def _fmt(err: dict) -> str:
    return " ".join(f"{m} {x:.3e}" for m, x in err.items())


def _plain_outputs(fa, q, k, v, do, dlse, out_dtype, opts) -> dict:
    """The plain versions' outputs, and the dO, lse and delta that both
    backward versions are given: the plain forward's lse, and dO and delta as
    the autograd function makes them from its O."""
    o, lse = fa._fwd_reference(q, k, v, out_dtype=out_dtype, **opts)
    do, delta = fa._backward_inputs(q, o, do, dlse)
    dk, dv = fa._bwd_dkv_reference(q, k, v, do, lse, delta, **opts)
    return dict(o=o, lse=lse, do=do, delta=delta, dk=dk, dv=dv,
                dq=fa._bwd_dq_reference(q, k, v, do, lse, delta, **opts))


def check_planted_faults(fa, gen, device, case) -> None:
    """The comparison must reject two planted faults at the case's shape,
    each held against the true outputs: a kernel that leaves out one key tile
    for the later query tiles (the plain versions' outputs with that tile
    masked off), and one whose later rows are off by ``FAULT_SCALE`` of their
    value (a slip in a rescaling), small beside the first rows' values."""
    from unittest import mock

    name, shape, causal, qo, ko, ret_lse, fused, dtype = case
    q, k, v, do, dlse, out_dtype = _case_inputs(shape, fused, ret_lse, gen, device, dtype)
    opts = dict(scale=1.0 / math.sqrt(shape[4]), causal=causal, q_offset=qo, k_offset=ko)
    want = _plain_outputs(fa, q, k, v, do, dlse, out_dtype, opts)
    valid, first = fa._valid, FAULT_Q_TILE * fa.TILE

    def faulty_valid(*args):
        mask = valid(*args).clone()
        mask[first:, FAULT_K_TILE * fa.TILE:(FAULT_K_TILE + 1) * fa.TILE] = False
        return mask

    def rescaled(x):
        x = x.clone()
        x[:, first:] = (x[:, first:].float() * (1 + FAULT_SCALE)).to(x.dtype)
        return x

    args = (q, k, v, want["do"], want["lse"], want["delta"])
    with mock.patch.object(fa, "_valid", faulty_valid):
        o, lse = fa._fwd_reference(q, k, v, out_dtype=out_dtype, **opts)
        dk, dv = fa._bwd_dkv_reference(*args, **opts)
        dropped = dict(o=o, dq=fa._bwd_dq_reference(*args, **opts), dk=dk, dv=dv)
    lse_err = (lse - want["lse"]).abs().max().item()
    require(lse_err > TOL_LSE, f"the lse check passes the planted fault ({name})")
    faults = {
        f"key tile {FAULT_K_TILE} left out for query tiles >= {FAULT_Q_TILE} "
        f"(lse abs {lse_err:.3e})": dropped,
        f"rows from {first} on off by {FAULT_SCALE} of their value":
            {n: rescaled(want[n]) for n in dropped},
    }
    for label, got in faults.items():
        print(f"planted fault ({name} {shape} {dtype}): {label}")
        for n, g in got.items():
            err = _compare(g, want[n])
            scaled = err["abs"] / max(1.0, want[n].float().abs().max().item())
            print(f"  {n}: {_fmt(err)}; max abs err / max(1, max |plain|) {scaled:.3e}")
            require(not _passes(err), f"the {n} check passes the planted fault {label} "
                                      f"({name})")


def _plain_full(fa, q, k, v, ct, opts) -> dict:
    """The plain versions on the whole sequence, as `flash_attention(...,
    return_lse=True)` runs them on the CPU: the f32 out, and dq, dk, dv for
    the cotangent ``ct`` of the out, its part in q's dtype and its remainder
    each through the plain backward."""
    import torch

    o, lse = fa._fwd_reference(q, k, v, out_dtype=torch.float32, **opts)
    hi, delta = fa._backward_inputs(q, o, ct, lse.new_zeros(lse.shape))
    lo, delta_lo = fa._backward_inputs(q, o, ct - hi.float(), lse.new_zeros(lse.shape))
    parts = [fa._bwd_reference(q, k, v, d, lse, dl, **opts) for d, dl in ((hi, delta),
                                                                          (lo, delta_lo))]
    return dict(o=o, **{n: (a.float() + b.float()).to(a.dtype)
                        for n, a, b in zip(("dq", "dk", "dv"), *parts)})


def check_merged_hops(fa, gen, device, shape) -> dict:
    """The ring's per-hop engine on one card: at ``shape`` (B, S, H, D), bf16,
    the queries and keys cut into ``n`` blocks (1, 2 and 4), each query
    block's hops through the kernels with their global offsets and
    ``return_lse=True``, in the ring's order, merged by the ring's own
    `merge_hops`; the merged output, and dq, dk and dv for the loss sum(out
    * ct), against the plain full causal attention (the plain versions on
    the whole sequence, `_plain_full`), row by row and element by element:
    the output within the kernel tolerances, the gradients within the
    composed path's (``TOL_COMPOSED_*``), and 2 and 4 hops within a quarter
    more than one call's error. Each backward kernel call of those runs
    (every hop, the bf16 part of dO and its remainder) is also held against
    the plain backward given the same inputs, the kernel forward's own o and
    lse and the delta made from them, at the kernel tolerances: what the
    composed bounds allow is then the forward's error carried through delta,
    not a fault of the backward kernels on the f32-out path. Launches made
    here are not the main path's. Returns each hop count's errors."""
    import torch

    from edl_tpu_torch.parallel.ring_attention import merge_hops

    B, S, H, D = shape
    opts = dict(scale=1.0 / math.sqrt(D), causal=True, q_offset=0, k_offset=0)
    q, k, v = (torch.randn((B, S, H, D), generator=gen, device=device)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    ct = torch.randn((B, S, H, D), generator=gen, device=device)
    with torch.no_grad():
        want = _plain_full(fa, q, k, v, ct, opts)
    one, out = {}, {}
    for n in MERGED_HOPS:
        s = S // n
        outs = []
        for i in range(n):
            qi = q[:, i * s:(i + 1) * s]
            acc = None
            for h in range(n):  # the ring's order: the local block first
                j = (i - h) % n
                blk = fa.flash_attention(qi, k[:, j * s:(j + 1) * s], v[:, j * s:(j + 1) * s],
                                         causal=True, scale=opts["scale"], q_offset=i * s,
                                         k_offset=j * s, return_lse=True)
                acc = blk if acc is None else merge_hops(acc, blk)
            outs.append(acc[0])
        o = torch.cat(outs, dim=1)
        with recorded_backward(fa) as calls:
            got = dict(zip(("dq", "dk", "dv"),
                           torch.autograd.grad((o * ct).sum(), (q, k, v))))
        got["o"] = o.detach()
        # two a hop: the bf16 part of dO and its remainder
        check_backward_calls(fa, f"merged {n} hops", calls, 2 * n * n)
        errs = {name: _compare(got[name], want[name]) for name in ("o", "dq", "dk", "dv")}
        out[n] = errs
        print(f"merged hops: {n} offset hop(s) a query block at {(B, S, H, D)}, against "
              f"the plain full attention: " + "; ".join(f"{x} {_fmt(e)}"
                                                       for x, e in errs.items()))
        for name, e in errs.items():
            require(bool(torch.isfinite(got[name]).all()), f"merged {n} hops: non-finite {name}")
            if name == "o":
                require(_passes(e), f"merged {n} hops: o off the plain full attention: "
                                    f"{_fmt(e)} (tolerances: row {TOL_ROW}, elem {TOL_ELEM})")
                continue
            bounds = {"row": TOL_COMPOSED_ROW, "elem": TOL_COMPOSED_ELEM}
            if n == 1:
                one[name] = e
            for metric, bound in bounds.items():
                if n > 1:  # the decomposition adds little to one call's error
                    bound = min(bound, max({"row": TOL_ROW, "elem": TOL_ELEM}[metric],
                                           COMPOSED_HOPS_OVER_ONE * one[name][metric]))
                require(e[metric] <= bound,
                        f"merged {n} hops: {name} {metric} {e[metric]:.3e} off the plain "
                        f"full attention (bound {bound:.3e})")
    return out


@contextlib.contextmanager
def recorded_backward(fa):
    """Record every call of the backward kernels (`_bwd_kernel`) made
    inside: yields the list that gets each call's ``(args, kw, (dq, dk,
    dv))``."""
    from unittest import mock

    kernel, calls = fa._bwd_kernel, []

    def recorded(*args, **kw):
        out = kernel(*args, **kw)
        calls.append((args, kw, out))
        return out

    with mock.patch.object(fa, "_bwd_kernel", recorded):
        yield calls


def check_backward_calls(fa, label: str, calls, expected: int) -> dict:
    """Each backward kernel call recorded on a path (`recorded_backward`)
    against the plain backward on the same (q, k, v, dO, lse, delta), which
    hold the kernel forward's own o and lse and the delta made from them:
    outputs the plain version makes zero (a hop whose keys no query sees)
    exactly zero, the rest within TOL_ROW / TOL_ELEM. There must be
    ``expected`` calls; ``label`` names the path. Returns the worst errors by
    (output, metric)."""
    require(len(calls) == expected, f"{label}: {len(calls)} backward calls, expected "
                                    f"{expected}")
    worst = {}
    for args, kw, out in calls:
        want = fa._bwd_reference(*args, **kw)
        for name, g, w in zip(("dq", "dk", "dv"), out, want):
            if not bool(w.any()):
                require(not bool(g.any()), f"{label}: a call whose keys no query sees "
                                           f"gave a nonzero {name}")
                continue
            e = _compare(g, w)
            require(_passes(e), f"{label}: a backward call's {name} off the plain backward "
                                f"on the same inputs: {_fmt(e)} "
                                f"(tolerances: row {TOL_ROW}, elem {TOL_ELEM})")
            for metric, x in e.items():
                worst[(name, metric)] = max(worst.get((name, metric), 0.0), x)
    print(f"{label}: {len(calls)} backward calls, each against the plain backward on its "
          f"own inputs (the kernel forward's o and lse): " +
          "; ".join(f"{x} " + " ".join(f"{m} {worst[(x, m)]:.3e}"
                                      for m in ("abs", "row", "elem") if (x, m) in worst)
                    for x in ("dq", "dk", "dv")))
    return worst


def rising_max(fa, name, q, k, opts) -> None:
    """Plants a rising row maximum in a case's q and k (separate tensors),
    in place: q's first column made at least 1 and k's first column
    RISING_MAX_SLOPE·sqrt(D) times the key's position. Then of the (row, key
    tile) pairs whose row sees one of the tile's last 32 keys, the share
    whose tile maximum lies among them and the share whose maximum rises past
    the earlier tiles' must reach ``RISING_MAX_SHARES``."""
    import torch

    D, Sk = q.shape[3], k.shape[1]
    q[..., 0] = q[..., 0].abs() + 1
    k[..., 0] = RISING_MAX_SLOPE * math.sqrt(D) * torch.arange(Sk, device=k.device)[None, :, None]
    valid = fa._valid(q.shape[1], Sk, opts["q_offset"], opts["k_offset"], opts["causal"],
                      q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).masked_fill(~valid, -math.inf)
    late = seen = rises = 0
    before = torch.full(s.shape[:-1], -math.inf, device=s.device)
    for k0 in range(0, Sk, fa.TILE):
        tile = s[..., k0:k0 + fa.TILE]
        counted = valid[:, k0 + 32:k0 + fa.TILE].any(-1).expand(tile.shape[:-1])
        top, at = tile.max(-1)
        seen += int(counted.sum())
        late += int((counted & (at >= 32)).sum())
        rises += int((counted & (top > before)).sum())
        before = torch.maximum(before, top)
    shares = (late / seen, rises / seen)
    print(f"rising maximum ({name}): of {seen} (row, key tile) pairs that see the tile's last "
          f"32 keys, {shares[0]:.4f} have their maximum there and {shares[1]:.4f} a maximum "
          f"past the earlier tiles'")
    require(all(x >= want for x, want in zip(shares, RISING_MAX_SHARES)),
            f"{name}: the rising maximum is not planted: shares {shares}, "
            f"need {RISING_MAX_SHARES}")


def check_cases(fa, gen, device, cases, worst=None, prepare=None) -> dict:
    """Every kernel against its plain version on every case of ``cases``, the
    forward at every tile compiled for the case's head dim and dtype, f32
    outputs also within their f32 bound (`case_f32_bounds`), which the
    planted TF32 fault of each f32 case must fail (`check_tf32_fault`);
    ``prepare(fa, name, q, k, opts)``, if given, shapes each case's q and k
    in place first (`rising_max`). Returns the worst errors by (kernel,
    dtype, padded head dim), each with the case and output it came from,
    added to ``worst`` if given."""
    import torch

    outputs = {"fwd": ("o", "lse"), "bwd_dq": ("dq",), "bwd_dkv": ("dk", "dv")}
    # (kernel, dtype, padded head dim) -> metric -> (value, "case output")
    worst = {} if worst is None else worst
    for name, shape, causal, qo, ko, ret_lse, fused, dtype in cases:
        q, k, v, do, dlse, out_dtype = _case_inputs(shape, fused, ret_lse, gen, device, dtype)
        opts = dict(scale=1.0 / math.sqrt(shape[4]), causal=causal,
                    q_offset=qo, k_offset=ko)
        if prepare is not None:
            prepare(fa, name, q, k, opts)
        want = _plain_outputs(fa, q, k, v, do, dlse, out_dtype, opts)
        do, lse_p, delta = want["do"], want["lse"], want["delta"]
        dq_k = fa._bwd_dq_kernel(q, k, v, do, lse_p, delta, **opts)
        dk_k, dv_k = fa._bwd_dkv_kernel(q, k, v, do, lse_p, delta, **opts)
        no_key = lse_p == fa._NEG_INF  # (B, H, Sq)
        rows = no_key.transpose(1, 2)  # (B, Sq, H)
        unseen = ~fa._valid(shape[1], shape[2], qo, ko, causal, device).any(0)
        live = ~no_key
        bounds = case_f32_bounds(fa, q, k, v, want, opts) if dtype == "float32" else {}
        if bounds:
            check_tf32_fault(fa, name, q, k, v, want, out_dtype, opts, bounds)
        for _, block_k in fa.compiled_blocks(shape[4], q.dtype):
            o_k, lse_k = fa._fwd_kernel(q, k, v, out_dtype=out_dtype, block_k=block_k, **opts)
            torch.cuda.synchronize()
            for t in (o_k, lse_k, dq_k, dk_k, dv_k):
                require(bool(torch.isfinite(t).all()), f"{name}: non-finite kernel output")
            require(torch.equal(lse_k == fa._NEG_INF, no_key),
                    f"{name}: the -1e30 sentinel rows of the kernel's lse differ")
            require(bool((o_k[rows] == 0).all()) and bool((dq_k[rows] == 0).all()),
                    f"{name}: rows that see no key must give O = 0 and dQ = 0")
            require(bool((dk_k[:, unseen] == 0).all()) and bool((dv_k[:, unseen] == 0).all()),
                    f"{name}: keys that no query sees must give dK = 0 and dV = 0")
            lse_err = ((lse_k[live] - lse_p[live]).abs().max().item()
                       if live.any() else 0.0)
            errs = {"o": _compare(o_k, want["o"]), "dq": _compare(dq_k, want["dq"]),
                    "dk": _compare(dk_k, want["dk"]), "dv": _compare(dv_k, want["dv"])}
            print(f"kernels {name} {shape} {dtype} causal={causal} offsets=({qo}, {ko}) "
                  f"lse={ret_lse} keys a stage={block_k} no-key rows={int(no_key.sum())} "
                  f"unseen keys={int(unseen.sum())}: lse abs {lse_err:.3e}; "
                  + "; ".join(f"{n} {_fmt(e)}" for n, e in errs.items()))
            require(lse_err <= TOL_LSE,
                    f"{name}: lse off its plain version by {lse_err:.3e} (tolerance {TOL_LSE})")
            for n, e in errs.items():
                require(_passes(e), f"{name}: {n} off its plain version: {_fmt(e)} "
                                    f"(tolerances: row {TOL_ROW}, elem {TOL_ELEM})")
            for n, b in bounds.items():
                require(_passes_f32(errs[n], b),
                        f"{name}: {n} off its plain version beyond the f32 bound: "
                        f"{_fmt(errs[n])} (bound: row {b['row']:.3e}, elem {b['elem']:.3e}; "
                        f"the plain version's own error {_fmt(b['own'])})")
            if bounds:
                print(f"kernels {name}: within the f32 bound, " + "; ".join(
                    f"{n} row {errs[n]['row']:.3e} of {b['row']:.3e} (TOL_ROW_F32 "
                    f"{'met' if _passes_f32(errs[n]) else 'not met'}; the plain version's "
                    f"own {b['own']['row']:.3e})" for n, b in bounds.items()))
            errs["lse"] = {"abs": lse_err}
            for kname, outs in outputs.items():
                slot = worst.setdefault((kname, dtype, fa.padded_head_dim(shape[4])), {})
                for n in outs:
                    for metric, x in errs[n].items():
                        if x >= slot.get(metric, (-1.0, ""))[0]:
                            slot[metric] = (x, f"{name} {n}")
    return worst


def _onchip_rel(got, want) -> float:
    """The JAX on-chip check's error: max |got - want| / max |want|."""
    return (got.float() - want.float()).abs().max().item() / max(
        1e-6, want.float().abs().max().item())


def check_onchip_cases(fa, gen, device) -> list:
    """The JAX package's on-chip check's five cases (``ONCHIP_CASES``)
    through `flash_attention`, forward and backward, against the plain
    forward in f32 (TF32 is off) on the same inputs, within its relative
    errors; the lse of ``return_lse=True`` must be finite."""
    import torch

    records = []
    for B, S, H, D, causal, dtype in ONCHIP_CASES:
        q, k, v = (torch.randn((B, S, H, D), generator=gen, device=device)
                   .to(getattr(torch, dtype)).requires_grad_() for _ in range(3))
        out = fa.flash_attention(q, k, v, causal=causal)
        grads = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
        q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
        want, _ = fa._fwd_reference(q32, k32, v32, scale=1.0 / math.sqrt(D), causal=causal,
                                    q_offset=0, k_offset=0, out_dtype=torch.float32)
        wgrads = torch.autograd.grad((want ** 2).sum(), (q32, k32, v32))
        _, lse = fa.flash_attention(q.detach(), k.detach(), v.detach(), causal=causal,
                                    return_lse=True)
        errs = {"out": _onchip_rel(out, want)}
        errs.update({f"d{n}": _onchip_rel(g, w) for n, g, w in zip("qkv", grads, wgrads)})
        tol = ONCHIP_TOL[dtype]
        finite = bool(torch.isfinite(lse).all())
        print(f"jax on-chip case {(B, S, H, D)} causal={causal} {dtype}: " + ", ".join(
            f"{n} {e:.3e}" for n, e in errs.items()) + f" (bound {tol}); lse finite {finite}")
        require(finite, f"on-chip case {(B, S, H, D, causal, dtype)}: lse not finite")
        require(all(e <= tol for e in errs.values()),
                f"on-chip case {(B, S, H, D, causal, dtype)} off the plain f32 forward: {errs}")
        records.append(dict(shape=[B, S, H, D], causal=causal, dtype=dtype, rel_err=errs,
                            tolerance=tol, lse_finite=finite))
    return records


def check_served_views(fa, gen, device) -> None:
    """Views the kernels' loads cannot read (``SERVED_VIEWS``), through
    `flash_attention` on the card, forward and backward. The output against
    the plain forward on the CPU on the same values, within the kernel
    tolerances. The backward kernel call against the plain backward on its
    own inputs (`check_backward_calls`): the kernel forward's o, so both
    chains hold one O. The gradients against the whole plain chain on the
    CPU are printed, not held: that chain makes its own O, and a one-step
    bf16 difference in O moves delta, which is most of the dq of a causal
    row whose true dq is near 0 (the merged hops hold that composed path)."""
    import torch

    for name, D, how in SERVED_VIEWS:
        B, S, H = 1, 192, 2
        extra, cut = {"stride_not_16B": (4, slice(0, D)),
                      "odd_stride": (1, slice(1, D + 1))}.get(name, (0, slice(0, D)))
        views = [torch.randn((B, S, H, D + extra), generator=gen, device=device)
                 .to(torch.bfloat16)[..., cut] for _ in range(3)]
        problem = fa._view_problem(views[0].shape, views[0].stride(),
                                   views[0].element_size(), views[0].data_ptr())
        require(problem is not None, f"{name}: the view was readable as it is")
        q, k, v = (x.detach().requires_grad_() for x in views)
        ct = torch.randn((B, S, H, D), generator=gen, device=device)
        out = fa.flash_attention(q, k, v, causal=True)
        with recorded_backward(fa) as calls:
            grads = torch.autograd.grad((out.float() * ct).sum(), (q, k, v))
        cq, ck, cv = (x.detach().cpu().requires_grad_() for x in (q, k, v))
        want = fa.flash_attention(cq, ck, cv, causal=True)
        wgrads = torch.autograd.grad((want.float() * ct.cpu()).sum(), (cq, ck, cv))
        errs = {"o": _compare(out.cpu(), want)}
        errs.update({f"d{n}": _compare(g.cpu(), w) for n, g, w in zip("qkv", grads, wgrads)})
        print(f"served view {name} ({how}; the kernels refuse it as it is: {problem}): "
              + "; ".join(f"{n} {_fmt(e)}" for n, e in errs.items())
              + " (the gradients against the whole plain chain, printed)")
        require(_passes(errs["o"]), f"served view {name}: o off the plain version")
        for g in grads:
            require(bool(torch.isfinite(g).all()), f"served view {name}: a non-finite gradient")
        # a bf16 dO: one call of the backward kernels
        check_backward_calls(fa, f"served view {name}", calls, 1)


def _kernel_bounds(B, S, H, D, itemsize: int, peak: float) -> dict:
    """The least time of each kernel's work at a causal (B, S, H, D): its
    FLOPs at ``peak`` against its bytes (each input read once, each output
    written once) at the HBM rate."""
    pairs = B * H * S * (S + 1) // 2  # visible (query, key) pairs, causal
    row_bytes = B * H * S * D * itemsize  # one (B, S, H, D) tensor
    stat_bytes = B * H * S * 4            # one f32 (B, H, S) row statistic
    return {
        # q, k, v in; o, lse out. QKᵀ and PV
        "fwd": bound(2 * 2 * pairs * D, 4 * row_bytes + stat_bytes, peak),
        # q, k, v, dO, lse, delta in; dq out. S, dP and dS·K
        "bwd_dq": bound(3 * 2 * pairs * D, 5 * row_bytes + 2 * stat_bytes, peak),
        # q, k, v, dO, lse, delta in; dk, dv out. Sᵀ, dPᵀ, Pᵀ·dO and dSᵀ·Q
        "bwd_dkv": bound(4 * 2 * pairs * D, 6 * row_bytes + 2 * stat_bytes, peak),
    }


def kernel_bounds(B, S, H, D, dtype: str) -> dict:
    """Each kernel's bound at a causal (B, S, H, D) in ``dtype``: kernel ->
    {"bound_ms", "bound_by"}, the least time the card could take. 16-bit at
    the bf16 tensor-core peak; f32 the smaller of the FMA bound (f32 outside
    the tensor cores) and the 3xTF32 bound (each FLOP three TF32 ones on the
    tensor cores), both kept as "bound_fma_ms" and "bound_tf32_ms"."""
    if dtype != "float32":
        return {k: {"bound_ms": ms, "bound_by": by}
                for k, (ms, by) in _kernel_bounds(B, S, H, D, 2, PEAK_BF16_FLOPS).items()}
    fma = _kernel_bounds(B, S, H, D, 4, PEAK_F32_FLOPS)
    tf32 = _kernel_bounds(B, S, H, D, 4, PEAK_TF32_FLOPS / 3)
    return {k: {"bound_ms": min(fma[k], tf32[k])[0], "bound_by": min(fma[k], tf32[k])[1],
                "bound_fma_ms": fma[k][0], "bound_tf32_ms": tf32[k][0]} for k in fma}


def _bound_text(b: dict) -> str:
    """A row's bound as its log line gives it."""
    text = f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
    if "bound_fma_ms" in b:
        text += f"; FMA {b['bound_fma_ms']:.4f}, 3xTF32 {b['bound_tf32_ms']:.4f}"
    return text


def _design(fa, kname: str, dtype: str, D: int) -> str:
    """The design a kernel row's variant is built on."""
    import torch

    dp = fa.padded_head_dim(D)
    if dp > 256:
        cut = (f"{fa.slice_columns(kname, getattr(torch, dtype))} columns of "
               + {"fwd": "O", "bwd_dq": "dQ", "bwd_dkv": "dK and dV"}[kname]
               + " a block, scores summed over 64-column chunks")
        if dtype == "float32":
            return ("3xTF32 mma.sync + TMA ring, a producer warpgroup and two consumer warpgroups "
                    "(setmaxnreg), " + cut.replace("64-column", "32-column")
                    + {"fwd": ", the scores split by keys between the consumers, the rows' "
                              "statistics exchanged, Q with K from the chunk stream",
                       "bwd_dq": ", the scores split by keys between the consumers, K read once",
                       "bwd_dkv": ", the slice's Q and dO from the chunk stream"}[kname])
        return ("wgmma+TMA, a producer warpgroup and two consumer warpgroups (setmaxnreg), "
                + cut + {"fwd": ", 128 rows a block, Q held in shared memory up to D 512",
                         "bwd_dq": ", the scores split by keys between the consumers, "
                                   "K read once",
                         "bwd_dkv": ", the slice's Q and dO from the chunk stream"}[kname])
    if dtype == "float32":
        return ("3xTF32 mma.sync + TMA, a producer warpgroup and two consumer warpgroups "
                "(setmaxnreg), all D columns of "
                + {"fwd": "O", "bwd_dq": "dQ", "bwd_dkv": "dK and dV"}[kname]
                + " a block, the second products spread over all eight consumer warps"
                + {"fwd": (", the scores split by keys, the rows' statistics exchanged, Q held, "
                           "K through a ring, V " + ("double-buffered" if dp <= 128 else
                                                     "in one buffer")),
                   "bwd_dq": ", Q and dO held, K read once",
                   "bwd_dkv": (", K and V held, Q and dO double-buffered" if dp <= 128 else
                               ", the tile's Q and dO held, K and V streamed")}[kname])
    if kname == "bwd_dq":
        return DESIGNS[kname][1] + (", 32-key stages" if dp > 128 else ", 64-key stages")
    if kname == "bwd_dkv":
        return DESIGNS[kname][1] + (", 64 keys a warpgroup" if dp <= 128 else
                                    ", 64 keys a block shared, Pᵀ and dSᵀ through shared memory")
    return DESIGNS[kname][1]


def sdpa_backend(q, k, v) -> str:
    """The backend of PyTorch's SDPA that serves these (B, H, S, D) inputs,
    causal: the first in PyTorch's priority order that takes them."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    by_value = {int(b.value): b for b in SDPBackend.__members__.values()}
    order = getattr(torch._C, "_get_sdp_priority_order", lambda: [1, 2, 0, 3])()
    for value in order:
        backend = by_value.get(int(value))
        if backend is None or backend == SDPBackend.ERROR:
            continue
        try:
            with warnings.catch_warnings():  # each refusal warns
                warnings.simplefilter("ignore")
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return backend.name.lower()
        except RuntimeError:
            continue
    return "none"


def sdpa_flash_backend(q, k, v) -> str:
    """Whether PyTorch's flash backend of SDPA takes these (B, H, S, D)
    inputs, causal: "takes it", or "refused: " and what PyTorch said."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        try:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                F.scaled_dot_product_attention(q, k, v, is_causal=True)
            return "takes it"
        except RuntimeError as e:
            text = " ".join([str(w.message) for w in said] + [str(e)])
            return "refused: " + re.sub(r"\s*\(Triggered internally at [^)]*\)", "", text)


def time_kernel_rows(fa, gen, device, shape, dtype, worst, label, host=False,
                     reps: int = 20) -> list:
    """Each kernel's time at the causal (B, S, H, D) ``shape`` in ``dtype``
    (the forward at every compiled tile), each the median of ``reps`` runs:
    ``ms`` one call at a time, ``ms_back_to_back`` ten in a row, the
    wrapper's host time a call, the
    plain version's time, one library call's (PyTorch's SDPA with the
    backend it picks, timed both ways; whether its flash backend takes the
    shape is printed) and the card's bound. Returns the kernel rows."""
    import torch
    import torch.nn.functional as F

    B, S, H, D = shape
    fused = dtype != "float32"  # the model's fused projection; f32 as separate tensors
    q, k, v, do, dlse, out_dtype = _case_inputs((B, S, S, H, D), fused, False, gen, device,
                                                dtype)
    opts = dict(scale=1.0 / math.sqrt(D), causal=True, q_offset=0, k_offset=0)
    o, lse = fa._fwd_kernel(q, k, v, out_dtype=out_dtype, **opts)
    do, delta = fa._backward_inputs(q, o, do, dlse)
    args = (q, k, v, do, lse, delta)
    timed = {("fwd", bk): (lambda bk=bk: fa._fwd_kernel(q, k, v, out_dtype=out_dtype,
                                                        block_k=bk, **opts),
                           lambda: fa._fwd_reference(q, k, v, out_dtype=out_dtype, **opts))
             for _, bk in fa.compiled_blocks(D, q.dtype)}
    timed[("bwd_dq", None)] = (lambda: fa._bwd_dq_kernel(*args, **opts),
                               lambda: fa._bwd_dq_reference(*args, **opts))
    timed[("bwd_dkv", None)] = (lambda: fa._bwd_dkv_kernel(*args, **opts),
                                lambda: fa._bwd_dkv_reference(*args, **opts))
    # the library yardstick, never called by the port: PyTorch's fused SDPA
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_do = do.transpose(1, 2)
    flash_backend = sdpa_flash_backend(qt.detach(), kt.detach(), vt.detach())
    lib_backend = sdpa_backend(qt.detach(), kt.detach(), vt.detach())

    def lib_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def lib_bwd():
        return torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True)

    fwd_times = (time_ms(lib_fwd, reps), time_ms(lib_fwd, reps, batch=BACK_TO_BACK))
    bwd_times = (time_ms(lib_bwd, reps), time_ms(lib_bwd, reps, batch=BACK_TO_BACK))
    library = {"fwd": fwd_times, "bwd_dq": bwd_times, "bwd_dkv": bwd_times}
    f32 = dtype == "float32"
    bounds = kernel_bounds(B, S, H, D, dtype)
    tolerance = {"row": TOL_ROW, "elem": TOL_ELEM, "lse_abs": TOL_LSE}
    if f32:
        tolerance.update(row_f32=TOL_ROW_F32, elem_f32=TOL_ELEM_F32,
                         f32_own_headroom=F32_OWN_HEADROOM)
    rows = []
    for (kname, bk), (kernel, plain) in timed.items():
        ms, plain_ms = time_ms(kernel, reps), time_ms(plain, reps=5, warmup=1)
        ms_b2b, wrapper_ms = time_ms(kernel, reps, batch=BACK_TO_BACK), host_ms(kernel, reps)
        lib_ms, lib_b2b = library[kname]
        tile = f", keys a stage {bk}" if bk else ""
        print(f"time {kname} ({label}) at {shape} {dtype}{tile}: kernel {ms:.4f} ms one call "
              f"at a time ({ms_b2b:.4f} ms back to back; host {wrapper_ms:.4f} ms a call), "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms ({lib_b2b:.4f} ms back to "
              f"back; SDPA's {lib_backend} backend serves it, its flash backend "
              f"{flash_backend}), {_bound_text(bounds[kname])}")
        err = worst[(kname, dtype, fa.padded_head_dim(D))]
        source = SOURCE_SLICED if D > 256 else SOURCE
        if f32:
            source = (SOURCE_F32_SLICED if D > 256 else SOURCE_F32)[kname]
        rows.append(dict(
            name=kname, route="cuda", source=source,
            replaces=KERNELS[kname][1], design=_design(fa, kname, dtype, D),
            head_dim=D, dtype=dtype, shape=[B, S, H, D], timed_at=label,
            block_k=bk if kname == "fwd" else None,
            max_abs_err=err["abs"][0],
            worst={m: {"value": x, "case": c} for m, (x, c) in err.items()},
            tolerance=tolerance, ms=ms,
            ms_back_to_back=ms_b2b, host_ms=wrapper_ms,
            plain_ms=plain_ms, plain=KERNELS[kname][0], **bounds[kname],
            library_ms=lib_ms, library_ms_back_to_back=lib_b2b,
            library_call=("scaled_dot_product_attention(is_causal=True)"
                          if kname == "fwd" else
                          "scaled_dot_product_attention backward: dq, dk and dv together"),
            library_flash_backend=flash_backend, library_backend=lib_backend,
        ))
    if host:
        bwd_host = host_ms(lambda: fa._bwd_kernel(*args, **opts))
        by = {r["name"]: r for r in rows}
        print(f"host: the backward's two launches (inputs checked once) {bwd_host:.4f} ms a "
              f"call, against {by['bwd_dq']['host_ms'] + by['bwd_dkv']['host_ms']:.4f} "
              f"ms for the two wrappers called one after the other")
    return rows


#: the rows ``--turns`` times: (kernel, dtype, causal (B, S, H, D)): the
#: f32 forward at the JAX on-chip check's f32 (B, S, H) at D 64, 128, 192,
#: 256 and 512 (128 blocks, 256 at 512: the small shape's few blocks), and
#: at the D-128, D-256 and D-512 LMs' attention (2,048 blocks: the design
#: free of them), each beside SDPA's f32 forward; the f32 sliced dq at D 512
#: and the bf16 sliced dkv at the D-512 LM's attention, whose code the trees
#: compared share, are the controls for the card's drift between turns
F32_D512 = (*ONCHIP_CASES[0][:3], 512)
F32_TURN_SHAPES = ([(*F32_D512[:3], D) for D in (64, 128, 192, 256, 512)]
                   + [LM_D128_ATTENTION, LM_D256_ATTENTION, LM_D512_ATTENTION])
TURNS = [("fwd", "float32", shape) for shape in F32_TURN_SHAPES]
TURNS += [("bwd_dq", "float32", F32_D512), ("bwd_dkv", "bfloat16", LM_D512_ATTENTION)]


def turns_main(root: str) -> int:
    """Time the kernels of the checkout at ``root`` (``TURNS``, `turn_row`),
    so that two trees can be compared on one card in turns (parent, tree,
    tree, parent), each turn a process of its own: the package is imported
    from ``root`` and its library built there. Prints one JSON line
    ``{"turns": ...}``."""
    from pathlib import Path

    root = str(Path(root).resolve())
    sys.path.insert(0, root)
    import torch

    fa = _flash_module()
    require(str(Path(fa.__file__).resolve()).startswith(root + "/"),
            f"imported {fa.__file__}, not the checkout at {root}")
    require(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    fa._kernels()
    print(f"turns: {root}: the library built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(0)
    rows = [turn_row(fa, kname, dtype, shape, gen, device) for kname, dtype, shape in TURNS]
    print(json.dumps({"turns": {"root": root, "card": card(), "rows": rows}}))
    return 0


def _exact_outputs(fa, kname: str, q, k, v, do, lse, delta, opts) -> tuple:
    """Kernel ``kname``'s function evaluated in f64 on the same inputs (the
    backward given lse and delta), rounded to f32: the outputs in the plain
    version's order."""
    import torch

    valid = fa._valid(q.shape[1], k.shape[1], opts["q_offset"], opts["k_offset"],
                      opts["causal"], q.device)
    q, k, v = (x.double() for x in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * opts["scale"]
    if kname == "fwd":
        s = torch.where(valid, s, fa._NEG_INF)
        p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v) / torch.where(l > 0, l, 1.0).permute(0, 2, 1, 3)
        return (o.float(),)
    p = torch.where(valid, torch.exp(s - lse.double()[..., None]), 0.0)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do.double(), v) - delta.double()[..., None]) \
        * opts["scale"]
    if kname == "bwd_dq":
        return (torch.einsum("bhqk,bkhd->bqhd", ds, k).float(),)
    return (torch.einsum("bhqk,bqhd->bkhd", ds, q).float(),
            torch.einsum("bhqk,bqhd->bkhd", p, do.double()).float())


def turn_row(fa, kname: str, dtype: str, shape, gen, device) -> dict:
    """One row of ``--turns``: kernel ``kname`` at the causal (B, S, H, D)
    ``shape`` in ``dtype``, first held against its plain version on the same
    inputs (the kernel tolerances; f32 also the f32 bound, or
    ``F32_OWN_HEADROOM`` times the plain version's own error against the
    function in f64 where that is larger; the forward's lse too), then
    timed one call at a time and ten back to back (medians of 20), beside
    the dtype's bound (`kernel_bounds`), the plain version (5 calls) and
    PyTorch's SDPA (the forward, or the backward: dq, dk and dv
    together)."""
    import torch
    import torch.nn.functional as F

    B, S, H, D = shape
    q, k, v, do, dlse, out_dtype = _case_inputs((B, S, S, H, D), True, False, gen, device,
                                                dtype)
    opts = dict(scale=1.0 / math.sqrt(D), causal=True, q_offset=0, k_offset=0)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    if kname == "fwd":
        def kernel():
            return fa._fwd_kernel(q, k, v, out_dtype=out_dtype, **opts)

        def plain():
            return fa._fwd_reference(q, k, v, out_dtype=out_dtype, **opts)

        (got, lse_k), (want, lse_p) = kernel(), plain()
        inputs = (q, k, v, None, None, None)
        lse_err = (lse_k - lse_p).abs().max().item()
        require(lse_err <= TOL_LSE, f"turns: fwd {dtype} {shape}: lse off its plain version "
                                    f"by {lse_err:.3e}")
        got, want = (got,), (want,)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        o, lse = fa._fwd_kernel(q, k, v, out_dtype=out_dtype, **opts)
        do, delta = fa._backward_inputs(q, o, do, dlse)
        args = (q, k, v, do, lse, delta)
        bwd = getattr(fa, f"_{kname}_kernel")

        def kernel():
            return bwd(*args, **opts)

        def plain():
            return getattr(fa, f"_{kname}_reference")(*args, **opts)

        got, want = kernel(), plain()
        inputs = args
        got, want = ((got,), (want,)) if kname == "bwd_dq" else (got, want)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_do = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True)
    errs = [_compare(g, w) for g, w in zip(got, want)]
    f32 = dtype == "float32"
    tol = [{"row": TOL_ROW, "elem": TOL_ELEM}] * len(errs)
    if f32:  # the f32 bound, or what the f32 plain version itself is off by
        names = [str(i) for i in range(len(want))]
        f32b = f32_bounds(names, dict(zip(names, want)), _exact_outputs(fa, kname, *inputs, opts))
        tol = [f32b[n] for n in names]
        print(f"turns: {kname} {dtype} {tuple(shape)}: the plain version against the function "
              f"in f64: {[_fmt(b['own']) for b in tol]}; the f32 bound: "
              + "; ".join(f"row {b['row']:.3e}, elem {b['elem']:.3e}" for b in tol))
    del got, want
    require(all(_passes(e) and (not f32 or _passes_f32(e, b)) for e, b in zip(errs, tol)),
            f"turns: {kname} {dtype} {shape} off its plain version: {[_fmt(e) for e in errs]} "
            f"(bounds: {[(b['row'], b['elem']) for b in tol]})")
    bounds = kernel_bounds(B, S, H, D, dtype)[kname]
    row = dict(name=kname, dtype=dtype, shape=[B, S, H, D], ms=time_ms(kernel),
               ms_back_to_back=time_ms(kernel, batch=BACK_TO_BACK), **bounds,
               plain_ms=time_ms(plain, reps=5, warmup=1),
               library_ms_back_to_back=time_ms(library, batch=BACK_TO_BACK),
               row_err=max(e["row"] for e in errs), elem_err=max(e["elem"] for e in errs),
               tolerance=[{m: b[m] for m in ("row", "elem")} for b in tol])
    print(f"turns: {kname} {dtype} {tuple(shape)}: {row['ms']:.4f} ms one call at a time, "
          f"{row['ms_back_to_back']:.4f} ms back to back, {_bound_text(bounds)}, plain "
          f"{row['plain_ms']:.4f} ms, {'SDPA' if kname == 'fwd' else 'SDPA backward'} "
          f"{row['library_ms_back_to_back']:.4f} ms back to back; row error "
          f"{row['row_err']:.3e}, elem error {row['elem_err']:.3e}")
    return row


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def sweep_tiles(fa, gen, device, table_out=None) -> dict:
    """The tile sweep: every compiled forward tile at each of
    ``SWEEP_SHAPES`` (bf16, causal), the forward and the forward plus the
    backward timed back to back; the winner of each shape is the fastest
    forward plus backward. Writes the winners as a tile table to
    ``table_out`` if given. Then the wrapper must resolve each shape to the
    committed table's tile (`flash_tuning`'s file in the checkout), or to
    the default where no table is committed."""
    import torch

    from edl_tpu_torch.ops import flash_tuning

    winners, records = {}, []
    for B, S, H, D in SWEEP_SHAPES:
        q, k, v, do, dlse, _ = _case_inputs((B, S, S, H, D), False, False, gen, device)
        opts = dict(scale=1.0 / math.sqrt(D), causal=True, q_offset=0, k_offset=0)
        o, lse = fa._fwd_kernel(q, k, v, out_dtype=torch.bfloat16, **opts)
        do, delta = fa._backward_inputs(q, o, do, dlse)
        best = None
        for bq, bk in fa.compiled_blocks(D, torch.bfloat16):
            def fwd(bk=bk):
                return fa._fwd_kernel(q, k, v, out_dtype=torch.bfloat16, block_k=bk, **opts)

            rec = dict(shape=[B, S, H, D], block_q=bq, block_k=bk,
                       fwd_ms=time_ms(fwd, batch=BACK_TO_BACK),
                       fwd_bwd_ms=time_ms(lambda: (fwd(), fa._bwd_kernel(
                           q, k, v, do, lse, delta, **opts)), batch=BACK_TO_BACK))
            records.append(rec)
            if best is None or rec["fwd_bwd_ms"] < best["fwd_bwd_ms"]:
                best = rec
        key = flash_tuning._key(flash_tuning._bucket(S), D, "bfloat16")
        winners[key] = (best["block_q"], best["block_k"])
        print(f"sweep {(B, S, H, D)} bf16 causal: " + ", ".join(
            f"({r['block_q']}, {r['block_k']}) fwd {r['fwd_ms']:.4f} ms, fwd+bwd "
            f"{r['fwd_bwd_ms']:.4f} ms" for r in records if r["shape"] == [B, S, H, D])
              + f"; winner {winners[key]} ({key})")
    if table_out:
        import torch.version

        meta = {"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda,
                "call": " ".join(["chip_smoke.py", *(a for a in sys.argv[1:]
                                                     if a not in ("--tile-table", table_out))]),
                "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                "shapes": [list(s) for s in SWEEP_SHAPES],
                "criterion": "forward plus backward, back to back"}
        flash_tuning.save_table(winners, meta, path=table_out)
        print(f"sweep: the winners written to {table_out}")
    committed = flash_tuning._load_table()
    resolved = {}
    for B, S, H, D in SWEEP_SHAPES:
        key = flash_tuning._key(flash_tuning._bucket(S), D, "bfloat16")
        require(not committed or key in committed, f"the committed tile table lacks {key}")
        got = fa.resolve_blocks(S, D, torch.bfloat16)
        want = tuple(committed[key]) if committed else flash_tuning.DEFAULT_BLOCKS
        require(got == want, f"the wrapper resolves {(B, S, H, D)} to {got}, the committed "
                             f"table to {want}")
        resolved[key] = list(got)
    print("sweep: the wrapper resolves every shape to the " + (
        "committed table's tile" if committed else "default tile (no table committed)")
          + f": {resolved}")
    return {"records": records, "winners": {k: list(v) for k, v in winners.items()},
            "resolved": resolved, "committed": bool(committed)}


def phase_kernels(device, table_out=None) -> tuple:
    """Every kernel against its plain version on every case, the JAX on-chip
    check's cases, the views the wrapper copies or pads, the check against
    planted faults, the ring's merged hops, the timings and the tile sweep;
    returns (the kernel rows, the phase's other records)."""
    import torch

    fa = _flash_module()
    gen = torch.Generator(device=device).manual_seed(0)
    worst = check_cases(fa, gen, device, CASES)
    onchip = check_onchip_cases(fa, gen, device)
    check_served_views(fa, gen, device)
    for case in FAULT_CASES:
        check_planted_faults(fa, gen, device, case)
    check_merged_hops(fa, gen, device, (lambda B, S, _, H, D: (B, S, H, D))(*CASES[0][1]))
    check_cases(fa, gen, device, LATE_CASES, worst)
    for case in LATE_FAULT_CASES:
        check_planted_faults(fa, gen, device, case)
    check_cases(fa, gen, device, RISING_MAX_CASES, worst, prepare=rising_max)
    B, S, _, H, D = CASES[0][1]
    rows = time_kernel_rows(fa, gen, device, (B, S, H, D), "bfloat16", worst, "slice",
                            host=True)
    rows += time_kernel_rows(fa, gen, device, DEPLOY_ATTENTION, "bfloat16", worst, "deploy")
    rows += time_kernel_rows(fa, gen, device, LM_D128_ATTENTION, "bfloat16", worst, "lm_d128")
    rows += time_kernel_rows(fa, gen, device, LM_D256_ATTENTION, "bfloat16", worst, "lm_d256")
    rows += time_kernel_rows(fa, gen, device, D192_ATTENTION, "bfloat16", worst, "d192")
    rows += time_kernel_rows(fa, gen, device, LM_D512_ATTENTION, "bfloat16", worst, "lm_d512")
    rows += time_kernel_rows(fa, gen, device, ONCHIP_CASES[3][:4], "bfloat16", worst,
                             "jax check d128")
    rows += time_kernel_rows(fa, gen, device, (B, S, H, D), "float16", worst, "slice f16")
    rows += time_kernel_rows(fa, gen, device, LM_D128_ATTENTION, "float16", worst,
                             "lm_d128 f16")
    # rows off every model's path, timed over fewer runs
    rows += time_kernel_rows(fa, gen, device, LM_D256_ATTENTION, "float16", worst,
                             "lm_d256 f16", reps=OFF_PATH_REPS)
    rows += time_kernel_rows(fa, gen, device, D192_ATTENTION, "float16", worst, "d192 f16",
                             reps=OFF_PATH_REPS)
    rows += time_kernel_rows(fa, gen, device, LM_D512_ATTENTION, "float16", worst,
                             "lm_d512 f16", reps=OFF_PATH_REPS)
    rows += time_kernel_rows(fa, gen, device, ONCHIP_CASES[0][:4], "float32", worst,
                             "jax check f32")
    for D in F32_TIMED_HEAD_DIMS:
        rows += time_kernel_rows(fa, gen, device, (*ONCHIP_CASES[0][:3], D), "float32", worst,
                                 f"jax check f32 d{D}", reps=OFF_PATH_REPS)
    sweep = sweep_tiles(fa, gen, device, table_out)
    # from a padded head dim of 192 one tile is compiled, 128 rows by 64 keys:
    # the D-256 LM's key length resolves to it
    d256 = fa.resolve_blocks(LM_D256["seq_len"], LM_D256_ATTENTION[3], torch.bfloat16)
    compiled = fa.compiled_blocks(LM_D256_ATTENTION[3], torch.bfloat16)
    print(f"tiles: the wrapper resolves {LM_D256_ATTENTION} bf16 to {d256}; compiled "
          f"{list(compiled)}")
    require(compiled == ((2 * fa.TILE, fa.TILE),) and d256 == compiled[0],
            f"the D-256 shape resolves to {d256}, compiled {compiled}")
    sweep["resolved_d256"] = list(d256)
    return rows, {"onchip_cases": onchip, "sweep": sweep}


class Run:
    """One model trained by the ``Trainer`` on one placed synthetic batch
    (made with numpy from ``seed``): `start` builds it, `timed` runs it.
    The params are drawn from ``generator`` (default: the Trainer's CPU
    generator)."""

    def __init__(self, label: str, model, config, batch_size: int, device, seed: int = 0,
                 generator=None):
        import numpy as np

        from edl_tpu_torch.runtime import Trainer

        self.label, self.model, self.config = label, model, config
        self.batch_size, self.device = batch_size, device
        self.trainer = Trainer(model, device=device, config=config)
        self.state = self.trainer.init_state(generator)
        self.host_batch = model.synthetic_batch(np.random.default_rng(seed), batch_size)
        self.batch = self.trainer.place_batch(self.host_batch)

    def step(self) -> None:
        import torch

        self.state, _ = self.trainer.train_step(self.state, self.batch)
        torch.cuda.synchronize()

    def timed(self, reset_counts=None, steps=None) -> dict:
        """``WARMUP_STEPS`` steps, then ``steps`` (default ``STEPS``) timed
        steps (host clock around each step and a synchronise), peak memory
        over the timed steps. ``reset_counts`` runs just before the timed
        steps. Requires a finite, falling loss; prints and returns the zoo
        row."""
        import torch

        from edl_tpu_torch.tools.mfu import mfu_fields

        steps = STEPS if steps is None else steps

        for _ in range(WARMUP_STEPS):
            self.state, loss = self.trainer.train_step(self.state, self.batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(self.device)
        allocs = torch.cuda.memory_stats(self.device).get("num_device_alloc", 0)
        if reset_counts is not None:
            reset_counts()
        losses, step_s = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            self.state, loss = self.trainer.train_step(self.state, self.batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(loss))
        require(all(math.isfinite(x) for x in losses), f"{self.label}: non-finite loss {losses}")
        require(losses[-1] < losses[0], f"{self.label}: loss did not fall: {losses}")
        # cudaMalloc calls of the caching allocator in the timed steps
        allocs = torch.cuda.memory_stats(self.device).get("num_device_alloc", 0) - allocs
        step = statistics.median(step_s)
        acc = mfu_fields(self.model, self.batch_size, 1.0 / step, device=self.device)
        n_params = sum(p.numel() for p in self.state.params.parameters())
        cfg = self.config
        self.row = dict(
            name=self.label, model=self.model.name, params=n_params, batch=self.batch_size,
            optimizer=cfg.optimizer, learning_rate=cfg.learning_rate, steps=steps,
            step_ms=step * 1e3, samples_per_s=self.batch_size / step,
            model_flops=acc["model_flops"], tflops_per_sec=acc["tflops_per_sec"],
            mfu=acc["mfu"], peak_tflops=acc["peak_tflops"],
            peak_memory_gib=torch.cuda.max_memory_allocated(self.device) / 2**30,
            device_allocs_in_timed_steps=allocs, losses=losses, loss_first=losses[0],
            loss_last=losses[-1])
        print(f"{self.label}: {n_params / 1e6:.2f} M params, batch {self.batch_size}, "
              f"{cfg.optimizer} lr {cfg.learning_rate}: step {step * 1e3:.3f} ms (median of "
              f"{steps}), {self.batch_size / step:.0f} samples/s, MFU "
              + (f"{acc['mfu']:.5f} of {acc['peak_tflops']:.0f} TFLOP/s"
                 if acc["mfu"] is not None else "not measured (no peak for this card)")
              + f" ({acc['tflops_per_sec']:.3f} TFLOP/s), peak memory "
              f"{self.row['peak_memory_gib']:.3f} GiB ({allocs} cudaMalloc in the timed steps), "
              f"loss {losses[0]:.5f} -> {losses[-1]:.5f}")
        return self.row

    def profile(self, groups: dict) -> list:
        """One more step under the profiler (`profile_step`); its busy share
        and top device ops go into the row. Returns the kernel events."""
        kernels, summary = profile_step(self.step, self.row["step_ms"], groups, self.label)
        self.row.update(summary)
        return kernels


def phase_slice(device) -> tuple:
    """Train the GPT-2-small-width LM through the Trainer; returns the launch
    counts of the timed steps, the profiled step's device ms a launch of each
    flash kernel, the zoo row and the trained state."""
    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    cfg = TransformerConfig(flash=True, **SLICE)
    run = Run("transformer", make_model(cfg), TrainerConfig(
        optimizer="adam", learning_rate=3e-4, seed=0), BATCH, device)
    row = run.timed(reset_counts=fa.reset_launches)
    launches = dict(fa.LAUNCHES)
    want = cfg.n_layers * STEPS
    require(all(n == want for n in launches.values()),
            f"launch counts {launches}, want {want} each (12 layers x {STEPS} steps)")
    print(f"slice: batch {BATCH} x {cfg.seq_len}, {BATCH * cfg.seq_len / row['step_ms'] * 1e3:.0f} "
          f"tokens/s, launches {launches}")
    kernels = run.profile(LM_GROUPS)
    in_step = {}
    for kname, (fn, _) in DESIGNS.items():
        hits = [e for e in kernels if fn in e.key]
        n = sum(e.count for e in hits)
        if n:
            in_step[kname] = sum(e.self_device_time_total for e in hits) / 1e3 / n
    print("profile: flash kernels' device ms a launch in the step: " + ", ".join(
        f"{k} {ms:.4f}" for k, ms in in_step.items()))
    row.update(config="GPT-2-small width " + json.dumps(SLICE), remat=False, launches=launches)
    row["profiler"] = profiler_on_card(run, device)
    return launches, in_step, row, run.state


#: kernel groups of the profile, by a substring of the kernel's name, first
#: match wins
LM_GROUPS = {
    "flash attention kernels": FLASH_NAMES + FLASH_SLICED_NAMES,
    "f32 matmuls (TF32 off)": ("sgemm", "f32f32_f32f32"),
    "bf16 matmuls": ("gemm", "xmma", "cutlass", "nvjet"),
}
ZOO_GROUPS = {
    "table lookup (gather, sort, segment sums)": (
        "embedding", "indexing", "index_select", "gather", "sum_and_scatter",
        "compute_grad_weight", "partial_segment", "radixsort"),
    "convolutions (cuDNN, layout changes included)": (
        "conv", "wgrad", "dgrad", "fprop", "winograd", "nchwtonhwc", "nhwctonchw",
        "nhwcaddpadding"),
    "matmuls": ("gemm", "gemv", "xmma", "cutlass", "nvjet", "dot_kernel"),
    "group norm": ("rowwisemoments", "computeinternalgradients", "gammabeta",
                   "groupnorm", "group_norm"),
    "dtype casts and copies": ("copy_kernel",),
    "foreach optimizer updates": ("multi_tensor_apply",),
}


def profile_step(step, step_ms: float, groups: dict, label: str, on_profile=None) -> tuple:
    """Where one step's device time goes, by CUDA kernel (torch.profiler),
    and the device's busy share: of the profiled step's own wall time (the
    profiler slows the host) and of the median unprofiled step ``step_ms``.
    ``on_profile(prof, total_us)``, if given, returns more summary fields.
    Returns (the kernel events, empty if not measured; the summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side user annotations (Optimizer.step#...) span kernels counted
    # on their own, so only real kernels are summed
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print(f"profile {label}: device time not measured (the profiler saw no CUDA kernel)")
        return [], {"device_busy_share": None, "top_device_ops": None}
    by_group = dict.fromkeys([*groups, "other"], 0.0)
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in groups.items() if any(k in name for k in keys)),
                     "other")
        by_group[group] += e.self_device_time_total
    busy = total_us / 1e3 / step_ms
    print(f"profile {label}: one step, {total_us / 1e3:.3f} ms of kernels, "
          f"{sum(e.count for e in kernels)} launches; device busy "
          f"{total_us / 1e3 / wall_ms:.1%} of this step's {wall_ms:.3f} ms, "
          f"{busy:.1%} of the median step; " + ", ".join(
              f"{g} {us / 1e3:.3f} ms ({us / total_us:.1%})" for g, us in by_group.items()))
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_OPS]
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<4d} {e.key[:110]}")
    summary = {
        "device_kernel_ms": total_us / 1e3, "device_busy_share": busy,
        "device_ms_by_group": {g: us / 1e3 for g, us in by_group.items()},
        "top_device_ops": [{"op": e.key[:110], "ms": e.self_device_time_total / 1e3,
                            "count": e.count} for e in top]}
    if on_profile is not None:
        summary.update(on_profile(prof, total_us))
    return kernels, summary


def phase_ctr(device) -> tuple:
    """The slice's main path: CTR at its full published width through the
    Trainer with adagrad; padded and untouched table rows must not move.
    Returns the zoo row and the run."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    t0 = time.perf_counter()
    run = Run("ctr", ctr.MODEL, TrainerConfig(optimizer="adagrad", learning_rate=0.05,
                                              seed=0), CTR_BATCH, device)
    module = run.state.params
    setup_s = time.perf_counter() - t0
    # rows no id of the batch reaches: the padded ones, and a sample of real ones
    seen = np.unique(run.host_batch["sparse"])
    unseen = np.setdiff1d(np.arange(ctr.SPARSE_DIM), seen)
    sample = torch.from_numpy(np.random.default_rng(1).choice(unseen, UNTOUCHED_ROWS,
                                                              replace=False)).to(device)
    tables = {name: getattr(module, name) for name in ("deep_table", "wide_table")}
    before = {name: (t[ctr.SPARSE_DIM:].detach().clone(), t[sample].detach().clone())
              for name, t in tables.items()}
    row = run.timed(reset_counts=fa.reset_launches)
    flash_launches = dict(fa.LAUNCHES)
    for name, t in tables.items():
        require(t.shape[0] == CTR_PADDED_ROWS, f"{name} has {t.shape[0]} rows, want "
                                               f"{CTR_PADDED_ROWS}")
        pad, untouched = before[name]
        require(torch.equal(t[ctr.SPARSE_DIM:].detach(), pad),
                f"padded rows of {name} changed in training")
        require(torch.equal(t[sample].detach(), untouched),
                f"rows of {name} that no id reaches changed in training")
    print(f"ctr: tables of {CTR_PADDED_ROWS} rows (sparse dim {ctr.SPARSE_DIM}), "
          f"{len(seen)} distinct ids in the batch of {CTR_BATCH} x {ctr.NUM_SPARSE}; "
          f"after {WARMUP_STEPS + STEPS} steps the {CTR_PADDED_ROWS - ctr.SPARSE_DIM} padded "
          f"rows and {UNTOUCHED_ROWS} sampled rows no id reaches are bit for bit unchanged "
          f"in both tables; set-up {setup_s:.2f} s; flash launches {flash_launches}")
    run.profile(ZOO_GROUPS)
    row["table_backward_ms"] = time_table_backward(module.deep_table, run.batch["sparse"])
    row.update(config=f"sparse dim {ctr.SPARSE_DIM} (tables {CTR_PADDED_ROWS} x "
                      f"{ctr.EMBED_DIM} and x 1), MLP {list(ctr.HIDDEN)}",
               distinct_ids=int(len(seen)), padded_rows_unchanged=True,
               untouched_rows_checked=UNTOUCHED_ROWS, flash_launches=flash_launches)
    return row, run


def time_table_backward(table, ids) -> dict:
    """The deep table's lookup at the step's ids, forward and backward to a
    dense table gradient, by each route PyTorch offers (CUDA events, one
    call at a time): the port's ``F.embedding``, ``table[ids]`` (index_put
    with accumulate) and `dedup_gather` (sort, segment-sum, one
    ``index_add_`` a row). Each gradient must agree with the port's."""
    import torch
    import torch.nn.functional as F

    from edl_tpu_torch.parallel.embedding import dedup_gather

    t = table.detach().requires_grad_()
    cot = torch.randn(ids.shape + (t.shape[1],), generator=torch.Generator(
        device=t.device).manual_seed(3), device=t.device)
    routes = {
        "F.embedding (the port's)": lambda: torch.autograd.grad(F.embedding(ids, t), t, cot),
        "table[ids]": lambda: torch.autograd.grad(t[ids], t, cot),
        "dedup_gather": lambda: torch.autograd.grad(
            dedup_gather(t, ids.reshape(-1)), t, cot.reshape(-1, t.shape[1])),
    }
    (want,) = routes["F.embedding (the port's)"]()
    out = {}
    for name, fn in routes.items():
        (got,) = fn()
        err = ((got - want).norm() / want.norm()).item()
        require(err <= 1e-5, f"the table gradient through {name} is off the port's by {err:.3e}")
        out[name] = time_ms(fn, reps=10, warmup=2)
    print(f"ctr table lookup, forward and backward ({ids.numel()} ids into {t.shape[0]} x "
          f"{t.shape[1]}): " + ", ".join(f"{n} {ms:.3f} ms" for n, ms in out.items()))
    return out


def phase_ctr_cpu_parity(device) -> dict:
    """CTR at full table width on the card against the port on the CPU: the
    same state_dict and batch, the loss, and each param's update after one
    adagrad step."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    cfg = TrainerConfig(optimizer="adagrad", learning_rate=0.05)
    host_batch = ctr.MODEL.synthetic_batch(np.random.default_rng(1), PARITY_BATCH)
    runs = {}
    for where in ("cuda", "cpu"):
        trainer = Trainer(ctr.MODEL, device=device if where == "cuda" else "cpu", config=cfg)
        state = trainer.init_state(torch.Generator().manual_seed(1))
        if where == "cpu":
            state.params.load_state_dict(runs["cuda"]["init"])
        init = {k: v.detach().cpu().clone() for k, v in state.params.state_dict().items()}
        state, loss = trainer.train_step(state, trainer.place_batch(host_batch))
        runs[where] = dict(init=init, loss=float(loss), after={
            k: v.detach().cpu() for k, v in state.params.state_dict().items()})
    gpu, cpu = runs["cuda"], runs["cpu"]
    loss_rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
    errs = {}
    for name, want in cpu["after"].items():
        step_cpu, step_gpu = want - cpu["init"][name], gpu["after"][name] - gpu["init"][name]
        errs[name] = ((step_gpu - step_cpu).norm() / step_cpu.norm()).item()
    worst = max(errs, key=errs.get)
    print(f"ctr card vs CPU (batch {PARITY_BATCH}, tables {CTR_PADDED_ROWS} rows): loss card "
          f"{gpu['loss']:.7f} CPU {cpu['loss']:.7f} (rel {loss_rel:.3e}, tolerance "
          f"{TOL_CTR_LOSS}); one adagrad step's update, rel norm err: " + ", ".join(
              f"{n} {e:.3e}" for n, e in errs.items()) + f" (tolerance {TOL_CTR_UPDATE})")
    require(loss_rel <= TOL_CTR_LOSS, f"CTR loss on the card off the CPU's by {loss_rel:.3e}")
    require(all(math.isfinite(e) and e <= TOL_CTR_UPDATE for e in errs.values()),
            f"CTR updates on the card off the CPU's: {errs}")
    return {"batch": PARITY_BATCH, "loss_rel": loss_rel, "loss_tolerance": TOL_CTR_LOSS,
            "update_rel_norm": errs, "worst": worst, "update_tolerance": TOL_CTR_UPDATE}


def phase_zoo(device) -> list:
    """The other four models at their default widths, each on one placed
    batch through the Trainer."""
    from edl_tpu_torch import models
    from edl_tpu_torch.runtime import TrainerConfig

    rows = []
    for name, (batch, optimizer, lr) in ZOO.items():
        model = models.get(name)
        run = Run(name, model, TrainerConfig(optimizer=optimizer, learning_rate=lr, seed=0),
                  batch, device)
        row = run.timed()
        run.profile(ZOO_GROUPS)
        row["config"] = (json.dumps(dataclasses.asdict(model.config)) if model.config
                         else "default")
        rows.append(row)
        # free this model before the next is built: a run's peak memory
        # starts from what is still allocated when its timed steps begin
        del run
    return rows


def phase_remat(device, off: dict) -> dict:
    """The LM of phase 4 with ``remat=True``, from the same seed and batch:
    the same losses, less memory, and the flash forward run twice a block."""
    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    cfg = TransformerConfig(flash=True, remat=True, **SLICE)
    run = Run("transformer (remat)", make_model(cfg), TrainerConfig(
        optimizer="adam", learning_rate=3e-4, seed=0), BATCH, device)
    row = run.timed(reset_counts=fa.reset_launches)
    launches = dict(fa.LAUNCHES)
    want = {"fwd": 2 * cfg.n_layers * STEPS, "bwd_dq": cfg.n_layers * STEPS,
            "bwd_dkv": cfg.n_layers * STEPS}
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(row["losses"], off["losses"]))
    print(f"remat: step {row['step_ms']:.3f} ms against {off['step_ms']:.3f} ms without remat "
          f"({row['step_ms'] / off['step_ms'] - 1:+.1%}); peak memory "
          f"{row['peak_memory_gib']:.3f} against {off['peak_memory_gib']:.3f} GiB; losses "
          f"within {loss_rel:.3e} rel of the remat-off run's (tolerance {TOL_REMAT_LOSS}); "
          f"launches {launches}, want {want}")
    require(launches == want, f"remat launch counts {launches}, want {want}")
    require(row["peak_memory_gib"] < off["peak_memory_gib"],
            "remat does not lower the peak memory")
    require(loss_rel <= TOL_REMAT_LOSS, f"remat losses off the remat-off run's by {loss_rel:.3e}")
    run.profile(LM_GROUPS)
    row.update(config="GPT-2-small width " + json.dumps(SLICE), remat=True,
               launches=launches, loss_rel_to_remat_off=loss_rel,
               step_ms_remat_off=off["step_ms"], peak_memory_gib_remat_off=off["peak_memory_gib"])
    return row


def phase_step_parity(device, widths=None, batch_size=None) -> dict:
    """One step at depth 2 through the kernels and through dense attention,
    at ``widths`` (default ``SLICE``) and ``batch_size`` (default ``BATCH``).
    The kernel module's weights are drawn on ``device`` (0.8 B of them at
    d_model 4096, which the host draws in seconds); the plain module is a
    copy of it with ``flash=False`` in every module's config (each block
    reads it as it runs)."""
    import copy

    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, make_model

    widths = SLICE if widths is None else widths
    cfg = TransformerConfig(flash=True, **{**widths, "n_layers": 2})
    model = make_model(cfg)
    kern = model.build(device=device, generator=torch.Generator(device=device).manual_seed(1))
    plain, plain_cfg = copy.deepcopy(kern), dataclasses.replace(cfg, flash=False)
    for module in plain.modules():
        if isinstance(getattr(module, "cfg", None), TransformerConfig):
            module.cfg = plain_cfg
    batch = {k: torch.from_numpy(v).to(device) for k, v in model.synthetic_batch(
        np.random.default_rng(1), BATCH if batch_size is None else batch_size).items()}
    losses = []
    for module in (kern, plain):
        loss = module(batch)
        loss.backward()
        losses.append(loss.item())
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    grads = {}
    for (name, pk), (_, pp) in zip(kern.named_parameters(), plain.named_parameters()):
        grads[name] = ((pk.grad - pp.grad).norm() / pp.grad.norm()).item()
    worst = max(grads, key=grads.get)
    print(f"step parity (depth 2, d_model {cfg.d_model}, head dim {cfg.head_dim}): loss "
          f"kernel {losses[0]:.6f} plain {losses[1]:.6f} (rel {rel:.3e}); worst grad {worst} "
          f"rel norm err {grads[worst]:.3e}")
    require(rel <= TOL_STEP_LOSS, f"depth-2 loss off by {rel:.3e}")
    require(all(math.isfinite(e) and e <= TOL_STEP_GRAD for e in grads.values()),
            f"depth-2 grads off: {grads}")
    return {"loss_rel": rel, "worst_grad": worst, "worst_grad_rel_norm": grads[worst],
            "loss_tolerance": TOL_STEP_LOSS, "grad_tolerance": TOL_STEP_GRAD}


def phase_lm_wide(device, name: str, widths: dict, batch: int, steps: int, attention,
                  source: str) -> dict:
    """The LM at ``widths`` (``name``: lm_d128, lm_d256 or lm_d512) trained by
    the ``Trainer`` on the card: finite, falling losses, exactly n_layers
    launches of each kernel a timed step, each launch of its head dim's bf16
    variants (past a head dim of 256 the sliced kernels, named by their
    column slices) and the forward at the
    tile the table resolves; one profiled step (tokens/s, MFU, peak memory,
    each kernel's device ms a call, the busy share). Then one step at depth
    2 through the kernels and through the plain attention path from the same
    weights, and the ring's per-hop engine at the LM's attention shape
    ``attention``. Returns its record."""
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    t0 = time.perf_counter()
    cfg = TransformerConfig(flash=True, **widths)
    # billions of params, drawn on the card: the host takes tens of seconds
    run = Run(f"transformer {name} ({source} widths)", make_model(cfg), TrainerConfig(
        optimizer="adam", learning_rate=3e-4, seed=0), batch, device,
        generator=torch.Generator(device=device).manual_seed(0))
    row = run.timed(reset_counts=fa.reset_launches, steps=steps)
    launches, variants = dict(fa.LAUNCHES), dict(fa.VARIANT_LAUNCHES)
    want = cfg.n_layers * steps
    require(all(n == want for n in launches.values()),
            f"{name} launch counts {launches}, want {want} each ({cfg.n_layers} layers x "
            f"{steps} steps)")
    _, block_k = fa.resolve_blocks(cfg.seq_len, cfg.head_dim, torch.bfloat16)
    dp = fa.padded_head_dim(cfg.head_dim)
    want_variants = {(k, "bfloat16", dp, fa.column_slices(k, cfg.head_dim)
                      or (block_k if k == "fwd" else None)): want for k in KERNELS}
    require(variants == want_variants, f"{name} variants {variants}, want {want_variants}")
    tokens = batch * cfg.seq_len / row["step_ms"] * 1e3
    print(f"{name}: batch {batch} x {cfg.seq_len}, head dim {cfg.head_dim}, {cfg.n_layers} "
          f"layers, {tokens:.0f} tokens/s, MFU {row['mfu']}, peak memory "
          f"{row['peak_memory_gib']:.3f} GiB, launches {launches}, the forward at keys a "
          f"stage {block_k}")
    kernels = run.profile(LM_GROUPS)
    in_step = {}
    for kname, (fn, _) in DESIGNS.items():
        sliced = FLASH_SLICED_NAMES[list(DESIGNS).index(kname)]
        hits = [e for e in kernels if fn in e.key or sliced in e.key]
        n = sum(e.count for e in hits)
        if n:
            in_step[kname] = sum(e.self_device_time_total for e in hits) / 1e3 / n
    print(f"profile {name}: flash kernels' device ms a call in the step: " + ", ".join(
        f"{k} {ms:.4f}" for k, ms in in_step.items()))
    del run, kernels
    torch.cuda.empty_cache()
    row.update(config=f"{source} widths " + json.dumps(widths), remat=False,
               launches=launches, tokens_per_s=tokens, block_k=block_k,
               variant_launches={" ".join(map(str, k)): n for k, n in variants.items()},
               in_step_ms=in_step)
    row["step_parity"] = phase_step_parity(device, widths, batch)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(0)
    hops = check_merged_hops(fa, gen, device, attention)
    row["merged_hops"] = {str(n): e for n, e in hops.items()}
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    print(f"{name}: the phase {row['seconds']:.1f} s")
    return row


def phase_lm_d128(device) -> dict:
    """`phase_lm_wide` at Pythia-1.4B's widths (``LM_D128``, head dim 128)."""
    return phase_lm_wide(device, "lm_d128", LM_D128, LM_D128_BATCH, LM_D128_STEPS,
                         LM_D128_ATTENTION, "Pythia-1.4B")


def phase_lm_d256(device) -> dict:
    """`phase_lm_wide` at GPT-J-6B's widths (``LM_D256``, head dim 256)."""
    return phase_lm_wide(device, "lm_d256", LM_D256, LM_D256_BATCH, LM_D256_STEPS,
                         LM_D256_ATTENTION, "GPT-J-6B")


def phase_lm_d512(device) -> dict:
    """`phase_lm_wide` at GPT-J-6B's widths with 8 heads (``LM_D512``, head
    dim 512, DeepSeek-V4-Flash's), through the sliced kernels."""
    return phase_lm_wide(device, "lm_d512", LM_D512, LM_D512_BATCH, LM_D512_STEPS,
                         LM_D512_ATTENTION, "GPT-J-6B with 8 heads")


# -- the MoE phase ---------------------------------------------------------------

#: the mixture-of-experts LM at phase 4's width (`bench_lm.py` with
#: EDL_LM_MOE=8): 8 experts at capacity factor 1.25, in two arms from one
#: seed: switch top-1 without aux (bench_lm.py) and GShard top-2 with
#: `examples/lm/train.py`'s aux weight 0.01
MOE = dict(moe_experts=8, moe_capacity_factor=1.25)
MOE_ARMS = {
    "top1": dict(moe_top_k=1, moe_aux_weight=0.0),
    "top2": dict(moe_top_k=2, moe_aux_weight=0.01),
}
#: index form against einsum form on one layer's h: the slot buffers and
#: the forward output equal bit for bit (each slot holds one token row; each
#: output sums at most k exact bf16 products in f32, rounded once), the aux
#: to TOL_MOE_AUX, and each gradient (h, router, w_up, b_up, w_down, b_down)
#: to TOL_MOE_GRAD as a relative norm error (the gates' cotangents sum their
#: D products in another order in each form, so a bf16 rounding of one can
#: differ)
TOL_MOE_AUX = 1e-6
TOL_MOE_GRAD = 1e-2
#: the cotangent of the aux in that check
MOE_CT_AUX = 0.7
#: the planted fault's capacity factor: low enough that some expert drops
#: second choices while it keeps first choices
MOE_FAULT_CF = 0.5
#: steps of the einsum form, timed as a diagnostic after one warm-up step
MOE_EINSUM_STEPS = 3
#: profiler ranges put around the MoE functions in the profiled step -> group
MOE_RANGES = {"moe:router": "router", "moe:experts": "experts (bmm, bias, GELU)",
              "moe:ffn": "dispatch and combine"}


@contextlib.contextmanager
def patched(module, **attrs):
    """Set attributes of a module for the length of a with block."""
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def moe_probe(module, batch) -> dict:
    """A no-grad forward of the MoE LM on the batch, before its first step:
    each layer's dropped share of the choices and aux, and layer 0's input
    ``h`` to the MoE FFN."""
    import torch

    from edl_tpu_torch.models import transformer as tf

    kept, auxes, hs = [], [], []
    real_route, real_ffn = tf._moe_route, tf._moe_ffn

    def route(cfg, tok, router, capacity):
        r = real_route(cfg, tok, router, capacity)
        kept.append(r.keep.float().mean())
        auxes.append(r.aux)
        return r

    def ffn(cfg, h, blk):
        hs.append(h.detach().clone())
        return real_ffn(cfg, h, blk)

    with patched(tf, _moe_route=route, _moe_ffn=ffn), torch.no_grad():
        module(batch)
    dropped = [1.0 - float(x) for x in kept]
    return {"h": hs[0], "dropped_share_by_layer": dropped,
            "dropped_share": sum(dropped) / len(dropped),
            "aux_by_layer": [float(a) for a in auxes]}


def _moe_forms(cfg, h, blk, ct, route=None) -> dict:
    """Index form and einsum form on ``h`` with the cotangent ``ct``: each
    form's slot buffer, output, aux and gradients. ``route``, if given,
    replaces the routing of the index form only (a planted fault)."""
    import torch

    from edl_tpu_torch.models import transformer as tf

    out = {}
    for name, form, fault in (("index", tf._moe_ffn, route),
                              ("einsum", tf._moe_ffn_reference, None)):
        slots = []
        real_experts = tf._moe_experts

        def experts(s, b):
            slots.append(s.detach().clone())
            return real_experts(s, b)

        with patched(tf, _moe_experts=experts, _moe_route=fault or tf._moe_route):
            blk.zero_grad(set_to_none=True)
            hh = h.detach().clone().requires_grad_()
            o, aux = form(cfg, hh, blk)
            ((o * ct).sum() + aux * MOE_CT_AUX).backward()
        grads = {"h": hh.grad, **{n: getattr(blk, n).grad for n in
                                  ("router", "w_up", "b_up", "w_down", "b_down")}}
        out[name] = (slots[0], o.detach(), aux.detach(), grads)
    blk.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    return out


def _forms_agree(forms) -> dict:
    """`_moe_forms`'s two forms held to each other: slots and output equal,
    aux within TOL_MOE_AUX, gradients within TOL_MOE_GRAD."""
    import torch

    (si, oi, ai, gi), (se, oe, ae, ge) = forms["index"], forms["einsum"]
    grads = {n: ((gi[n].float() - ge[n].float()).norm() / ge[n].float().norm()).item()
             for n in ge}
    res = {"slots_equal": torch.equal(si, se), "out_equal": torch.equal(oi, oe),
           "out_max_abs": (oi - oe).abs().max().item(), "aux_abs": (ai - ae).abs().item(),
           "grad_rel_norm": grads}
    res["ok"] = (res["slots_equal"] and res["out_equal"] and res["aux_abs"] <= TOL_MOE_AUX
                 and all(math.isfinite(e) and e <= TOL_MOE_GRAD for e in grads.values()))
    return res


def _priority_fault(real_route):
    """A routing fault: one dropped second choice takes the slot of a kept
    first choice of the same expert, so a token's second choice is served
    ahead of another token's first choice; the gates follow the swap."""
    import torch

    def route(cfg, tok, router, capacity):
        r = real_route(cfg, tok, router, capacity)
        k, T = r.gate.shape
        keep, expert = r.keep.tolist(), r.expert.tolist()
        firsts = {expert[i]: i for i in range(T) if keep[i]}
        i2 = next(i for i in range(T, k * T) if not keep[i] and expert[i] in firsts)
        i1 = firsts[expert[i2]]
        slot = r.slot.clone()
        slot[i1], slot[i2] = r.slot[i2], r.slot[i1]
        keep = slot < capacity
        raw = r.probs.gather(1, r.expert.view(k, T).t()).t()  # (k, T)
        gate = raw * keep.view(k, T).float()
        gate = gate / torch.clamp(gate.sum(dim=0, keepdim=True), min=1e-9)
        return r._replace(slot=slot, keep=keep, gate=gate)

    return route


def check_moe_forms(cfg, h, blk, plant: bool) -> dict:
    """The index form against the einsum form on the card, on one layer's
    real ``h``: slot buffers, output, aux and gradients. With ``plant``,
    then at MOE_FAULT_CF: the comparison passes unplanted and rejects a
    second choice served ahead of a first choice."""
    import torch

    from edl_tpu_torch.models import transformer as tf

    gen = torch.Generator(device=h.device).manual_seed(5)
    ct = torch.randn(h.shape, generator=gen, device=h.device)
    res = _forms_agree(_moe_forms(cfg, h, blk, ct))
    print(f"moe forms k={cfg.moe_top_k}: slots equal {res['slots_equal']}, out equal "
          f"{res['out_equal']} (max abs {res['out_max_abs']:.3e}), aux abs {res['aux_abs']:.3e}, "
          f"grad rel norm " + ", ".join(f"{n} {e:.3e}" for n, e in res["grad_rel_norm"].items()))
    require(res["ok"], f"MoE index form off its einsum form: {res}")
    if plant:
        tight = dataclasses.replace(cfg, moe_capacity_factor=MOE_FAULT_CF)
        clean = _forms_agree(_moe_forms(tight, h, blk, ct))
        planted = _forms_agree(_moe_forms(tight, h, blk, ct,
                                          route=_priority_fault(tf._moe_route)))
        print(f"moe planted fault (cf {MOE_FAULT_CF}): unplanted ok {clean['ok']}; planted ok "
              f"{planted['ok']} (slots equal {planted['slots_equal']}, out equal "
              f"{planted['out_equal']}, out max abs {planted['out_max_abs']:.3e})")
        require(clean["ok"], f"MoE forms disagree at cf {MOE_FAULT_CF}: {clean}")
        require(not planted["ok"] and not planted["out_equal"],
                "the MoE comparison passed a second choice served ahead of a first choice")
        res["planted_fault"] = {"capacity_factor": MOE_FAULT_CF, "clean_ok": clean["ok"],
                                "rejected": not planted["ok"],
                                "out_max_abs": planted["out_max_abs"]}
    return res


def moe_device_groups(prof, total_us: float) -> dict:
    """The profiled MoE step's kernel time by MoE function, from the
    profiler's op tree: a kernel belongs to the innermost MOE_RANGES range
    around the op that launched it in the forward, and in the backward to
    the range of the forward op whose autograd node it runs (matched by
    sequence number). The flash kernels go by their names, and the rest of
    the step's kernel time ``total_us`` is the last group."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]

    def forward_group(e):
        while e is not None:
            if e.name in MOE_RANGES:
                return MOE_RANGES[e.name]
            e = e.cpu_parent
        return None

    by_seq = {}
    for e in events:
        group = forward_group(e)
        if group is not None and e.sequence_nr >= 0:
            by_seq.setdefault(e.sequence_nr, group)
    us = dict.fromkeys(MOE_RANGES.values(), 0.0)
    for e in events:
        if not e.kernels:
            continue
        group, node = forward_group(e), e
        while group is None and node is not None:
            if node.name.startswith("autograd::engine::evaluate_function"):
                group = by_seq.get(node.sequence_nr)
                break
            node = node.cpu_parent
        if group is not None:
            us[group] += sum(k.duration for k in e.kernels
                             if not any(f in k.name for f in FLASH_NAMES))
    flash = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and any(f in e.key for f in FLASH_NAMES))
    us = {"flash attention kernels": flash, **us,
          "the rest": total_us - flash - sum(us.values())}
    print("profile moe: " + ", ".join(f"{g} {t / 1e3:.3f} ms ({t / total_us:.1%})"
                                      for g, t in us.items()))
    return {"moe_device_ms": {g: t / 1e3 for g, t in us.items()}}


def profile_moe_step(run) -> None:
    """`Run.profile` with the MoE functions inside profiler ranges."""
    from torch.profiler import record_function

    from edl_tpu_torch.models import transformer as tf

    def ranged(name, fn):
        def wrapper(*args):
            with record_function(name):
                return fn(*args)
        return wrapper

    ranges = {"_moe_route": "moe:router", "_moe_experts": "moe:experts", "_moe_ffn": "moe:ffn"}
    with patched(tf, **{fn: ranged(name, getattr(tf, fn)) for fn, name in ranges.items()}):
        _, summary = profile_step(run.step, run.row["step_ms"], LM_GROUPS, run.label,
                                  on_profile=moe_device_groups)
    run.row.update(summary)


def time_einsum_form(run) -> dict:
    """Diagnostic, not the main path: steps with `_moe_ffn_reference` (the
    one-hot einsums) in place of the index form, timed as `Run.timed` times."""
    import torch

    from edl_tpu_torch.models import transformer as tf

    with patched(tf, _moe_ffn=tf._moe_ffn_reference):
        run.step()
        torch.cuda.reset_peak_memory_stats(run.device)
        times, losses = [], []
        for _ in range(MOE_EINSUM_STEPS):
            t0 = time.perf_counter()
            run.state, loss = run.trainer.train_step(run.state, run.batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
    require(all(math.isfinite(x) for x in losses), f"einsum-form losses {losses}")
    return {"step_ms": statistics.median(times) * 1e3,
            "peak_memory_gib": torch.cuda.max_memory_allocated(run.device) / 2**30,
            "steps": MOE_EINSUM_STEPS}


def phase_moe(device, dense: dict) -> dict:
    """The MoE LM at phase 4's width, both arms from one seed: the probe at
    the first step, the forms check on layer 0's h, the timed steps (12
    launches of each flash kernel a step), a profiled step and the einsum
    form's diagnostic steps. ``dense`` is phase 4's row."""
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import TrainerConfig

    fa = _flash_module()
    out = {"config": "GPT-2-small width " + json.dumps({**SLICE, **MOE}), "batch": BATCH,
           "dense_step_ms": dense["step_ms"], "dense_mfu": dense["mfu"],
           "dense_peak_memory_gib": dense["peak_memory_gib"], "arms": {}}
    launches_total = dict.fromkeys(fa.LAUNCHES, 0)
    for name, arm in MOE_ARMS.items():
        cfg = TransformerConfig(flash=True, **SLICE, **MOE, **arm)
        run = Run(f"transformer moe {name}", make_model(cfg), TrainerConfig(
            optimizer="adam", learning_rate=3e-4, seed=0), BATCH, device)
        probe = moe_probe(run.state.params, run.batch)
        aux_term = cfg.moe_aux_weight / cfg.n_layers * sum(probe["aux_by_layer"])
        print(f"moe {name}: dropped share at the first step {probe['dropped_share']:.4f} "
              f"(by layer {[round(x, 4) for x in probe['dropped_share_by_layer']]}); aux "
              f"{[round(x, 4) for x in probe['aux_by_layer']]}, its loss term {aux_term:.6f}")
        require(all(math.isfinite(a) for a in probe["aux_by_layer"]), "non-finite MoE aux")
        if cfg.moe_aux_weight > 0:
            require(math.isfinite(aux_term) and aux_term > 0, f"aux term {aux_term}")
        forms = check_moe_forms(cfg, probe.pop("h"), run.state.params.blocks[0],
                                plant=cfg.moe_top_k > 1)
        row = run.timed(reset_counts=fa.reset_launches)
        launches = dict(fa.LAUNCHES)
        want = cfg.n_layers * STEPS
        require(all(n == want for n in launches.values()),
                f"moe {name}: launch counts {launches}, want {want} each")
        for k, n in launches.items():
            launches_total[k] += n
        tokens_s = BATCH * cfg.seq_len / row["step_ms"] * 1e3
        print(f"moe {name}: step {row['step_ms']:.3f} ms against the dense {dense['step_ms']:.3f} "
              f"ms ({row['step_ms'] / dense['step_ms']:.3f}x), {tokens_s:.0f} tokens/s, MFU "
              f"{row['mfu']}, peak {row['peak_memory_gib']:.3f} GiB, launches {launches}")
        profile_moe_step(run)
        einsum = time_einsum_form(run)
        print(f"moe {name}: einsum form (diagnostic) {einsum['step_ms']:.3f} ms a step against "
              f"{row['step_ms']:.3f} (+{einsum['step_ms'] - row['step_ms']:.3f} ms), peak "
              f"{einsum['peak_memory_gib']:.3f} GiB")
        row.update(probe, arm=arm, tokens_per_s=tokens_s, aux_term_first_step=aux_term,
                   launches=launches, forms=forms, einsum_form=einsum)
        out["arms"][name] = row
        del run
        torch.cuda.empty_cache()
    out["launches"] = launches_total
    return out


# -- the data path phase ---------------------------------------------------------

#: file-fed CTR through leases: shards of DATA_SHARD_BATCHES x CTR_BATCH rows
DATA_SHARDS = 4
DATA_SHARD_BATCHES = 4
#: the arms (raw sync, wire sync, wire pipelined), interleaved: rounds of
#: DATA_ROUND_STEPS steps each, the first round a warm-up left out of the
#: throughput; then DATA_PROFILE_STEPS steps of each under the profiler
DATA_ROUNDS = 4
DATA_ROUND_STEPS = 8
DATA_PROFILE_STEPS = 4
DATA_DEPTH = 2
#: a diagnostic fourth arm: (c) run with the interpreter's thread switch
#: interval at this many seconds instead of its default 5 ms, to see how much
#: of the pipelined arm's time is the pump and the step waiting for the GIL
DATA_SWITCH_INTERVAL = 1e-4
#: arm (c) saves a checkpoint after this many steps of its first round and
#: trains on; a restored Trainer then takes the next two steps
CKPT_AT = 3
#: raw against wire transport: the runs differ only by the bf16 rounding of
#: the dense features (the deep MLP casts them to bf16 in both; the wide
#: path's f32 dense product sees the rounded values), about 1e-5 of the loss
#: over 12 steps at this width on the CPU; the bound leaves 100x
TOL_RAW_WIRE = 1e-3
#: the wire arms (sync and pipelined) run the same ops on the same batches
#: and must agree bit for bit when the card's embedding backward is
#: deterministic (probed first); otherwise within this relative bound
TOL_NONDETERMINISTIC = 1e-5
#: gradient accumulation at GPT-2-small width (phase 4's LM): N microbatches
#: against N = 1 from the same weights and batch. The first loss to 1e-3
#: relative; each leaf's gradient to TOL_STEP_GRAD relative norm (bf16
#: matmuls over batches of 2 against 8 round in other places; 2.5e-3 at
#: most at d_model 128 on the CPU)
ACCUM = 4
TOL_ACCUM_LOSS = 1e-3
ACCUM_TIMED = 3


def _embedding_backward_deterministic(table, ids) -> bool:
    """Whether the card's ``F.embedding`` backward gives the same table
    gradient twice on the same ids and cotangent."""
    import torch
    import torch.nn.functional as F

    t = table.detach().requires_grad_()
    cot = torch.randn(ids.shape + (t.shape[1],), generator=torch.Generator(
        device=t.device).manual_seed(3), device=t.device)
    grads = [torch.autograd.grad(F.embedding(ids, t), t, cot)[0] for _ in range(2)]
    return bool(torch.equal(grads[0], grads[1]))


def data_path_files(device, root: str) -> dict:
    """CTR fed from shard files through coordinator leases: the port's
    ``write_shard``, ``InProcessCoordinator``, ``LeaseReader(prefetch=True)``
    over ``FileShardSource(shuffle_seed=1)`` and a Trainer with wire transport
    and pipelined placement. Every lease must end completed."""
    import os

    import numpy as np

    from edl_tpu_torch.coordinator import InProcessCoordinator
    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime import Trainer, TrainerConfig
    from edl_tpu_torch.runtime.data import (FileShardSource, LeaseReader, shard_names,
                                            write_shard)

    shards = shard_names("ctr", DATA_SHARDS)
    rows = DATA_SHARD_BATCHES * CTR_BATCH
    rng = np.random.default_rng(21)
    t0 = time.perf_counter()
    for name in shards:
        write_shard(root, name, ctr.MODEL.synthetic_batch(rng, rows))
    write_s = time.perf_counter() - t0
    disk = sum(os.path.getsize(os.path.join(root, f"{n}.npz")) for n in shards)
    coord = InProcessCoordinator(task_lease_sec=600.0)
    client = coord.client("trainer-0")
    client.register()
    client.add_tasks(shards)
    reader = LeaseReader(client, FileShardSource(root, CTR_BATCH, shuffle_seed=1),
                         prefetch=True)
    trainer = Trainer(ctr.MODEL, device=device, config=TrainerConfig(
        optimizer="adagrad", learning_rate=0.05, seed=0, wire_transport=True,
        pipeline_depth=DATA_DEPTH))
    state, m = trainer.run(trainer.init_state(), iter(reader))
    status = client.status()
    steps = int(m["steps"])
    print(f"data_path files: {DATA_SHARDS} shards of {rows} rows written in {write_s:.2f} s "
          f"({disk / 1e6:.1f} MB compressed); {steps} steps through leases, prefetch, wire and "
          f"depth {DATA_DEPTH}: {m['samples_per_sec']:.0f} samples/s, place "
          f"{m['place_seconds'] / max(steps, 1) * 1e3:.3f} ms a step, loss mean "
          f"{m['mean_loss']:.5f} final {m['final_loss']:.5f}; completed {reader.completed}; "
          f"coordinator {status}")
    require(steps == DATA_SHARDS * DATA_SHARD_BATCHES,
            f"file-fed run took {steps} steps, want {DATA_SHARDS * DATA_SHARD_BATCHES}")
    require(sorted(reader.completed) == shards and reader.exhausted,
            f"leases not all completed: {reader.completed}")
    require((status["done"], status["leased"], status["queued"]) == (DATA_SHARDS, 0, 0),
            f"coordinator still holds work: {status}")
    require(math.isfinite(m["final_loss"]) and m["final_loss"] < m["mean_loss"],
            f"file-fed loss not finite and falling: {m}")
    return dict(shards=DATA_SHARDS, rows_per_shard=rows, write_s=write_s, disk_bytes=disk,
                steps=steps, samples_per_s=m["samples_per_sec"],
                place_ms_per_step=m["place_seconds"] / steps * 1e3,
                final_loss=m["final_loss"], mean_loss=m["mean_loss"],
                completed=list(reader.completed), status=status)


def data_path_arms(device, root: str, ctr_row: dict) -> dict:
    """Raw sync, wire sync and wire pipelined CTR from the same weights on
    the same batches, interleaved; arm (c) saves a checkpoint mid-run that a
    fresh Trainer restores. Returns the arms' figures and checks."""
    import os

    import numpy as np
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime import Trainer, TrainerConfig
    from edl_tpu_torch.runtime.checkpoint import STATE_FILE, Checkpointer

    rng = np.random.default_rng(22)
    batches = [ctr.MODEL.synthetic_batch(rng, CTR_BATCH)
               for _ in range(DATA_ROUNDS * DATA_ROUND_STEPS)]
    arms = {"a_raw_sync": (False, 0), "b_wire_sync": (True, 0),
            "c_wire_pipelined": (True, DATA_DEPTH),
            "d_wire_pipelined_switch_100us": (True, DATA_DEPTH)}
    switch = {"d_wire_pipelined_switch_100us": DATA_SWITCH_INTERVAL}

    def run_arm(k, state, chunk, depth):
        """``Trainer.run`` of arm ``k`` over ``chunk``: (state, metrics)."""
        default = sys.getswitchinterval()
        sys.setswitchinterval(switch.get(k, default))
        try:
            return trainers[k].run(state, iter(chunk), pipeline_depth=depth)
        finally:
            sys.setswitchinterval(default)

    def trainer_for(wire: bool):
        return Trainer(ctr.MODEL, device=device, config=TrainerConfig(
            optimizer="adagrad", learning_rate=0.05, seed=0, wire_transport=wire))

    trainers = {k: trainer_for(w) for k, (w, _) in arms.items()}
    states = {k: t.init_state() for k, t in trainers.items()}  # the same weights
    deterministic = _embedding_backward_deterministic(
        states["b_wire_sync"].params.deep_table,
        torch.from_numpy(batches[0]["sparse"]).to(device))
    rounds = {k: [] for k in arms}
    ck = Checkpointer(os.path.join(root, "ckpt"))
    ckpt = {}
    for r in range(DATA_ROUNDS):
        chunk = batches[r * DATA_ROUND_STEPS:(r + 1) * DATA_ROUND_STEPS]
        order = list(arms) if r % 2 == 0 else list(arms)[::-1]
        for k in order:
            _, depth = arms[k]
            if r == 0 and k == "c_wire_pipelined":
                # save mid-run and train on at once: the next steps update
                # the params in place while the writer may still run
                states[k], _ = run_arm(k, states[k], chunk[:CKPT_AT], depth)
                t0 = time.perf_counter()
                ck.save(states[k].step, states[k])
                ckpt["save_blocking_ms"] = (time.perf_counter() - t0) * 1e3
                ckpt["step"] = states[k].step
                after = []
                for b in chunk[CKPT_AT:CKPT_AT + 2]:
                    states[k], m1 = run_arm(k, states[k], [b], depth)
                    after.append(m1["final_loss"])
                states[k], m2 = run_arm(k, states[k], chunk[CKPT_AT + 2:], depth)
                ckpt["uninterrupted_losses"] = after
                m = dict(m2, seconds=float("nan"), place_seconds=float("nan"))
            else:
                states[k], m = run_arm(k, states[k], chunk, depth)
            rounds[k].append(m)
    ck.wait()
    ckpt["durable_s"] = ck.durable_seconds
    ckpt["bytes"] = os.path.getsize(os.path.join(ck.directory, str(ckpt["step"]), STATE_FILE))
    fresh = trainer_for(True)
    restored = fresh.init_state(torch.Generator().manual_seed(7))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ck.restore(restored)
    torch.cuda.synchronize()
    ckpt["restore_s"] = time.perf_counter() - t0
    resumed = []
    for b in batches[CKPT_AT:CKPT_AT + 2]:
        restored, m = fresh.run(restored, iter([b]), pipeline_depth=DATA_DEPTH)
        resumed.append(m["final_loss"])
    ckpt["resumed_losses"] = resumed
    ck.close()
    del fresh, restored

    # (b), (c) and (d): the same ops on the same batches
    pairs = list(zip(ckpt["uninterrupted_losses"], ckpt["resumed_losses"]))
    param_diff = 0.0
    for k in ("c_wire_pipelined", "d_wire_pipelined_switch_100us"):
        pairs += [(x["final_loss"], y["final_loss"]) for x, y in
                  zip(rounds["b_wire_sync"], rounds[k])]
        pairs += [(x["mean_loss"], y["mean_loss"]) for x, y in
                  zip(rounds["b_wire_sync"][1:], rounds[k][1:])]
        param_diff = max([param_diff] + [
            (a.detach() - b.detach()).abs().max().item() for a, b in
            zip(states["b_wire_sync"].params.parameters(), states[k].params.parameters())])
    loss_diff = max(abs(x - y) / abs(y) for x, y in pairs)
    if deterministic:
        require(loss_diff == 0 and param_diff == 0,
                f"wire sync, wire pipelined and the resumed run differ: losses rel "
                f"{loss_diff:.3e}, params abs {param_diff:.3e} (the embedding backward is "
                f"deterministic, so they must agree bit for bit)")
    else:
        require(loss_diff <= TOL_NONDETERMINISTIC,
                f"wire arms / resumed run differ by {loss_diff:.3e} rel "
                f"(tolerance {TOL_NONDETERMINISTIC}, nondeterministic embedding backward)")
    # (a) and (b): the bf16 rounding of the dense features
    raw_wire = max(abs(x[key] - y[key]) / abs(x[key])
                   for x, y in zip(rounds["a_raw_sync"], rounds["b_wire_sync"])
                   for key in ("final_loss", "mean_loss"))
    require(raw_wire <= TOL_RAW_WIRE,
            f"raw and wire transport differ by {raw_wire:.3e} rel (tolerance {TOL_RAW_WIRE})")
    for k in arms:
        require(all(math.isfinite(m["final_loss"]) for m in rounds[k]), f"{k}: non-finite loss")

    # the decoded batch on the card against the plain decode on the host
    codec = trainers["b_wire_sync"]._codec
    host_batch = batches[-1]
    encoded = codec.encode(host_batch)
    on_card = codec.decode({k: v.to(device) for k, v in encoded.items()})
    on_host = codec.decode(encoded)
    for k in on_host:
        require(torch.equal(on_card[k].cpu(), on_host[k]),
                f"{k}: the card's decode differs from the host's")
        if k != "dense":
            require(torch.equal(on_host[k], torch.from_numpy(host_batch[k])),
                    f"{k}: the int decode is not exact")
    raw_bytes = sum(v.nbytes for v in host_batch.values())
    wire_bytes = codec.wire_bytes(host_batch)

    figures = {}
    for k, (wire, depth) in arms.items():
        timed = rounds[k][1:]
        steps = sum(m["steps"] for m in timed)
        seconds = sum(m["seconds"] for m in timed)
        step_ms = seconds / steps * 1e3

        def profiled(k=k, depth=depth):
            states[k], _ = run_arm(k, states[k], batches[:DATA_PROFILE_STEPS], depth)
            torch.cuda.synchronize()

        _, summary = profile_step(profiled, step_ms * DATA_PROFILE_STEPS, ZOO_GROUPS,
                                  f"data_path {k} ({DATA_PROFILE_STEPS} steps)")
        figures[k] = dict(
            wire_transport=wire, pipeline_depth=depth, steps=steps,
            switch_interval_s=switch.get(k, sys.getswitchinterval()),
            samples_per_s=CTR_BATCH * steps / seconds, step_ms=step_ms,
            place_ms_per_step=sum(m["place_seconds"] for m in timed) / steps * 1e3,
            device_busy_share=summary["device_busy_share"],
            device_kernel_ms_per_step=(summary["device_kernel_ms"] / DATA_PROFILE_STEPS
                                       if summary["device_busy_share"] is not None else None),
            round_samples_per_s=[CTR_BATCH * m["steps"] / m["seconds"] for m in timed])
        print(f"data_path arm {k}: {figures[k]['samples_per_s']:.0f} samples/s "
              f"({step_ms:.3f} ms a step over {steps} steps in {len(timed)} interleaved "
              f"rounds), place {figures[k]['place_ms_per_step']:.3f} ms a step, busy "
              f"{summary['device_busy_share']}")
    print(f"data_path: wire {wire_bytes} bytes a step against raw {raw_bytes} "
          f"({wire_bytes / raw_bytes:.3f}); embedding backward deterministic: "
          f"{deterministic}; wire sync vs pipelined (both) vs resumed: losses rel "
          f"{loss_diff:.3e}, "
          f"params abs {param_diff:.3e}; raw vs wire {raw_wire:.3e} rel (tolerance "
          f"{TOL_RAW_WIRE}); decode on the card equals the host's bit for bit")
    print(f"data_path checkpoint: save at step {ckpt['step']} blocked "
          f"{ckpt['save_blocking_ms']:.3f} ms, durable after {ckpt['durable_s']:.3f} s, "
          f"{ckpt['bytes'] / 1e6:.1f} MB, restore {ckpt['restore_s']:.3f} s; steps "
          f"{CKPT_AT + 1}-{CKPT_AT + 2}: uninterrupted {ckpt['uninterrupted_losses']}, "
          f"resumed {ckpt['resumed_losses']}")
    return dict(
        arms=figures, wire_bytes_per_step=wire_bytes, raw_bytes_per_step=raw_bytes,
        embedding_backward_deterministic=deterministic,
        wire_arms_loss_rel_diff=loss_diff, wire_arms_param_abs_diff=param_diff,
        raw_vs_wire_loss_rel=raw_wire, tol_raw_wire=TOL_RAW_WIRE,
        tol_nondeterministic=None if deterministic else TOL_NONDETERMINISTIC,
        decode_card_equals_host=True, checkpoint=ckpt,
        ctr_phase_step_ms=ctr_row["step_ms"],
        ctr_phase_busy_share=ctr_row.get("device_busy_share"))


def data_path_grad_accum(device) -> dict:
    """Phase 4's LM at GPT-2-small width with ``grad_accum_microbatches=ACCUM``
    against 1, from the same weights and batch: first loss, gradients,
    flash launches per step, peak memory and step time."""
    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    fa = _flash_module()
    model = make_model(TransformerConfig(flash=True, **SLICE))
    batch = model.synthetic_batch(np.random.default_rng(0), BATCH)
    out, grads = {}, None
    for n in (1, ACCUM):
        trainer = Trainer(model, device=device, config=TrainerConfig(
            optimizer="adam", learning_rate=3e-4, seed=0, grad_accum_microbatches=n))
        state = trainer.init_state()
        placed = trainer.place_batch(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        fa.reset_launches()
        state, loss = trainer.train_step(state, placed)
        first = float(loss)
        per_step = dict(fa.LAUNCHES)
        g = {k: p.grad.detach().cpu().clone() for k, p in state.params.named_parameters()}
        if grads is None:
            grads = g
            grad_err = None
        else:
            grad_err = {k: ((g[k] - grads[k]).norm() / grads[k].norm()).item() for k in g}
        state, _ = trainer.train_step(state, placed)  # warm-up
        times = []
        for _ in range(ACCUM_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, placed)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = dict(fa.LAUNCHES)
        step_ms = statistics.median(times) * 1e3
        peak = torch.cuda.max_memory_allocated(device) / 2**30

        def one_step(trainer=trainer, placed=placed):
            nonlocal state
            state, _ = trainer.train_step(state, placed)
            torch.cuda.synchronize()

        _, summary = profile_step(one_step, step_ms, LM_GROUPS,
                                  f"data_path LM, {n} microbatch(es)")
        out[n] = dict(first_loss=first, step_ms=step_ms, peak_memory_gib=peak,
                      launches_first_step=per_step, launches=launches,
                      steps=2 + ACCUM_TIMED, last_loss=float(loss), grad_rel_err=grad_err,
                      device_busy_share=summary["device_busy_share"],
                      device_kernel_ms=summary.get("device_kernel_ms"))
        del trainer, state, placed, loss
        torch.cuda.empty_cache()
    one, acc = out[1], out[ACCUM]
    loss_rel = abs(acc["first_loss"] - one["first_loss"]) / abs(one["first_loss"])
    worst = max(acc["grad_rel_err"], key=acc["grad_rel_err"].get)
    print(f"data_path grad accumulation at GPT-2-small width, batch {BATCH}: N={ACCUM} "
          f"first loss {acc['first_loss']:.6f} against N=1 {one['first_loss']:.6f} (rel "
          f"{loss_rel:.3e}); worst gradient {worst} rel norm {acc['grad_rel_err'][worst]:.3e} "
          f"(tolerance {TOL_STEP_GRAD}); flash launches a step {acc['launches_first_step']} "
          f"against {one['launches_first_step']}; step {acc['step_ms']:.3f} against "
          f"{one['step_ms']:.3f} ms; peak memory {acc['peak_memory_gib']:.3f} against "
          f"{one['peak_memory_gib']:.3f} GiB")
    require(loss_rel <= TOL_ACCUM_LOSS, f"N={ACCUM} first loss off N=1's by {loss_rel:.3e}")
    require(all(math.isfinite(e) and e <= TOL_STEP_GRAD for e in acc["grad_rel_err"].values()),
            f"N={ACCUM} gradients off N=1's: {acc['grad_rel_err']}")
    for k, n1 in one["launches_first_step"].items():
        require(n1 == SLICE["n_layers"] and acc["launches_first_step"][k] == ACCUM * n1,
                f"flash launches a step: N={ACCUM} {acc['launches_first_step']}, N=1 "
                f"{one['launches_first_step']}")
        require(acc["launches"][k] == ACCUM * SLICE["n_layers"] * acc["steps"],
                f"{k}: {acc['launches'][k]} launches over {acc['steps']} steps of N={ACCUM}")
    require(acc["peak_memory_gib"] < one["peak_memory_gib"],
            f"N={ACCUM} peak memory {acc['peak_memory_gib']:.3f} GiB is not under N=1's")
    require(math.isfinite(acc["last_loss"]) and acc["last_loss"] < acc["first_loss"],
            f"N={ACCUM} loss not finite and falling")
    return dict(microbatches=ACCUM, batch=BATCH, first_loss_rel=loss_rel,
                tol_first_loss=TOL_ACCUM_LOSS, worst_grad=worst,
                worst_grad_rel_err=acc["grad_rel_err"][worst], tol_grad=TOL_STEP_GRAD,
                n1={k: v for k, v in one.items() if k != "grad_rel_err"},
                accum={k: v for k, v in acc.items() if k != "grad_rel_err"},
                launches=acc["launches"])


def phase_data_path(device, ctr_row: dict) -> dict:
    """CTR's production input path at full width, checkpoints, and
    gradient accumulation on the LM; returns the ``data_path`` line."""
    with tempfile.TemporaryDirectory(prefix="edl-data-") as root:
        files = data_path_files(device, root)
        arms = data_path_arms(device, root, ctr_row)
    grad_accum = data_path_grad_accum(device)
    return dict(files=files, **arms, grad_accum=grad_accum)


# -- the serve phase -----------------------------------------------------------

#: the LM tier at GPT-2-small width (phase 4's LM): batch and seq buckets, and
#: a KV pool of 1024 blocks of 16 tokens (604 MB at 36,864 B a token: room for
#: 16 streams at 1024)
SERVE_BATCH_BUCKETS = (1, 4, 8)
SERVE_SEQ_BUCKETS = (128, 256, 512, 1024)
SERVE_KV_BLOCKS, SERVE_KV_BLOCK_TOKENS = 1024, 16
#: 16 streams from seed 0 (prompts of 16-512 tokens, 32-64 new tokens),
#: admitted in waves of 6, 5 and 5 (each wave once the one before decodes);
#: the last 4 through HTTP /generate
SERVE_PROMPT_TOKENS = (16, 512)
SERVE_NEW_TOKENS = (32, 64)
SERVE_WAVES = (6, 5, 5)
SERVE_HTTP_STREAMS = 4
#: streams held against a re-prefill per token on the card (the first 4), and
#: against the port's prefill on the CPU (the 2 shortest prompts)
CONSISTENCY_STREAMS = 4
CPU_STREAMS = 2
#: the engine's K/V cache against the prefill's K/V of the same sequence
#: (relative norm): decode and prefill round their bf16 activations at the
#: same places but sum the f32 attention in another order
TOL_SERVE_KV = 1e-2
#: a greedy token may differ from its reference (teacher forced on the same
#: tokens) only where the reference's top logit exceeds the token's logit by
#: at most this many logit units: a near tie that rounding noise may flip.
#: Twice the largest difference of the card's and the CPU's logits over the
#: same sequences (0.028 of logits up to 3.5 in a first run on an H100): a
#: flip needs both logits to move toward each other
TOL_NEAR_TIE = 6e-2
#: timed shapes: prefill (batch, seq) and decode (batch, capacity)
PREFILL_TIMED = ((1, 128), (8, 512))
DECODE_TIMED = ((1, 256), (1, 1024), (8, 256), (8, 1024))
#: the profiled window of the live engine: decode steps at the largest
#: buckets (8, capacity 1024), from 8 streams of PROFILE_PROMPT tokens and 64
#: new tokens each
PROFILE_DECODE_STEPS = 16
PROFILE_PROMPT = 700
PROFILE_NEW_TOKENS = 64
#: the batch tier: CTR at full width, 512 single-row requests from seed 5 by
#: 32 client threads; every 32nd through HTTP /predict; version 2 exported
#: once 128 are answered, and the last 128 sent once it serves
CTR_SERVE_BUCKETS = (1, 8, 32, 256)
CTR_REQUESTS = 512
CTR_HTTP_EVERY = 32
CTR_SWAP_AFTER = 128
CTR_POST_SWAP = 128
CTR_CLIENTS = 32
#: a served answer against the module's predict on all 512 rows at once
#: (cuBLAS picks other kernels at other batch sizes; the MLP is bf16):
#: `tests/test_torch_ctr.py`'s logit tolerance, |d| <= abs + rel * |want|
TOL_CTR_SERVE_ABS, TOL_CTR_SERVE_REL = 2e-3, 2e-2
#: the share of rows whose version-1 and version-2 answers lie outside each
#: other's tolerance must be at least this, or the swap check has no teeth
#: (an answer of version 1 on such a row fails the check against version 2)
CTR_VERSIONS_APART = 0.5


def wait_for(cond, timeout_s: float, msg: str) -> None:
    """Poll ``cond`` every 5 ms (a cheap read: the engine and the dispatcher
    share the interpreter with this thread) until it holds."""
    deadline = time.monotonic() + timeout_s
    while not cond():
        require(time.monotonic() < deadline, msg)
        time.sleep(0.005)


def _post(url: str, payload: dict, timeout: float = 600.0) -> dict:
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _quantiles(xs) -> dict:
    import numpy as np

    return {"p50": float(np.percentile(xs, 50)), "p99": float(np.percentile(xs, 99)),
            "n": len(xs)}


def export_lm(state, root: str) -> dict:
    """Export phase 4's trained LM with the port's ``save_inference_model``
    (versioned), as a trainer publishes for a serving replica."""
    import os

    from edl_tpu_torch.runtime.export import save_inference_model

    directory = os.path.join(root, "lm")
    t0 = time.perf_counter()
    save_inference_model(directory, "transformer", state, config={**SLICE, "flash": True},
                         step=state.step, versioned=True)
    seconds = time.perf_counter() - t0
    print(f"serve: exported phase 4's LM (step {state.step}) in {seconds:.3f} s")
    return {"dir": directory, "step": state.step, "export_s": seconds}


def stage_ctr_versions(run, root: str) -> dict:
    """Export phase 6's CTR as version 1 (versioned layout), then take two
    more adagrad steps on new batches: version 2, kept on the host for the
    serve phase to export mid-traffic. Both versions' state_dicts are kept on
    the host as the references of the answers."""
    import os

    import numpy as np

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.runtime.export import save_inference_model

    directory = os.path.join(root, "ctr")

    def host_state():
        return {k: v.detach().cpu().clone() for k, v in run.state.params.state_dict().items()}

    t0 = time.perf_counter()
    save_inference_model(directory, "ctr", run.state, step=run.state.step, versioned=True)
    seconds = time.perf_counter() - t0
    v1 = {"step": run.state.step, "state": host_state()}
    for seed in (11, 12):
        batch = run.trainer.place_batch(ctr.MODEL.synthetic_batch(np.random.default_rng(seed),
                                                                  CTR_BATCH))
        run.state, _ = run.trainer.train_step(run.state, batch)
    v2 = {"step": run.state.step, "state": host_state()}
    print(f"serve: exported phase 6's CTR as version 1 (step {v1['step']}) in {seconds:.3f} s; "
          f"version 2 is step {v2['step']}")
    return {"dir": directory, 1: v1, 2: v2, "export_s": seconds}


def _teacher_forced(module, prompts, generated) -> list:
    """The reference of each stream's greedy tokens: for token j, the
    prefill of prompt + generated[:j] (the streams of a step batched, right
    padded to a seq bucket), its f32 logits at the last position. Returns per
    stream (logits (n, V), and K and V (L, len, H, Dh) of its last prefill,
    which covers every cached position)."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import transformer
    from edl_tpu_torch.serving.batcher import pad_token_rows, pick_seq_bucket

    out = [{"logits": []} for _ in prompts]
    device = module.embed.device
    for j in range(max(len(g) for g in generated)):
        live = [i for i, g in enumerate(generated) if j < len(g)]
        seqs = [np.concatenate([prompts[i], np.asarray(generated[i][:j], np.int32)])
                for i in live]
        seq_bucket = pick_seq_bucket(max(len(q) for q in seqs), SERVE_SEQ_BUCKETS)
        tokens, lengths = pad_token_rows(seqs, len(seqs), seq_bucket)
        with torch.no_grad():
            x, k, v = transformer._prefill_forward(module, torch.from_numpy(tokens).to(device))
            last = torch.from_numpy(lengths.astype(np.int64) - 1).to(device)
            h = x[torch.arange(len(live), device=device), last]
            logits = transformer._rmsnorm(h, module.lnf).float() @ module.head
        for r, i in enumerate(live):
            out[i]["logits"].append(logits[r])
            if j == len(generated[i]) - 1:
                out[i]["k"] = k[:, r, :lengths[r]]
                out[i]["v"] = v[:, r, :lengths[r]]
    for o in out:
        o["logits"] = torch.stack(o["logits"])
    return out


def _rel(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _token_check(logits, tokens) -> dict:
    """Greedy ``tokens`` against reference ``logits`` (n, V): the positions
    where they differ, and the reference's margin there (its top logit less
    the token's)."""
    import torch

    t = torch.as_tensor(tokens, device=logits.device)
    top = logits.max(dim=-1).values
    margin = top - logits.gather(1, t[:, None].long())[:, 0]
    differ = logits.argmax(dim=-1) != t
    return {"positions": len(tokens), "differ": int(differ.sum()),
            "worst_margin": float(margin[differ].max()) if differ.any() else 0.0}


def check_cache_consistency(replica, prompts, budgets) -> dict:
    """The engine's decode against a re-prefill of the grown sequence per
    token on the card: tokens (near ties allowed) and the stream's K/V cache
    against the last prefill's K/V. Then the same streams with the planted
    fault — the new K/V written one slot late — which the check must reject."""
    import contextlib
    from unittest import mock

    from edl_tpu_torch.serving import LMServingReplica

    caches = {}
    retire = LMServingReplica._retire

    def capturing(self, s, outcome):
        caches[s.id] = (s.k[:, :s.length].clone(), s.v[:, :s.length].clone())
        retire(self, s, outcome)

    def one_slot_late(s, k, v):
        s.k[:, s.length + 1] = k
        s.v[:, s.length + 1] = v

    def run(fault: bool) -> dict:
        caches.clear()
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(LMServingReplica, "_retire", capturing))
            if fault:
                stack.enter_context(mock.patch.object(LMServingReplica, "_append_kv",
                                                      staticmethod(one_slot_late)))
            handles = [replica.submit(p, max_new_tokens=int(b)) for p, b in zip(prompts, budgets)]
            outs = []
            for h in handles:
                try:
                    outs.append(h.result(timeout=600))
                except (RuntimeError, IndexError) as e:  # the fault may write past the cache
                    return {"ok": False, "raised": repr(e)}
        generated = [o["tokens"] for o in outs]
        refs = _teacher_forced(replica._art.module, prompts, generated)
        streams = []
        for prompt, h, g, ref in zip(prompts, handles, generated, refs):
            k, v = caches[h.stream_id]
            kv = {"k": _rel(k, ref["k"]), "v": _rel(v, ref["v"])}
            streams.append({"prompt_tokens": len(prompt), **_token_check(ref["logits"], g),
                            "kv_rel_norm": kv})
        ok = all(s["worst_margin"] <= TOL_NEAR_TIE and max(s["kv_rel_norm"].values()) <= TOL_SERVE_KV
                 for s in streams)
        return {"ok": ok, "streams": streams}

    good = run(fault=False)
    fault = run(fault=True)
    print(f"serve cache check ({len(prompts)} streams against a re-prefill per token): "
          f"{json.dumps(good)}; with the K/V written one slot late: {json.dumps(fault)}")
    require(good["ok"], f"the engine's decode is off a re-prefill per token: {good}")
    require(not fault["ok"], "the cache check passes the planted one-slot-late fault")
    return {"as_built": good, "kv_one_slot_late": fault}


def _lm_traffic(replica, prompts, budgets) -> dict:
    """The 16 streams in staggered waves; returns their results (by index),
    the wall time, and each direct stream's submit time and id."""
    from concurrent.futures import ThreadPoolExecutor

    n, first_http = len(prompts), len(prompts) - SERVE_HTTP_STREAMS
    handles, http, submitted = {}, {}, {}

    def emitted():
        return sum(replica.instruments.tokens.value(phase=p) for p in ("prefill", "decode"))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=SERVE_HTTP_STREAMS) as pool:
        i = 0
        for w, size in enumerate(SERVE_WAVES):
            before = emitted()
            for j in range(i, min(i + size, n)):
                if j >= first_http:
                    http[j] = pool.submit(_post, replica.url + "/generate", {
                        "prompt": prompts[j].tolist(), "max_new_tokens": int(budgets[j])})
                else:
                    submitted[j] = time.time()
                    handles[j] = replica.submit(prompts[j], max_new_tokens=int(budgets[j]))
            i += size
            if w < len(SERVE_WAVES) - 1:
                # the next wave joins a decode batch that is already running
                wait_for(lambda: emitted() >= before + 4 * size, 600, f"wave {w} never decoded")
        results = {j: h.result(timeout=600) for j, h in handles.items()}
        results.update({j: f.result(timeout=600) for j, f in http.items()})
    return {"results": [results[j] for j in range(n)], "wall_s": time.perf_counter() - t0,
            "submitted": submitted, "ids": {j: h.stream_id for j, h in handles.items()}}


def _device_ms(fn) -> tuple:
    """(device kernel ms, launches) of one call of ``fn`` under
    ``torch.profiler``, after a warm-up call; (None, None) when the profiler
    sees no CUDA kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        return None, None
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def time_lm_steps(module, cfg, device) -> dict:
    """One prefill and one decode step at the timed shapes: the time of one
    call at a time (CUDA events, so the host's launches show in it), and
    the device's kernel time and launches in one profiled call. Decode runs
    on a full cache of random K/V."""
    import torch

    from edl_tpu_torch.models import transformer

    prefill = transformer.make_prefill_step(cfg)
    decode = transformer.make_decode_step(cfg)
    gen = torch.Generator(device=device).manual_seed(4)
    L, H, Dh = transformer.lm_cache_shape(cfg)
    calls = {}
    for b, s in PREFILL_TIMED:
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=device,
                               dtype=torch.int32)
        lengths = torch.full((b,), s, dtype=torch.int32, device=device)
        calls[f"prefill_{b}x{s}"] = lambda t=tokens, n=lengths: prefill(module, t, n)
    for b, c in DECODE_TIMED:
        k, v = (torch.randn((L, b, c, H, Dh), generator=gen, device=device).to(torch.bfloat16)
                for _ in range(2))
        tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen, device=device,
                               dtype=torch.int32)
        lengths = torch.full((b,), c - 1, dtype=torch.int32, device=device)
        calls[f"decode_{b}x{c}"] = lambda k=k, v=v, t=tokens, n=lengths: decode(module, k, v, t, n)
    out = {}
    for name, fn in calls.items():
        kernel_ms, launches = _device_ms(fn)
        out[name] = {"ms": time_ms(fn, reps=10, warmup=2), "device_kernel_ms": kernel_ms,
                     "launches": launches}
    print("serve step times (one call at a time; device kernel ms and launches of one call): "
          + ", ".join(f"{name} {r['ms']:.4f} ms ({r['device_kernel_ms']} ms, {r['launches']})"
                      for name, r in out.items()))
    return out


def profile_decode_window(replica, cfg) -> dict:
    """``torch.profiler`` over PROFILE_DECODE_STEPS decode steps of the live
    engine at the largest buckets (8, capacity 1024): device busy share and
    launches a step. The busy share is also given against the median
    unprofiled step of the same streams (the engine's spans after the
    window)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    bucket, capacity = SERVE_BATCH_BUCKETS[-1], SERVE_SEQ_BUCKETS[-1]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, PROFILE_PROMPT).astype(np.int32)
               for _ in range(bucket)]
    handles = [replica.submit(p, max_new_tokens=PROFILE_NEW_TOKENS) for p in prompts]

    def steps():
        return replica.instruments.decode_steps.value(bucket=str(bucket),
                                                      seq_bucket=str(capacity))

    wait_for(lambda: steps() >= 2, 600, "the profiled streams never decoded")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        c0, t0 = steps(), time.perf_counter()
        wait_for(lambda: steps() >= c0 + PROFILE_DECODE_STEPS, 600, "decode stalled")
        wall_ms, n = (time.perf_counter() - t0) * 1e3, steps() - c0
    t_end = time.time()
    for h in handles:
        h.result(timeout=600)
    spans = [sp.seconds * 1e3 for sp in replica.tracer.find(name="lm_decode_step")
             if sp.start > t_end and sp.attrs.get("bucket") == bucket
             and sp.attrs.get("seq_bucket") == capacity]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us == 0:
        print("serve profile: device time not measured (the profiler saw no CUDA kernel)")
        return {"device_busy_share": None, "launches_per_step": None}
    launches = sum(e.count for e in kernels)
    step_ms = statistics.median(spans) if spans else None
    out = {"steps": n, "window_ms": wall_ms, "kernel_ms_per_step": total_us / 1e3 / n,
           "launches_per_step": launches / n,
           "device_busy_share": total_us / 1e3 / wall_ms,
           "unprofiled_step_ms": step_ms,
           "device_busy_share_unprofiled": (total_us / 1e3 / n / step_ms) if step_ms else None,
           "top_device_ops": [{"op": e.key[:110], "ms_per_step": e.self_device_time_total / 1e3 / n,
                               "count_per_step": e.count / n}
                              for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:TOP_OPS]]}
    print(f"serve profile: {n} decode steps at bucket {bucket}, capacity {capacity}: "
          f"{out['kernel_ms_per_step']:.4f} ms of kernels and {out['launches_per_step']:.1f} "
          f"launches a step; device busy {out['device_busy_share']:.1%} of the profiled "
          f"window" + (f", {out['device_busy_share_unprofiled']:.1%} of the median unprofiled "
                       f"step ({step_ms:.4f} ms)" if step_ms else ""))
    for op in out["top_device_ops"]:
        print(f"  {op['ms_per_step']:8.4f} ms x{op['count_per_step']:<6.1f} {op['op']}")
    return out


def check_card_against_cpu(lm_dir, card_module, prompts, generated) -> dict:
    """The card's greedy tokens of the given streams, teacher forced through
    the port's prefill on the CPU from the same artifact: a token may differ
    only at a near tie of the CPU's logits. Also the largest difference of
    the card's and the CPU's logits over the same sequences."""
    import numpy as np
    import torch

    from edl_tpu_torch.models import transformer
    from edl_tpu_torch.runtime.export import load_inference_model

    cpu = load_inference_model(lm_dir, device="cpu").module
    out = []
    for prompt, g in zip(prompts, generated):
        seq = torch.from_numpy(np.concatenate([prompt, np.asarray(g[:-1], np.int32)]))[None]
        cpu_logits = transformer.prefill_logits(cpu, seq)[0, len(prompt) - 1:]
        card_logits = transformer.prefill_logits(card_module, seq.to(card_module.embed.device))
        card_logits = card_logits[0, len(prompt) - 1:].cpu()
        out.append({"prompt_tokens": len(prompt), **_token_check(cpu_logits, g),
                    "max_abs_logit_diff": float((card_logits - cpu_logits).abs().max()),
                    "max_abs_logit": float(cpu_logits.abs().max())})
    ok = all(s["worst_margin"] <= TOL_NEAR_TIE for s in out)
    print(f"serve card vs CPU ({len(out)} streams, teacher forced): {json.dumps(out)}; "
          f"near-tie positions {sum(s['differ'] for s in out)} (tolerance {TOL_NEAR_TIE})")
    require(ok, f"the card's tokens are off the CPU's beyond near ties: {out}")
    return {"streams": out, "near_tie_positions": sum(s["differ"] for s in out),
            "tolerance": TOL_NEAR_TIE}


def serve_lm(device, lm: dict) -> dict:
    """The LM tier on the card (see phase 10 in the module docstring)."""
    import numpy as np
    import torch

    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import MetricsRegistry, parse_prometheus
    from edl_tpu_torch.obs.tracing import Tracer
    from edl_tpu_torch.serving import LMServingConfig, LMServingReplica
    from edl_tpu_torch.serving.__main__ import REQUIRED_LM_FAMILIES

    fa = _flash_module()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    replica = LMServingReplica(LMServingConfig(
        model_dir=lm["dir"], batch_buckets=SERVE_BATCH_BUCKETS, seq_buckets=SERVE_SEQ_BUCKETS,
        kv_blocks=SERVE_KV_BLOCKS, kv_block_tokens=SERVE_KV_BLOCK_TOKENS, port=0,
        name="chip-lm", request_timeout_s=600.0, device=str(device)),
        registry=MetricsRegistry(), tracer=Tracer(component="serving")).start()
    start_s = time.perf_counter() - t0
    try:
        cfg, module = replica._model_cfg, replica._art.module
        n = sum(SERVE_WAVES)
        rng = np.random.default_rng(0)
        plens = rng.integers(SERVE_PROMPT_TOKENS[0], SERVE_PROMPT_TOKENS[1] + 1, n)
        budgets = rng.integers(SERVE_NEW_TOKENS[0], SERVE_NEW_TOKENS[1] + 1, n)
        prompts = [rng.integers(0, cfg.vocab_size, k).astype(np.int32) for k in plens]
        fa.reset_launches()
        traffic = _lm_traffic(replica, prompts, budgets)
        flash_launches = dict(fa.LAUNCHES)
        # the JAX package's serving path runs dense f32 attention, not flash
        require(not any(flash_launches.values()),
                f"the serving path launched flash kernels: {flash_launches}")
        results = traffic["results"]
        short = [j for j, r in enumerate(results)
                 if len(r["tokens"]) != budgets[j] or r["finish_reason"] != "length"]
        require(not short, f"LM streams {short} ended short of their token counts")
        unwarmed = replica.jit_cache_size()
        require(unwarmed == 0, f"{unwarmed} LM dispatch shapes were not warmed")
        families = parse_prometheus(scrape_metrics(replica.url))
        missing = [f for f in REQUIRED_LM_FAMILIES if f not in families]
        require(not missing, f"missing LM metric families: {missing}")
        status = replica.status()
        require(status["completed"] == n and status["rejected"] == 0
                and status["kv"]["used_blocks"] == 0, f"LM replica status: {status}")
        prefill_end = {sp.attrs["stream"]: sp.end for sp in replica.tracer.find(name="lm_prefill")}
        ttft = [prefill_end[traffic["ids"][j]] - t for j, t in traffic["submitted"].items()]
        decode_spans = {}
        for sp in replica.tracer.find(name="lm_decode_step"):
            key = f"{sp.attrs['bucket']}x{sp.attrs['seq_bucket']}"
            decode_spans.setdefault(key, []).append(sp.seconds * 1e3)
        tokens = sum(len(r["tokens"]) for r in results)
        row = {"streams": n, "http_streams": SERVE_HTTP_STREAMS, "waves": list(SERVE_WAVES),
               "prompt_tokens": plens.tolist(), "new_tokens": budgets.tolist(),
               "start_s": start_s, "export_s": lm["export_s"], "artifact_step": lm["step"],
               "tokens": tokens, "wall_s": traffic["wall_s"],
               "tokens_per_s": tokens / traffic["wall_s"],
               "ttft_s": _quantiles(ttft),
               "engine_decode_step_ms": {k: _quantiles(v) for k, v in sorted(decode_spans.items())},
               "kv_peak_blocks": status["kv"]["peak_blocks_used"],
               "flash_launches": flash_launches, "unwarmed_shapes": unwarmed}
        print(f"serve LM: {n} streams ({SERVE_HTTP_STREAMS} over HTTP), {tokens} tokens in "
              f"{traffic['wall_s']:.3f} s ({row['tokens_per_s']:.1f} tokens/s), TTFT p50 "
              f"{row['ttft_s']['p50']:.4f} s p99 {row['ttft_s']['p99']:.4f} s (direct streams), "
              f"replica start {start_s:.2f} s, KV peak {row['kv_peak_blocks']} blocks, flash "
              f"launches {flash_launches}; engine decode step ms by (bucket x capacity): "
              + json.dumps(row["engine_decode_step_ms"]))
        row["cache_consistency"] = check_cache_consistency(
            replica, prompts[:CONSISTENCY_STREAMS], budgets[:CONSISTENCY_STREAMS])
        row["profile"] = profile_decode_window(replica, cfg)
    finally:
        replica.stop()
    row["peak_memory_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    # timed with the replica stopped: no engine or HTTP thread shares the host
    row["step_ms"] = time_lm_steps(module, cfg, device)
    shortest = sorted(range(n), key=lambda j: plens[j])[:CPU_STREAMS]
    row["card_vs_cpu"] = check_card_against_cpu(
        lm["dir"], module, [prompts[j] for j in shortest],
        [results[j]["tokens"] for j in shortest])
    return row


def serve_ctr(device, staged: dict) -> dict:
    """The batch tier on the card (see phase 10 in the module docstring)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.obs.http import scrape_metrics
    from edl_tpu_torch.obs.metrics import MetricsRegistry, parse_prometheus
    from edl_tpu_torch.obs.tracing import Tracer
    from edl_tpu_torch.runtime.export import save_inference_model
    from edl_tpu_torch.serving import ServingConfig, ServingReplica
    from edl_tpu_torch.serving.__main__ import REQUIRED_FAMILIES

    batch = ctr.MODEL.synthetic_batch(np.random.default_rng(5), CTR_REQUESTS)
    rows = [{"dense": batch["dense"][i], "sparse": batch["sparse"][i]}
            for i in range(CTR_REQUESTS)]
    want = {}
    for v in (1, 2):
        module = ctr.MODEL.build(device=device)
        module.load_state_dict(staged[v]["state"])
        with torch.no_grad():
            want[v] = module.predict({k: torch.from_numpy(batch[k]).to(device)
                                      for k in ("dense", "sparse")}).cpu().numpy()
        del module

    def close(got, v):
        return abs(got - want[v]) <= TOL_CTR_SERVE_ABS + TOL_CTR_SERVE_REL * abs(want[v])

    apart = float(np.mean(~close(want[1], 2)))
    require(apart >= CTR_VERSIONS_APART, f"versions 1 and 2 answer apart on only {apart:.1%} of "
                                         "the rows: the swap check would have no teeth")
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    replica = ServingReplica(ServingConfig(
        model_dir=staged["dir"], buckets=CTR_SERVE_BUCKETS, max_batch_delay_s=0.002, port=0,
        version_poll_s=0.05, name="chip-ctr", request_timeout_s=600.0, device=str(device)),
        registry=MetricsRegistry(), tracer=Tracer(component="serving")).start()
    start_s = time.perf_counter() - t0
    answers, latency, sent = [None] * CTR_REQUESTS, [None] * CTR_REQUESTS, [None] * CTR_REQUESTS
    errors, done, lock, publish_s = [], [0], threading.Lock(), []

    def one(i):
        sent[i] = time.time()
        try:
            if i % CTR_HTTP_EVERY == 0:
                reply = _post(replica.url + "/predict", {"features": {
                    k: rows[i][k].tolist() for k in ("dense", "sparse")}})
                answers[i] = float(reply["outputs"])
            else:
                answers[i] = float(replica.predict(rows[i]))
        except Exception as e:  # every failure is counted and fails the phase below
            errors.append((i, repr(e)))
        latency[i] = time.time() - sent[i]
        with lock:
            done[0] += 1

    def publish():
        wait_for(lambda: done[0] >= CTR_SWAP_AFTER, 600, "CTR traffic stalled")
        t = time.perf_counter()
        save_inference_model(staged["dir"], "ctr", staged[2]["state"], step=staged[2]["step"],
                             versioned=True)
        publish_s.append(time.perf_counter() - t)

    try:
        first = range(CTR_REQUESTS - CTR_POST_SWAP)
        publisher = threading.Thread(target=publish)
        publisher.start()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=CTR_CLIENTS) as pool:
            list(pool.map(one, first))
        first_wall = time.perf_counter() - t0
        publisher.join(timeout=600)
        wait_for(lambda: replica.status()["model_step"] == staged[2]["step"], 600,
                 "version 2 never swapped in")
        swapped = time.time()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=CTR_CLIENTS) as pool:
            list(pool.map(one, range(CTR_REQUESTS - CTR_POST_SWAP, CTR_REQUESTS)))
        second_wall = time.perf_counter() - t0
        status = replica.status()
        unwarmed = replica.jit_cache_size()
        families = parse_prometheus(scrape_metrics(replica.url))
        swap_span = replica.tracer.find(name="model_swap")
    finally:
        replica.stop()
    require(not errors and status["errors"] == 0 and status["rejected"] == 0,
            f"CTR requests failed: {errors[:4]} {status}")
    require(status["completed"] == CTR_REQUESTS, f"CTR replica status: {status}")
    require(status["swaps"] == 1 and status["model_step"] == staged[2]["step"],
            f"the swap did not land: {status}")
    require(unwarmed == 0, f"{unwarmed} CTR dispatch shapes were not warmed")
    missing = [f for f in REQUIRED_FAMILIES if f not in families]
    require(not missing, f"missing metric families: {missing}")
    got = np.asarray(answers)
    post = np.asarray([sent[i] > swapped for i in range(CTR_REQUESTS)])
    # each answer is version 1's or version 2's: the nearer, within tolerance
    by2 = np.abs(got - want[2]) < np.abs(got - want[1])
    ok = np.where(by2, close(got, 2), close(got, 1))
    require(bool(ok.all()), f"CTR answers off both versions' predict at rows "
                            f"{np.flatnonzero(~ok)[:8].tolist()}")
    require(bool((by2 & close(got, 2))[post].all()),
            "CTR answers after the swap are not version 2's")
    err = {v: float(np.max(np.abs(got[sel] - want[v][sel]))) if sel.any() else None
           for v, sel in ((1, ~by2), (2, by2))}
    row = {"requests": CTR_REQUESTS, "http_requests": len(range(0, CTR_REQUESTS, CTR_HTTP_EVERY)),
           "buckets": list(CTR_SERVE_BUCKETS), "clients": CTR_CLIENTS, "start_s": start_s,
           "versions_apart_share": apart,
           "export_s": staged["export_s"], "publish_s": publish_s[0],
           "versions": [staged[1]["step"], staged[2]["step"]],
           "answered_by": {"1": int((~by2).sum()), "2": int(by2.sum()),
                           "after_swap": int(post.sum())},
           "max_abs_err": err, "tolerance": {"abs": TOL_CTR_SERVE_ABS, "rel": TOL_CTR_SERVE_REL},
           "swap_s": swap_span[0].seconds if swap_span else None,
           "latency_s": _quantiles([x for x in latency]),
           "requests_per_s": CTR_REQUESTS / (first_wall + second_wall),
           "bucket_hits": status["bucket_hits"], "failed": len(errors),
           "unwarmed_shapes": unwarmed,
           "peak_memory_gib": torch.cuda.max_memory_allocated(device) / 2**30}
    print(f"serve CTR: {CTR_REQUESTS} requests ({row['http_requests']} over HTTP), 0 failed, "
          f"{row['requests_per_s']:.1f} requests/s, latency p50 {row['latency_s']['p50'] * 1e3:.3f} "
          f"ms p99 {row['latency_s']['p99'] * 1e3:.3f} ms; swap to step {staged[2]['step']} in "
          f"{row['swap_s']} s, answered by version 1 / 2: {row['answered_by']}; max abs err "
          f"{err}; bucket hits {status['bucket_hits']}")
    return row


def phase_serve(device, lm: dict, ctr_staged: dict) -> dict:
    """The serving tier on the card: the LM tier, then the batch tier."""
    t0 = time.perf_counter()
    out = {"lm": serve_lm(device, lm)}
    t1 = time.perf_counter()
    out["ctr"] = serve_ctr(device, ctr_staged)
    out["seconds"] = {"lm": t1 - t0, "ctr": time.perf_counter() - t1}
    print(f"serve: LM tier {t1 - t0:.1f} s, CTR tier {out['seconds']['ctr']:.1f} s")
    return out


# -- dp: data parallelism and ZeRO-1 over torch.distributed ---------------------

#: phase dp's steps an arm: warm-up, then timed (the median is the step time)
DP_WARMUP = 2
DP_TIMED = 5
#: part (b): two ranks on the one card over gloo with CUDA tensors (found to
#: work in torch 2.11: all_reduce, all_gather_into_tensor and
#: reduce_scatter_tensor), at world 2 against part (a)'s one-device run at
#: the same global batch from the same weights. The MLP's and the LM's bf16
#: weight gradients are summed over each rank's half of the batch and
#: rounded to bf16 before the cross-rank sum, so the losses move off the
#: one-device run by bf16 rounding compounded over the steps: relative bound
DP_WORLD = 2
TOL_DP_LOSS = 2e-2
#: the CTR export of part (b) served on one device against the ranks' own
#: collective predict on the same rows (bf16 MLPs over 4096 against 8192
#: rows may take other cuBLAS tilings): relative norm bound of the logits
TOL_DP_PREDICT = 1e-2
#: data_plane() is printed for a mesh of this many ranks (analytic)
DP_PLANE_WORLD = 8
DP_RANK_TIMEOUT = 900
#: make_model kwargs of the dp phase's CTR (None: the published width,
#: ``ctr.MODEL``); its export's manifest names them
DP_CTR_CONFIG = None


def _dp_ctr():
    from edl_tpu_torch.models import ctr

    return ctr.make_model(**DP_CTR_CONFIG) if DP_CTR_CONFIG else ctr.MODEL


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_rows() -> dict:
    """name -> (model, TrainerConfig kwargs, global batch): the LM of phase 4
    and the CTR of phase 6."""
    from edl_tpu_torch.models.transformer import TransformerConfig, make_model

    return {
        "transformer": (make_model(TransformerConfig(flash=True, **SLICE)),
                        dict(optimizer="adam", learning_rate=3e-4, seed=0), BATCH),
        "ctr": (_dp_ctr(), dict(optimizer="adagrad", learning_rate=0.05, seed=0),
                CTR_BATCH),
    }


def _moments(trainer, state) -> dict:
    """{param name: {moment: tensor}} of ``state``'s optimizer, on the device."""
    opt = state.opt_state
    if trainer.mesh is None:
        pairs = list(state.params.named_parameters())
    else:
        pairs = [(leaf.name, leaf.opt_param)
                 for leaf in trainer.layout_for(state.params).leaves]
    return {name: {k: v for k, v in opt.state[p].items() if k != "step"}
            for name, p in pairs}


def dp_arm(label, model, config, host_batch, device, mesh=None, counts=None) -> dict:
    """One Trainer (on ``mesh`` or one device) from seed 0 on one placed
    batch: ``DP_WARMUP`` + ``DP_TIMED`` steps, host clock around each step
    and a synchronise; then one profiled step. ``counts`` (reset, read)
    brackets the timed steps. Returns its losses, times, peak memory above
    what was allocated before it, and its final params and moments copied
    to the host; its state is freed."""
    import torch

    from edl_tpu_torch.parallel.sharding import shard_batch
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(model, mesh=mesh, config=TrainerConfig(**config), device=device)
    state = trainer.init_state()
    local = host_batch if mesh is None else shard_batch(host_batch, mesh,
                                                        trainer.config.batch_axis)
    batch = trainer.place_batch(local)
    losses, times = [], []
    for i in range(DP_WARMUP + DP_TIMED):
        if counts is not None and i == DP_WARMUP:
            counts[0]()
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = counts[1]() if counts is not None else None
    peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
    step_ms = statistics.median(times[DP_WARMUP:]) * 1e3
    require(all(math.isfinite(x) for x in losses), f"dp {label}: non-finite loss {losses}")
    require(losses[-1] < losses[0], f"dp {label}: loss did not fall: {losses}")
    box = {"state": state}

    def step():
        box["state"], _ = trainer.train_step(box["state"], batch)
        torch.cuda.synchronize()

    _, summary = profile_step(step, step_ms, LM_GROUPS if model.name == "transformer"
                              else ZOO_GROUPS, f"dp {label}")
    state = box["state"]
    extra = {}
    if model.name == "ctr" and mesh is None:
        extra["deterministic"] = _embedding_backward_deterministic(
            state.params.deep_table, batch["sparse"].long())
    print(f"dp {label}: step {step_ms:.3f} ms (median of {DP_TIMED}), peak memory "
          f"{peak:.3f} GiB, losses {losses[0]:.6f} -> {losses[-1]:.6f}"
          + (f", flash launches {launches}" if launches else ""))
    host = lambda t: t.detach().to("cpu", copy=True)  # noqa: E731
    params = {n: host(p) for n, p in state.params.named_parameters()}
    moments = {n: {k: host(v) for k, v in m.items()}
               for n, m in _moments(trainer, state).items()}
    del trainer, state, batch, box
    torch.cuda.empty_cache()
    return dict(losses=losses, step_ms=step_ms, peak_memory_gib=peak, launches=launches,
                params=params, moments=moments,
                device_busy_share=summary.get("device_busy_share"),
                device_kernel_ms=summary.get("device_kernel_ms"), **extra)


def _same(a: dict, b: dict) -> list:
    """Names whose tensors differ (bit for bit) between two {name: tensor}."""
    import torch

    return [k for k in a if not torch.equal(a[k], b[k])]


def dp_world1(device) -> dict:
    """Part (a): the process group formed by the port's `distributed_init`
    against an `InProcessCoordinator`, NCCL at world 1; each row through
    the one-device Trainer and the mesh Trainer (``shard_opt_state``) in
    both grad_sync modes, from the same weights on the same batch: losses,
    params and moments bit for bit. Returns the rows' figures, the flash
    launches of the mesh arms' timed steps, and data_plane() at world 8."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.coordinator import InProcessCoordinator
    from edl_tpu_torch.launcher.launch import LaunchContext
    from edl_tpu_torch.parallel.mesh import Mesh, MeshSpec, build_mesh
    from edl_tpu_torch.runtime import Trainer, TrainerConfig
    from edl_tpu_torch.runtime.distributed import distributed_init

    fa = _flash_module()
    coord = InProcessCoordinator(heartbeat_ttl_sec=600)
    ident = distributed_init(LaunchContext(num_trainers=1), coord.client("chip-smoke"),
                             backend="nccl", host="127.0.0.1", port=_free_port(),
                             timeout=300)
    require(ident is not None and dist.get_backend() == "nccl"
            and dist.get_world_size() == 1, f"dp: no NCCL process group ({ident})")
    print(f"dp: process group up through distributed_init: {dist.get_backend()}, rank "
          f"{ident.process_id} of {ident.num_processes} via {ident.init_method}")
    out = {"process_group": {"backend": dist.get_backend(), "world": 1,
                             "init_method": ident.init_method}, "rows": {}}
    launches = dict.fromkeys(fa.LAUNCHES, 0)
    try:
        mesh = build_mesh(MeshSpec({"data": 1}))
        for name, (model, cfg, batch) in dp_rows().items():
            host = model.synthetic_batch(np.random.default_rng(0), batch)
            arms = {"one_device": dp_arm(f"{name} one-device", model, cfg, host, device)}
            for sync in ("psum", "reduce_scatter"):
                counts = None
                if name == "transformer":
                    def read():
                        got = dict(fa.LAUNCHES)
                        for k, n in got.items():
                            launches[k] += n
                        return got
                    counts = (fa.reset_launches, read)
                arms[sync] = dp_arm(f"{name} mesh {sync}", model,
                                    dict(cfg, shard_opt_state=True, grad_sync=sync),
                                    host, device, mesh=mesh, counts=counts)
                if counts is not None:
                    want = model.config.n_layers * DP_TIMED
                    require(all(n == want for n in arms[sync]["launches"].values()),
                            f"dp {name} {sync}: flash launches {arms[sync]['launches']}, "
                            f"want {want} each")
            ref = arms["one_device"]
            deterministic = ref.get("deterministic", True)
            row = {"deterministic_embedding_backward": deterministic, "arms": {}}
            for arm, r in arms.items():
                row["arms"][arm] = {k: r[k] for k in ("losses", "step_ms", "peak_memory_gib",
                                                      "device_busy_share", "device_kernel_ms",
                                                      "launches")}
                if arm == "one_device":
                    continue
                if deterministic:
                    require(r["losses"] == ref["losses"],
                            f"dp {name} {arm}: losses {r['losses']} != one-device {ref['losses']}")
                    bad = _same(r["params"], ref["params"])
                    require(not bad, f"dp {name} {arm}: params differ from one-device: {bad[:5]}")
                    bad = [p for p in r["moments"] if _same(r["moments"][p], ref["moments"][p])]
                    require(not bad, f"dp {name} {arm}: moments differ: {bad[:5]}")
                    held = "bit for bit"
                else:
                    err = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref["losses"]))
                    require(err <= TOL_NONDETERMINISTIC,
                            f"dp {name} {arm}: losses off one-device by {err:.3e}")
                    held = f"losses within {err:.2e} (embedding backward nondeterministic)"
                row["arms"][arm]["held"] = held
                row["arms"][arm]["overhead_vs_one_device"] = r["step_ms"] / ref["step_ms"] - 1
                print(f"dp {name} {arm} at world 1 against one device: {held}; step "
                      f"{r['step_ms']:.3f} against {ref['step_ms']:.3f} ms "
                      f"({r['step_ms'] / ref['step_ms'] - 1:+.1%}), peak "
                      f"{r['peak_memory_gib']:.3f} against {ref['peak_memory_gib']:.3f} GiB")
            # analytic: the module's data plane on a mesh of 8 ranks
            module = model.build(device="cpu", generator=torch.Generator().manual_seed(0))
            plane = Trainer(model, mesh=Mesh(["data"], [DP_PLANE_WORLD], 0, DP_PLANE_WORLD),
                            config=TrainerConfig(**cfg, shard_opt_state=True),
                            device="cpu").data_plane(module)
            row["data_plane_world8_analytic"] = {k: plane[k] for k in (
                "grad_sync", "sharded_bytes", "replicated_bytes", "grad_bytes_per_step",
                "param_bytes_per_step", "bytes_per_step", "collective_seconds", "n_buckets")}
            print(f"dp {name}: data_plane() at world {DP_PLANE_WORLD} (analytic, not "
                  f"measured; seconds from data-sheet NVLink rates): "
                  + json.dumps(row["data_plane_world8_analytic"]))
            out["rows"][name] = row
            del arms, ref, module
    finally:
        dist.destroy_process_group()
    out["launches"] = launches
    return out


def dp_rank_main(job_path: str, rank: int) -> int:
    """Part (b), one rank: ``python3 chip_smoke.py --dp-rank R JOB``. Both
    rows at world 2 on the one card over gloo with CUDA tensors, in both
    grad_sync modes; CTR's export and a checkpoint round trip. Writes its
    figures to ``JOB.rank<R>.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from edl_tpu_torch.parallel.sharding import shard_batch
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    with open(job_path) as f:
        job = json.load(f)
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=job["init"], world_size=DP_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_RANK_TIMEOUT))
    out = {"rows": {}}
    fa = _flash_module()
    try:
        mesh = build_mesh(MeshSpec({"data": DP_WORLD}))
        for name, (model, cfg, batch) in dp_rows().items():
            host = model.synthetic_batch(np.random.default_rng(0), batch)
            row, params = {}, {}
            for sync in ("psum", "reduce_scatter"):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
                trainer = Trainer(model, mesh=mesh, config=TrainerConfig(
                    **cfg, shard_opt_state=True, grad_sync=sync), device=device)
                state = trainer.init_state()
                placed = trainer.place_batch(shard_batch(host, mesh))
                fa.reset_launches()
                losses, times = [], []
                for _ in range(DP_WARMUP + DP_TIMED):
                    t0 = time.perf_counter()
                    state, loss = trainer.train_step(state, placed)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    losses.append(float(loss))
                moments = _moments(trainer, state)
                row[sync] = {"losses": losses, "launches": dict(fa.LAUNCHES),
                             "step_ms": statistics.median(times[DP_WARMUP:]) * 1e3,
                             "peak_memory_gib": (torch.cuda.max_memory_allocated(device)
                                                 - base) / 2**30,
                             # the optimizer's moments this rank holds, and
                             # what it would hold whole (counted, not timed)
                             "moment_bytes": sum(t.numel() * t.element_size()
                                                 for m in moments.values()
                                                 for t in m.values()),
                             "moment_bytes_whole": sum(
                                 len(m) * math.prod(leaf.full_shape(mesh))
                                 * leaf.param.element_size()
                                 for leaf, m in zip(trainer.layout_for(state.params).leaves,
                                                    moments.values())),
                             "local_rows": {n: int(p.shape[0]) for n, p in
                                            state.params.named_parameters()
                                            if n in trainer.param_spec()}}
                del moments
                params[sync] = {n: p.detach().clone() for n, p in
                                state.params.named_parameters()}
                if name == "ctr" and sync == "reduce_scatter":
                    row["export"] = dp_export(trainer, state, job, mesh)
                    row["checkpoint"] = dp_checkpoint(trainer, state, job, model, cfg, sync,
                                                      device)
                del trainer, state, placed
                torch.cuda.empty_cache()
            diff = max((params["psum"][n] - params["reduce_scatter"][n]).abs().max().item()
                       for n in params["psum"])
            row["psum_vs_reduce_scatter_max_abs"] = diff
            out["rows"][name] = row
            del params
            torch.cuda.empty_cache()
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def dp_export(trainer, state, job, mesh) -> dict:
    """CTR exported from both ranks (rank 0 writes), and the ranks' own
    collective predict on the export batch's rows (rank 0 keeps them)."""
    import numpy as np
    import torch

    from edl_tpu_torch.parallel.collective import gather_dim
    from edl_tpu_torch.parallel.sharding import shard_batch
    from edl_tpu_torch.runtime import save_inference_model

    t0 = time.perf_counter()
    save_inference_model(job["export_dir"], "ctr", state, config=DP_CTR_CONFIG,
                         step=int(state.step), mesh=mesh)
    seconds = time.perf_counter() - t0
    host = _dp_ctr().synthetic_batch(np.random.default_rng(9), CTR_BATCH)
    local = trainer.place_batch(shard_batch(host, mesh))
    with torch.no_grad():
        logits = state.params.predict(local)
    whole = gather_dim(logits.contiguous(), mesh.group("data")).cpu()
    if mesh.rank == 0:
        torch.save(whole, job["export_dir"] + ".logits.pt")
    return {"seconds": seconds}


def dp_checkpoint(trainer, state, job, model, cfg, sync, device) -> dict:
    """Save at world 2 (gathered, rank 0 writes), restore into a fresh
    mesh Trainer: every rank's params and moments bit for bit."""
    import torch.distributed as dist

    from edl_tpu_torch.runtime import Trainer, TrainerConfig
    from edl_tpu_torch.runtime.checkpoint import Checkpointer

    ck = Checkpointer(job["ckpt_dir"], trainer=trainer)
    t0 = time.perf_counter()
    ck.save(int(state.step), state)
    save_s = time.perf_counter() - t0
    ck.wait()
    dist.barrier()
    fresh = Trainer(model, mesh=trainer.mesh, config=TrainerConfig(
        **cfg, shard_opt_state=True, grad_sync=sync), device=device)
    t0 = time.perf_counter()
    restored = Checkpointer(job["ckpt_dir"], trainer=fresh).restore(fresh.init_state())
    restore_s = time.perf_counter() - t0
    params = dict(state.params.named_parameters())
    bad = _same(params, dict(restored.params.named_parameters()))
    mine, theirs = _moments(trainer, state), _moments(fresh, restored)
    bad += [p for p in mine if _same(mine[p], theirs[p])]
    require(not bad and restored.step == state.step,
            f"dp checkpoint at world 2: restore differs in {bad[:5]}")
    return {"save_s": save_s, "restore_s": restore_s, "bit_for_bit": True}


def dp_world2(device, world1: dict) -> dict:
    """Part (b): two ranks on the one card over gloo (`dp_rank_main`, one
    process a rank); each rank's failure fails the run. Their losses
    against part (a)'s one-device losses, the two modes' params against
    each other (tolerance 0: each sum is of two terms), the export served
    on one device against the ranks' predict."""
    import os

    import numpy as np
    import torch

    from edl_tpu_torch.runtime import load_inference_model

    with tempfile.TemporaryDirectory(prefix="edl-dp-") as root:
        job = os.path.join(root, "job.json")
        with open(job, "w") as f:
            json.dump({"init": f"file://{root}/rendezvous", "device": str(device),
                       "export_dir": os.path.join(root, "export"),
                       "ckpt_dir": os.path.join(root, "ckpt")}, f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--dp-rank", str(r), job])
                 for r in range(DP_WORLD)]
        try:
            codes = [p.wait(timeout=DP_RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        seconds = time.perf_counter() - t0
        require(codes == [0] * DP_WORLD, f"dp world 2: ranks exited {codes}")
        ranks = []
        for r in range(DP_WORLD):
            with open(f"{job}.rank{r}.json") as f:
                ranks.append(json.load(f))
        served = load_inference_model(os.path.join(root, "export"), device=device)
        host = _dp_ctr().synthetic_batch(np.random.default_rng(9), CTR_BATCH)
        want = torch.load(os.path.join(root, "export.logits.pt"))
        got = served.predict({k: v for k, v in host.items() if k != "label"}).float().cpu()
        predict_err = ((got - want).norm() / want.norm()).item()
    out = {"seconds": seconds, "rows": {}}
    for name, row in ranks[0]["rows"].items():
        one = world1["rows"][name]["arms"]["one_device"]["losses"]
        for r, rank in enumerate(ranks):
            for sync in ("psum", "reduce_scatter"):
                require(rank["rows"][name][sync]["losses"] == row[sync]["losses"],
                        f"dp world 2 {name} {sync}: rank {r}'s losses differ from rank 0's")
        errs = {sync: max(abs(a - b) / abs(b) for a, b in zip(row[sync]["losses"], one))
                for sync in ("psum", "reduce_scatter")}
        for sync, err in errs.items():
            require(err <= TOL_DP_LOSS, f"dp world 2 {name} {sync}: losses off the one-device "
                                        f"run by {err:.3e} (bound {TOL_DP_LOSS})")
        diff = max(rank["rows"][name]["psum_vs_reduce_scatter_max_abs"] for rank in ranks)
        require(diff == 0.0, f"dp world 2 {name}: psum and reduce_scatter params differ "
                             f"by {diff:.3e}")
        out["rows"][name] = {"loss_rel_err_vs_one_device": errs,
                             "psum_vs_reduce_scatter_max_abs": diff,
                             **{k: v for k, v in row.items()
                                if k not in ("psum_vs_reduce_scatter_max_abs",)}}
        print(f"dp world 2 {name} (gloo, two ranks on one card): step "
              f"{row['psum']['step_ms']:.3f} ms psum, {row['reduce_scatter']['step_ms']:.3f} ms "
              f"reduce_scatter; losses off one device by {errs['psum']:.2e} / "
              f"{errs['reduce_scatter']:.2e}; modes' params max diff {diff}; "
              f"local rows {row['psum']['local_rows']}; a rank's peak memory "
              f"{row['psum']['peak_memory_gib']:.3f} / "
              f"{row['reduce_scatter']['peak_memory_gib']:.3f} GiB; its moments "
              f"{row['psum']['moment_bytes'] / 2**20:.1f} MiB of "
              f"{row['psum']['moment_bytes_whole'] / 2**20:.1f} MiB whole (ZeRO-1)")
    require(predict_err <= TOL_DP_PREDICT,
            f"dp world 2: the export served on one device is off the ranks' predict by "
            f"{predict_err:.3e}")
    ctr_row = out["rows"]["ctr"]
    ctr_row["export"]["served_vs_ranks_predict_rel"] = predict_err
    print(f"dp world 2: CTR export written by rank 0 in {ctr_row['export']['seconds']:.3f} s, "
          f"served on one device within {predict_err:.2e} of the ranks' predict; checkpoint "
          f"save {ctr_row['checkpoint']['save_s']:.3f} s, restore "
          f"{ctr_row['checkpoint']['restore_s']:.3f} s, bit for bit; {seconds:.1f} s in all")
    return out


def phase_dp(device) -> dict:
    """The dp phase: part (a) NCCL at world 1, part (b) two gloo ranks."""
    world1 = dp_world1(device)
    world2 = dp_world2(device, world1)
    return {"world1": world1, "world2": world2, "launches": world1["launches"]}


# -- the elastic phase ----------------------------------------------------------

#: part (a): each row's queue (shards x batches of the row's batch), the
#: checkpoint interval, and the steps after which the second member
#: registers ("join") and leaves ("leave")
EL_CTR_SHARDS, EL_CTR_BATCHES = 6, 8
EL_LM_SHARDS, EL_LM_BATCHES = 3, 4
EL_CKPT_INTERVAL = 5
EL_CTR_SCRIPT = {10: "join", 30: "leave"}
EL_LM_SCRIPT = {6: "join"}
#: part (b): the queue (shards x batches of each rank's 4096 rows: the
#: global batch of 8192 at world 2), the checkpoint interval (a round: one
#: shard's batches on each rank), the watcher's poll period and the
#: deadline of the part
EL_MH_SHARDS, EL_MH_BATCHES, EL_MH_BATCH = 16, 4, CTR_BATCH // 2
EL_MH_POLL_S = 0.02
EL_MH_TIMEOUT = 420
#: extra arguments of part (b)'s entry (none on the card)
EL_MH_ENTRY_ARGS = ""


class Membership:
    """A membership script run from ``step_callback``: at the steps of
    ``script`` a second member registers (and a thread follows the
    rendezvous, as a trainer would) or leaves. Deterministic: it reacts to
    steps, not to the wall clock."""

    def __init__(self, coord, script: dict):
        import threading

        self.coord, self.script = coord, dict(script)
        self.stop = threading.Event()
        self.thread = self.client = None

    def _follow(self, epoch):
        while not self.stop.is_set():
            reply = self.client.sync(epoch, timeout=5.0)
            if reply.get("ok"):
                break
            epoch = reply.get("epoch", epoch)
        while not self.stop.is_set():
            hb = self.client.heartbeat()
            if hb.get("ok") and hb["epoch"] != epoch:
                epoch = hb["epoch"]
                self.client.sync(epoch, timeout=5.0)
            time.sleep(0.02)

    def __call__(self, step, state):
        import threading

        action = self.script.pop(step, None)
        if action == "join":
            self.client = self.coord.client("trainer-1")
            info = self.client.register()
            self.thread = threading.Thread(target=self._follow, args=(info["epoch"],),
                                           daemon=True)
            self.thread.start()
        elif action == "leave":
            self.close()
            self.client.leave()

    def close(self):
        self.stop.set()
        if self.thread is not None:
            self.thread.join(timeout=60)


def _full_diff(got: dict, want: dict) -> list:
    """The tensors of two `Trainer.full_state` dicts that differ (bit for
    bit), by name."""
    import torch

    bad = [] if got["step"] == want["step"] else ["step"]
    bad += [k for k, v in want["module"].items() if not torch.equal(got["module"][k], v)]
    for i, per in want["optimizer"]["state"].items():
        bad += [f"optimizer {i} {k}" for k, v in per.items()
                if not torch.equal(got["optimizer"]["state"][i][k], v)]
    return bad


def _rates(marks, rescales, batch: int) -> list:
    """samples/s of each world's run of steps (its first step, which pays
    the recovery, left out): ``marks`` are (perf_counter, step) at each
    step's callback, cut at each rescale's first step."""
    cuts = [r.at_step for r in rescales]
    segments, cur = [], []
    for t, step in marks:
        if cuts and step == cuts[0] and cur:
            segments.append(cur)
            cur = []
            cuts.pop(0)
        cur.append(t)
    segments.append(cur)
    return [(len(s) - 2) * batch / (s[-1] - s[1]) if len(s) > 2 else None for s in segments]


def elastic_row(label, model, trainer_kw, batch, shards, per_shard, script, device,
                counts=None, layout_planner=None) -> dict:
    """Part (a) for one row: an `ElasticWorker` on the card against an
    `InProcessCoordinator` under the membership ``script``; holds the
    rescales, their phases, the queue, the losses and each restore against
    its barrier's save; with ``layout_planner``, every ``replan`` span must
    carry its plan (``planned``), whose modeled step time is printed beside
    the measured one; returns the row's figures."""
    import os

    import numpy as np
    import torch

    from edl_tpu_torch.coordinator import InProcessCoordinator
    from edl_tpu_torch.obs.tracing import RESCALE_PHASES, Tracer, rescale_timeline
    from edl_tpu_torch.runtime import (ElasticConfig, ElasticWorker, SyntheticShardSource,
                                       TrainerConfig)
    from edl_tpu_torch.runtime.data import shard_names

    coord = InProcessCoordinator(task_lease_sec=600.0, heartbeat_ttl_sec=600.0)
    admin = coord.client("admin")
    admin.add_tasks(shard_names(f"elastic-{label}", shards))
    members = Membership(coord, script)
    marks = []

    def on_step(step, state):
        marks.append((time.perf_counter(), step))  # the worker synced on the loss
        members(step, state)

    tracer = Tracer()
    with tempfile.TemporaryDirectory(prefix=f"edl-elastic-{label}-") as root:
        cfg = ElasticConfig(checkpoint_dir=root, checkpoint_interval=EL_CKPT_INTERVAL,
                            heartbeat_interval=0.0, rescale_barrier_timeout=120.0,
                            step_callback=on_step, trainer=TrainerConfig(**trainer_kw))
        worker = ElasticWorker(model, coord.client("trainer-0"),
                               SyntheticShardSource(model, batch, per_shard), cfg,
                               device=device, tracer=tracer, layout_planner=layout_planner)
        # the state each blocking save wrote (the latest), and each restore
        # held against it bit for bit, params and moments
        saved, restores = {}, []
        save, restore = worker._checkpoint, worker._restore_or_init

        def checkpoint(state, block=False):
            save(state, block=block)
            if block:
                saved.clear()
                saved[int(state.step)] = worker._trainer.full_state(state)

        def restore_held(trainer, fresh):
            state = restore(trainer, fresh)
            step = int(state.step)
            if worker._last_restore["source"] != "init":
                want = saved.get(step)
                require(want is not None, f"elastic {label}: restored step {step}, saved "
                                          f"{sorted(saved)}")
                bad = _full_diff(trainer.full_state(state), want)
                require(not bad, f"elastic {label}: restored state off the barrier's save: "
                                 f"{bad[:5]}")
                restores.append({"step": step, "source": worker._last_restore["source"],
                                 "checkpoint_bytes": os.path.getsize(
                                     os.path.join(root, str(step), "state.pt"))})
            return state

        worker._checkpoint, worker._restore_or_init = checkpoint, restore_held
        if counts is not None:
            counts[0]()
        t0 = time.perf_counter()
        try:
            metrics = worker.run()
        finally:
            members.close()
        seconds = time.perf_counter() - t0
        launches = counts[1]() if counts is not None else None
        ckpt_bytes = os.path.getsize(os.path.join(root, str(worker.ckpt.latest_step()),
                                                  "state.pt"))
    st = admin.status()
    require((st["done"], st["queued"], st["leased"]) == (shards, 0, 0),
            f"elastic {label}: queue done/queued/leased {st['done']}/{st['queued']}/"
            f"{st['leased']}, want {shards}/0/0")
    losses = np.asarray(worker.losses)
    require(bool(np.isfinite(losses).all()), f"elastic {label}: non-finite loss")
    require(losses[-per_shard:].mean() < losses[0],
            f"elastic {label}: loss did not fall: the first {losses[0]:.4f}, the last "
            f"shard's {losses[-per_shard:]}")
    joins = sum(1 for a in script.values() if a == "join")
    leaves = sum(1 for a in script.values() if a == "leave")
    want = [(1, 2)] * joins + [(2, 1)] * leaves
    got = [(r.from_world, r.to_world) for r in worker.rescales]
    require(got == want, f"elastic {label}: rescales {got}, want {want}")
    require(len(restores) == len(want), f"elastic {label}: {len(restores)} restores held "
                                         f"for {len(want)} rescales")
    timeline = rescale_timeline(tracer.spans)
    ids = [tid for tid, t in timeline.items() if "drain" in t["phases"]]
    require(len(ids) == len(want), f"elastic {label}: rescale traces {ids}")
    rates = _rates(marks, worker.rescales, batch)
    events = []
    for i, (r, tid) in enumerate(zip(worker.rescales, sorted(ids))):
        phases = timeline[tid]["phases"]
        missing = [p for p in RESCALE_PHASES if p not in phases]
        require(not missing, f"elastic {label} {tid}: phases missing: {missing}")
        events.append({
            "trace_id": tid, "at_step": r.at_step, "from_world": r.from_world,
            "to_world": r.to_world, "recovery_seconds": r.recovery_seconds,
            "compile_seconds": r.compile_seconds, "layout": r.layout,
            "phase_seconds": {p: phases[p]["seconds"] for p in RESCALE_PHASES},
            "wall_seconds": timeline[tid]["wall_seconds"],
            "restore_source": restores[i]["source"],
            "checkpoint_bytes": restores[i]["checkpoint_bytes"],
            "samples_per_s_before": rates[i], "samples_per_s_after": rates[i + 1]})
        print(f"elastic {label}: rescale {r.from_world} -> {r.to_world} at step "
              f"{r.at_step}: recovery {r.recovery_seconds:.3f} s (warm-up "
              f"{r.compile_seconds:.3f} s beside it), restored bit for bit from a "
              f"{restores[i]['checkpoint_bytes'] / 2**20:.1f} MiB checkpoint; phases "
              + ", ".join(f"{p} {phases[p]['seconds']:.3f}" for p in RESCALE_PHASES)
              + f" s; samples/s {rates[i] or 0:.0f} before, {rates[i + 1] or 0:.0f} after")
    row = {"label": label, "batch": batch, "shards": shards, "batches_a_shard": per_shard,
           "steps": worker.steps_done, "seconds": seconds, "rescales": events,
           "losses_first_last": [float(losses[0]), float(losses[-1])],
           "checkpoint_bytes": ckpt_bytes, "metric_keys": sorted(metrics),
           "max_recovery_seconds": metrics["max_recovery_seconds"]}
    if launches is not None:
        row["launches"] = launches
    if layout_planner is not None:
        row["plan"] = elastic_plan_vs_measured(label, tracer, marks, worker.rescales)
    print(f"elastic {label}: {worker.steps_done} steps over {shards} shards (every "
          f"shard done, none queued or leased) in {seconds:.1f} s; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoint {ckpt_bytes / 2**20:.1f} MiB")
    return row


def lm_profile(cfg, batch: int):
    """The LM's `ModelProfile` for the planner: its real param bytes (a
    build on the ``meta`` device: every leaf, f32, ZeRO-shardable), Adam's
    two f32 moments a param byte, its analytic FLOPs a sample and one
    microbatch's bf16 stage-boundary activation (the whole batch)."""
    from edl_tpu_torch.models.transformer import make_model
    from edl_tpu_torch.parallel import ModelProfile

    model = make_model(cfg)
    module = model.build(device="meta")
    return ModelProfile(
        param_bytes=float(sum(p.numel() * p.element_size() for p in module.parameters())),
        n_layers=cfg.n_layers, flops_per_sample=float(model.flops_per_step(1)),
        activation_bytes_per_microbatch=float(batch * cfg.seq_len * cfg.d_model * 2))


def elastic_plan_vs_measured(label, tracer, marks, rescales) -> dict:
    """Every ``replan`` span of the row must carry its plan; returns the
    plan's modeled step time beside the measured one (the median interval
    between step callbacks, the steps after a rescale left out)."""
    spans = tracer.find(name="replan")
    require(spans and all(sp.attrs.get("planned") is True for sp in spans),
            f"elastic {label}: replan spans without a plan: {[sp.attrs for sp in spans]}")
    first = {r.at_step for r in rescales}
    gaps = [b - a for (a, _), (b, step) in zip(marks, marks[1:]) if step not in first]
    out = {"layouts": [json.loads(sp.attrs["layout"]) for sp in spans],
           "modeled_step_ms": [sp.attrs["modeled_step_seconds"] * 1e3 for sp in spans],
           "baseline_step_ms": [sp.attrs["baseline_step_seconds"] * 1e3 for sp in spans],
           "measured_step_ms": statistics.median(gaps) * 1e3}
    print(f"elastic {label}: the planner's layouts {out['layouts']}, modeled step "
          + " / ".join(f"{ms:.3f}" for ms in out["modeled_step_ms"])
          + f" ms against {out['measured_step_ms']:.3f} ms measured (median step, "
          "checkpoints included)")
    return out


def elastic_rows(device) -> dict:
    """Part (a): CTR at its published width (a join after step 10, a leave
    after step 30) and the GPT-2-small-width LM (a join after step 6),
    each through the `ElasticWorker` on the card. The LM row counts the
    flash kernels' launches: 12 a forward (the steps' and each rescale's
    warm-up forward) and 12 of each backward kernel a step. Its layout comes
    from the planner (`plan_layout` over one card of H100 defaults and the
    LM's `lm_profile`) at every rescale."""
    import torch

    from edl_tpu_torch.models.transformer import TransformerConfig, make_model

    fa = _flash_module()
    out = {"ctr": elastic_row("ctr", _dp_ctr(),
                              dict(optimizer="adagrad", learning_rate=0.05), CTR_BATCH,
                              EL_CTR_SHARDS, EL_CTR_BATCHES, EL_CTR_SCRIPT, device)}
    torch.cuda.empty_cache()
    from edl_tpu_torch.parallel import Topology, plan_layout

    cfg = TransformerConfig(flash=True, **SLICE)
    profile = lm_profile(cfg, BATCH)
    lm = elastic_row("lm", make_model(cfg), dict(optimizer="adam", learning_rate=3e-4),
                     BATCH, EL_LM_SHARDS, EL_LM_BATCHES, EL_LM_SCRIPT, device,
                     counts=(fa.reset_launches, lambda: dict(fa.LAUNCHES)),
                     layout_planner=lambda n, devices: plan_layout(
                         n, Topology(slices=(1,)), profile, BATCH, schedules=()))
    warm = sum(1 for r in lm["rescales"] if r["compile_seconds"] > 0)
    require(lm["plan"]["layouts"] and all(l == {"data": 1} for l in lm["plan"]["layouts"]),
            f"elastic lm: planned layouts {lm['plan']['layouts']} on one card")
    want = {"fwd": cfg.n_layers * (lm["steps"] + warm), "bwd_dq": cfg.n_layers * lm["steps"],
            "bwd_dkv": cfg.n_layers * lm["steps"]}
    require(lm["launches"] == want, f"elastic lm: flash launches {lm['launches']}, want "
                                    f"{want} ({lm['steps']} steps, {warm} warm-up forwards)")
    out["lm"] = lm
    torch.cuda.empty_cache()
    return out


class CheckpointWatch:
    """Part (b)'s observer, on a thread: the coordinator's epoch, queue,
    rank 0's process-group address (published once an incarnation has
    started and settled its rank) and round plans (each epoch's first plan:
    its incarnation's first round, which its first step follows at once)
    with their wall times, and every
    checkpoint step rank 0 writes, hard-linked as it lands (the
    Checkpointer prunes all but the newest three)."""

    def __init__(self, client, ckpt_dir: str, snap_dir: str):
        import threading

        self.client, self.ckpt_dir, self.snap_dir = client, ckpt_dir, snap_dir
        self.epochs = {}      # epoch -> first seen (time.time())
        self.addresses = {}   # epoch -> rank 0's process-group address first seen
        self.rounds = {}      # (epoch, round) -> first seen
        self.snapshots = {}   # step -> path of its state.pt's link
        self.status = {}
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import os

        from edl_tpu_torch.runtime.distributed import PG_ADDRESS_KEY

        while not self.stop.is_set():
            now = time.time()
            st = self.client.status()
            self.status = st
            epoch = int(st["epoch"])
            self.epochs.setdefault(epoch, now)
            for e in list(self.epochs):
                if e not in self.addresses and self.client.kv_get(f"{PG_ADDRESS_KEY}/{e}"):
                    self.addresses[e] = now
                # the next plans not seen yet (rank 0 deletes a plan once a
                # later round's collective proves every rank read it)
                r = 1 + max((rr for (ee, rr) in self.rounds if ee == e), default=-1)
                for k in range(r, r + 3):
                    if self.client.kv_get(f"edl/mh_round/{e}/{k}"):
                        self.rounds[(e, k)] = now
            if os.path.isdir(self.ckpt_dir):
                for name in os.listdir(self.ckpt_dir):
                    src = os.path.join(self.ckpt_dir, name, "state.pt")
                    if name.isdigit() and int(name) not in self.snapshots:
                        dst = os.path.join(self.snap_dir, f"{name}.pt")
                        try:
                            os.link(src, dst)
                        except FileNotFoundError:
                            continue  # pruned or not complete yet
                        self.snapshots[int(name)] = dst
            time.sleep(EL_MH_POLL_S)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)


def _log_time(text: str, marker: str):
    """The wall time (time.time()) of the launcher's log line holding
    ``marker``: the logging module's ``asctime`` in local time."""
    import datetime

    for line in text.splitlines():
        if marker in line:
            stamp = " ".join(line.split()[:2])
            return datetime.datetime.strptime(stamp, "%Y-%m-%d %H:%M:%S,%f").timestamp()
    return None


def churn_two_launchers(label: str, entry: str, prefix: str, n: int, per: int,
                        inspect=None) -> tuple:
    """Two launchers (``python -m edl_tpu_torch.launcher start_trainer``)
    running ``entry`` as two ranks on the one card against the native
    ``CoordinatorServer`` (built with ``make``), over the queue of ``n``
    shards named ``prefix`` of ``per`` batches, a checkpoint a round; once
    a collective checkpoint covers a round, SIGTERM to rank 1's launcher.
    Rank 1 leaves at a round boundary and exits 0, rank 0 exits 75 once,
    is relaunched at world 1, restores the world-2 checkpoint and drains
    the queue. Holds: both launchers exit 0, one exit-75 relaunch, the
    final world 1, every shard done, and every shard trained exactly once
    into the final state (the world-1 incarnation trains exactly the shards
    its restored checkpoint lacks). ``inspect(snapshot_path)``, if given,
    is called with the restored checkpoint's hard link while it exists.
    Returns (the part's figures, the world-1 incarnation's JSON line)."""
    import os
    import signal

    from edl_tpu_torch.coordinator import CoordinatorServer
    from edl_tpu_torch.runtime.data import shard_names

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="edl-churn-") as root:
        ckpt, snap = os.path.join(root, "ckpt"), os.path.join(root, "snap")
        os.makedirs(snap)
        procs = {}
        with CoordinatorServer(task_lease_sec=600.0, heartbeat_ttl_sec=60.0) as server:
            admin = server.client("admin")
            admin.add_tasks(shard_names(prefix, n))
            admin.kv_put("edl/expected_world", "2")
            watch = CheckpointWatch(server.client("chip-smoke-watch"), ckpt, snap)

            def launch(name):
                env = {**os.environ, "PYTHONPATH": repo,
                       "EDL_COORDINATOR_ENDPOINT": server.address,
                       "EDL_PORT": str(server.port), "EDL_NUM_TRAINERS": "2",
                       "EDL_ENTRY": entry, "EDL_POD_NAME": name, "EDL_JOB_NAME": "chip-smoke",
                       "EDL_CHECKPOINT_DIR": ckpt, "EDL_CHECKPOINT_INTERVAL": str(per),
                       "EDL_TERMINATION_LOG": os.path.join(root, f"term-{name}")}
                files = [open(os.path.join(root, f"{name}.{k}"), "w") for k in ("out", "err")]
                procs[name] = (time.time(), subprocess.Popen(
                    [sys.executable, "-m", "edl_tpu_torch.launcher", "start_trainer"],
                    env=env, cwd=repo, stdout=files[0], stderr=files[1],
                    start_new_session=True))

            deadline = time.monotonic() + EL_MH_TIMEOUT

            def until(cond, what):
                while not cond():
                    require(time.monotonic() < deadline, f"{label}: {what}")
                    require(all(p.poll() is None for _, p in procs.values()),
                            f"{label}: a launcher exited early ({what})")
                    time.sleep(EL_MH_POLL_S)

            try:
                launch("w0")
                until(lambda: len(admin.members()) >= 1, "w0 never registered")
                launch("w1")  # registers second: rank 1
                until(lambda: int(watch.status.get("done", 0)) >= 2,
                      "no collective checkpoint covered a round")
                admin.kv_put("edl/expected_world", "1")
                t_term = time.time()
                procs["w1"][1].send_signal(signal.SIGTERM)
                for name in ("w1", "w0"):
                    p = procs[name][1]
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                st = admin.status()
            finally:
                watch.close()
                for _, p in procs.values():
                    if p.poll() is None:  # the launcher and the entry it runs
                        os.killpg(p.pid, signal.SIGKILL)
                        p.wait()
        logs = {name: {k: open(os.path.join(root, f"{name}.{k}")).read()
                       for k in ("out", "err")} for name in procs}
        codes = {name: p.returncode for name, (_, p) in procs.items()}
        require(codes == {"w0": 0, "w1": 0},
                f"{label}: launchers exited {codes}:\n"
                + "\n".join(f"{k}: {v['err'][-3000:]}" for k, v in logs.items()))
        marker = "entry requested rescale restart (exit 75)"
        restarts = {name: log["err"].count(marker) for name, log in logs.items()}
        require(restarts == {"w0": 1, "w1": 0},
                f"{label}: exit-75 relaunches {restarts}, want w0 once")
        final = json.loads([line for line in logs["w0"]["out"].splitlines()
                            if line.startswith("{")][-1])
        require(final["world"] == 1.0, f"{label}: final world {final['world']}")
        require((st["done"], st["queued"], st["leased"]) == (n, 0, 0),
                f"{label}: queue done/queued/leased {st['done']}/{st['queued']}/"
                f"{st['leased']}")
        last = max(int(s) for s in os.listdir(ckpt) if s.isdigit())
        steps1 = int(final["steps"])
        restored = last - steps1
        require(restored in watch.snapshots and restored > 0 and restored % per == 0,
                f"{label}: restored step {restored} (final {last}, world-1 steps "
                f"{steps1}); snapshots {sorted(watch.snapshots)}")
        covered = 2 * restored // per  # two shards a round at world 2
        require(steps1 == (n - covered) * per,
                f"{label}: the world-1 incarnation trained {steps1} steps, want "
                f"{(n - covered) * per}: the {n - covered} shards the step-{restored} "
                "checkpoint lacks")
        if inspect is not None:
            inspect(watch.snapshots[restored])

    epochs = sorted(watch.epochs.items())
    moved = [(e, t) for e, t in epochs if t >= t_term]
    require(moved, f"{label}: no epoch move after the SIGTERM")
    e_after, t_move = moved[0]
    first_round = {e: t for (e, r), t in watch.rounds.items() if r == 0}
    e_before = max(e for e, t in epochs if t < t_term)
    relaunch = _log_time(logs["w0"]["err"], "restart=1")
    rounds = sorted(t for (e, r), t in watch.rounds.items() if e == e_before)
    out = {
        "shards": n, "batches_a_shard": per,
        "launcher_codes": codes, "exit_75_relaunches": restarts,
        "restored_step": restored, "shards_covered": covered,
        "world1_steps": steps1, "world1_step_ms": final["seconds"] / steps1 * 1e3,
        "recovery_s": first_round[e_after] - t_move,
        "startup_s": {"world2": first_round[e_before] - procs["w1"][0],
                      "world1": first_round[e_after] - relaunch},
        # start-up split at rank 0's published process-group address: the
        # interpreter, imports and rendezvous before it; the group, the
        # model, the restore and the first plan after it
        "to_group_address_s": {"world2": watch.addresses[e_before] - procs["w1"][0],
                               "world1": watch.addresses[e_after] - relaunch},
        "world2_round_s": statistics.median(b - a for a, b in zip(rounds, rounds[1:])),
    }
    print(f"{label}: two ranks (one card, --dist-backend auto) trained "
          f"{covered} shards by step {restored}; SIGTERM to rank 1; rank 0 exited 75 once "
          f"and came back at world 1: recovery {out['recovery_s']:.2f} s (epoch move -> the "
          f"world-1 incarnation's first round, its first step right after); start-up "
          f"{out['startup_s']['world2']:.2f} s (world 2, rank 1's launcher -> first round; "
          f"{out['to_group_address_s']['world2']:.2f} s of it to the group's address) "
          f"and {out['startup_s']['world1']:.2f} s (relaunch -> first round; "
          f"{out['to_group_address_s']['world1']:.2f} s to the address); a world-2 "
          f"round ({per} steps and a checkpoint) {out['world2_round_s']:.2f} s; world 1 "
          f"{out['world1_step_ms']:.1f} ms a step (checkpoints included) over {steps1} "
          f"steps; every shard done, each trained once into the final state, only the "
          f"{n - covered} uncommitted replayed")
    return out, final


def elastic_multihost(device) -> dict:
    """Part (b): the CTR entry under two launchers (`MultiHostWorker`, two
    ranks on the one card over gloo, tables 500096 rows a rank,
    ``shard_opt_state``), the native coordinator, a SIGTERM to rank 1's
    launcher once a collective checkpoint covers a round: rank 1 leaves,
    rank 0 exits 75, its launcher relaunches it, and it forms a world-1
    group (NCCL), restores the world-2 checkpoint and drains the queue
    (`churn_two_launchers`). The restored checkpoint also restores into a
    world-1 Trainer in this process bit for bit."""
    import torch

    from edl_tpu_torch.models import ctr
    from edl_tpu_torch.parallel.mesh import local_mesh
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    per = EL_MH_BATCHES
    sparse = (DP_CTR_CONFIG or {}).get("sparse_dim", ctr.SPARSE_DIM)
    entry = (f"{sys.executable} -m edl_tpu_torch.examples.ctr.train --dist-backend auto "
             f"--zero1 --batch-size {EL_MH_BATCH} --batches-per-shard {per} "
             f"--sparse-feature-dim {sparse} {EL_MH_ENTRY_ARGS}").strip()

    def world1_restore(snapshot):
        # the world-1 restore of the world-2 checkpoint, through the same
        # code as the relaunched rank's (`load_full_state` on a world-1 mesh)
        saved = torch.load(snapshot, map_location="cpu", weights_only=True)
        trainer = Trainer(_dp_ctr(), local_mesh(), TrainerConfig(optimizer="adagrad",
                                                                learning_rate=0.05),
                          device=device)
        state = trainer.load_full_state(trainer.init_state(), saved)
        bad = _full_diff(trainer.full_state(state), saved)
        require(not bad, f"elastic multihost: world-1 restore off the world-2 checkpoint: "
                         f"{bad[:5]}")
        del state, trainer
        torch.cuda.empty_cache()

    out, _ = churn_two_launchers("elastic multihost", entry, "criteo", EL_MH_SHARDS, per,
                                 inspect=world1_restore)
    out["batch_a_rank"] = EL_MH_BATCH
    print("elastic multihost: the world-1 restore equals the world-2 checkpoint bit for bit")
    return out


#: part (c): the LM entry's layout and queue (shards x batches of 8: a
#: world-4 round is two shards, a checkpoint a round), its learning rate,
#: the deadline of the part, and extra entry arguments (none on the card)
EL_MP_AXES = {"pipe": 2}
EL_MP_LAYOUT = dict(pipeline_schedule="1f1b-interleaved", virtual_stages=2,
                    microbatches=4)
EL_MP_SHARDS, EL_MP_BATCHES, EL_MP_WORLD = 8, 2, 4
EL_MP_LR = 3e-4
EL_MP_TIMEOUT = 600
EL_MP_ENTRY_ARGS = ""
#: extra arguments of the checkpoint plane's smoke (none on the card)
EL_PLANE_ARGS = ()


def el_mp_entry_main(argv) -> int:
    """One rank of part (c): ``chip_smoke.py --el-mp-entry RECORD_DIR --
    ARGS`` runs the LM entry (`edl_tpu_torch.examples.lm.train.main(ARGS)`)
    with each mesh step's flash launches, loss and time recorded, and its
    restore held against the checkpoint it read (on rank 0, after the
    collective gather of the restored state); at exit it writes this
    incarnation's record to ``RECORD_DIR/<pid>.json``."""
    import os

    import torch

    from edl_tpu_torch.examples.lm import train as lm_train
    from edl_tpu_torch.runtime import train_loop
    from edl_tpu_torch.runtime.multihost import MultiHostWorker

    record_dir, args = argv[0], argv[argv.index("--") + 1:]
    fa = _flash_module()
    rec = {"pid": os.getpid(), "started": time.time(), "steps": []}
    mesh_step = train_loop.Trainer._mesh_step

    def counted(self, state, batch):
        fa.reset_launches()
        t0 = time.perf_counter()
        new, loss = mesh_step(self, state, batch)
        value = float(loss)  # synchronises on the step's work
        rec["steps"].append({"launches": dict(fa.LAUNCHES), "loss": value,
                             "ms": (time.perf_counter() - t0) * 1e3, "t": time.time()})
        return new, loss

    restore = MultiHostWorker._restore_or_init

    def held(self, trainer):
        state = restore(self, trainer)
        full = trainer.full_state(state)  # collective
        mesh = trainer.mesh
        rec.update(rank=mesh.rank, world=mesh.world, mesh=dict(mesh.shape),
                   restored_step=int(state.step))
        if mesh.rank == 0 and int(state.step) > 0:
            saved = torch.load(os.path.join(self.ckpt.directory, str(int(state.step)),
                                            "state.pt"), map_location="cpu",
                               weights_only=True)
            rec["restore_diff"] = _full_diff(full, saved)
        return state

    train_loop.Trainer._mesh_step = counted
    MultiHostWorker._restore_or_init = held
    code = 0
    try:
        lm_train.main(args)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        rec["exit"] = code
        if torch.cuda.is_available():
            rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(record_dir, f"{os.getpid()}.json"), "w") as f:
            json.dump(rec, f)
    return code


def elastic_mp(device) -> dict:
    """Part (c): the LM entry at its full width (``RANKS_LM_LAYERS`` deep)
    under four launchers
    against the native coordinator, ``--axes {"pipe": 2}`` interleaved
    (v 2, 4 microbatches) with ZeRO-1: four ranks share the card over gloo
    as ``{"data": 2, "pipe": 2}``, a checkpoint a round. Once a checkpoint
    covers a round, both launchers of data index 1 get SIGTERM (a world of
    3 is not divisible by pipe 2): they leave and exit 0; ranks 0 and 1
    exit 75 once, are relaunched at world 2 as ``{"data": 1, "pipe": 2}``,
    restore the world-4 checkpoint (the ZeRO-1 moments regrouped from two
    data shards to one) and drain the queue."""
    import os
    import signal

    import torch

    from edl_tpu_torch.coordinator import CoordinatorServer
    from edl_tpu_torch.models.transformer import make_model
    from edl_tpu_torch.runtime import Trainer, TrainerConfig
    from edl_tpu_torch.runtime.data import shard_names

    repo = os.path.dirname(os.path.abspath(__file__))
    n, per, world = EL_MP_SHARDS, EL_MP_BATCHES, EL_MP_WORLD
    cfg = _mp_config({**EL_MP_LAYOUT, "n_layers": RANKS_LM_LAYERS})
    want = mp_expected_launches(EL_MP_AXES, cfg)
    args = (f"--vocab-size {SLICE['vocab_size']} --d-model {SLICE['d_model']} "
            f"--n-layers {RANKS_LM_LAYERS} --n-heads {SLICE['n_heads']} "
            f"--d-ff {SLICE['d_ff']} --seq-len {SLICE['seq_len']} --batch-size {BATCH} "
            f"--batches-per-shard {per} --learning-rate {EL_MP_LR} "
            f"--pipeline-schedule {EL_MP_LAYOUT['pipeline_schedule']} "
            f"--virtual-stages {EL_MP_LAYOUT['virtual_stages']} "
            f"--microbatches {EL_MP_LAYOUT['microbatches']} --zero1 --dist-backend auto "
            f"{EL_MP_ENTRY_ARGS}").strip()
    with tempfile.TemporaryDirectory(prefix="edl-elastic-mp-") as root:
        ckpt, snap, records = (os.path.join(root, d) for d in ("ckpt", "snap", "records"))
        os.makedirs(snap)
        os.makedirs(records)
        entry = (f"{sys.executable} {os.path.abspath(__file__)} --el-mp-entry {records} -- "
                 f"{args}")
        procs = {}
        with CoordinatorServer(task_lease_sec=600.0, heartbeat_ttl_sec=60.0) as server:
            admin = server.client("admin")
            admin.add_tasks(shard_names("lm", n))
            admin.kv_put("edl/expected_world", str(world))
            watch = CheckpointWatch(server.client("chip-smoke-watch"), ckpt, snap)

            def launch(name):
                env = {**os.environ, "PYTHONPATH": repo,
                       "EDL_COORDINATOR_ENDPOINT": server.address,
                       "EDL_PORT": str(server.port), "EDL_NUM_TRAINERS": str(world),
                       "EDL_ENTRY": entry, "EDL_POD_NAME": name, "EDL_JOB_NAME": "chip-smoke",
                       "EDL_MESH_AXES": json.dumps(EL_MP_AXES),
                       "EDL_CHECKPOINT_DIR": ckpt, "EDL_CHECKPOINT_INTERVAL": str(per),
                       "EDL_TERMINATION_LOG": os.path.join(root, f"term-{name}")}
                files = [open(os.path.join(root, f"{name}.{k}"), "w") for k in ("out", "err")]
                procs[name] = (time.time(), subprocess.Popen(
                    [sys.executable, "-m", "edl_tpu_torch.launcher", "start_trainer"],
                    env=env, cwd=repo, stdout=files[0], stderr=files[1],
                    start_new_session=True))

            deadline = time.monotonic() + EL_MP_TIMEOUT

            def until(cond, what):
                while not cond():
                    require(time.monotonic() < deadline, f"elastic mp: {what}")
                    require(all(p.poll() is None for _, p in procs.values()),
                            f"elastic mp: a launcher exited early ({what})")
                    time.sleep(EL_MH_POLL_S)

            try:
                for i in range(world):
                    launch(f"w{i}")
                until(lambda: any(r == 0 for _, r in watch.rounds),
                      "the world-4 group never published a round")
                ranks = admin.members()  # in rank order
                until(lambda: int(watch.status.get("done", 0)) >= 2,
                      "no collective checkpoint covered a round")
                admin.kv_put("edl/expected_world", str(world // 2))
                t_term = time.time()
                leavers = ranks[2:]  # data index 1 of {"data": 2, "pipe": 2}
                for name in leavers:
                    procs[name][1].send_signal(signal.SIGTERM)
                for name in (*leavers, *ranks[:2]):
                    p = procs[name][1]
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
                st = admin.status()
            finally:
                watch.close()
                for _, p in procs.values():
                    if p.poll() is None:  # the launcher and the entry it runs
                        os.killpg(p.pid, signal.SIGKILL)
                        p.wait()
        logs = {name: {k: open(os.path.join(root, f"{name}.{k}")).read()
                       for k in ("out", "err")} for name in procs}
        codes = {name: p.returncode for name, (_, p) in procs.items()}
        require(all(c == 0 for c in codes.values()),
                f"elastic mp: launchers exited {codes}:\n"
                + "\n".join(f"{k}: {v['err'][-3000:]}" for k, v in logs.items()))
        marker = "entry requested rescale restart (exit 75)"
        restarts = {name: log["err"].count(marker) for name, log in logs.items()}
        require(restarts == {name: int(name in ranks[:2]) for name in ranks},
                f"elastic mp: exit-75 relaunches {restarts}, want {ranks[:2]} once each")
        require((st["done"], st["queued"], st["leased"]) == (n, 0, 0),
                f"elastic mp: queue done/queued/leased {st['done']}/{st['queued']}/"
                f"{st['leased']}")
        recs = [json.load(open(os.path.join(records, f))) for f in os.listdir(records)]
        by_world = {}
        for rec in recs:
            by_world.setdefault(rec.get("world", -1), []).append(rec)
        require(sorted(by_world) == [world // 2, world]
                and len(by_world[world]) == world and len(by_world[world // 2]) == world // 2,
                f"elastic mp: incarnations {[(r.get('world'), r.get('rank')) for r in recs]}")
        meshes = {w: [r["mesh"] for r in rs] for w, rs in by_world.items()}
        require(all(m == {"data": w // 2, "pipe": 2} for w, ms in meshes.items() for m in ms),
                f"elastic mp: meshes {meshes}")
        for w, rs in by_world.items():
            rs.sort(key=lambda r: r["rank"])
            losses = [[s["loss"] for s in r["steps"]] for r in rs]
            require(all(x == losses[0] for x in losses), f"elastic mp: world {w} ranks' "
                                                         f"losses differ: {losses}")
            require(all(math.isfinite(x) for x in losses[0]), f"elastic mp: {losses[0]}")
            for r in rs:
                bad = [s["launches"] for s in r["steps"] if s["launches"] != want]
                require(not bad, f"elastic mp: world {w} rank {r['rank']} flash launches "
                                 f"{bad[:3]}, want {want} each step")
        w4, w2 = by_world[world], by_world[world // 2]
        restored = w2[0]["restored_step"]
        require(w2[0].get("restore_diff") == [] and restored in watch.snapshots
                and restored > 0 and restored % per == 0,
                f"elastic mp: the world-2 restore of step {restored}: "
                f"{w2[0].get('restore_diff')}; snapshots {sorted(watch.snapshots)}")
        covered = 2 * restored // per  # two shards a world-4 round
        steps2 = len(w2[0]["steps"])
        require(steps2 == (n - covered) * per,
                f"elastic mp: the world-2 incarnation trained {steps2} steps, want "
                f"{(n - covered) * per}: the {n - covered} shards the step-{restored} "
                "checkpoint lacks")
        all_losses = [s["loss"] for s in w4[0]["steps"][:restored]] + \
            [s["loss"] for s in w2[0]["steps"]]
        require(statistics.mean(all_losses[-per:]) < all_losses[0],
                f"elastic mp: loss did not fall: {all_losses}")
        # the world-4 checkpoint into one device: the re-cut across pipe
        saved = torch.load(watch.snapshots[restored], map_location="cpu", weights_only=True)
        one_cfg = _mp_config({"n_layers": RANKS_LM_LAYERS})
        trainer = Trainer(make_model(one_cfg), config=TrainerConfig(
            optimizer="adam", learning_rate=EL_MP_LR), device=device)
        state = trainer.load_full_state(trainer.init_state(), saved)
        bad = _full_diff(trainer.full_state(state), saved)
        require(not bad, f"elastic mp: one-device restore off the world-4 checkpoint: "
                         f"{bad[:5]}")
        del state, trainer, saved
        torch.cuda.empty_cache()

    epochs = sorted(watch.epochs.items())
    moved = [(e, t) for e, t in epochs if t >= t_term]
    require(moved, "elastic mp: no epoch move after the SIGTERM")
    first_round = {e: t for (e, r), t in watch.rounds.items() if r == 0}
    e_after = max(first_round)
    e_before = min(first_round)
    relaunch = _log_time(logs[ranks[0]]["err"], "restart=1")
    rounds = sorted(t for (e, r), t in watch.rounds.items() if e == e_before)
    launched = max(t for t, _ in procs.values())
    out = {
        "axes": EL_MP_AXES, "layout": EL_MP_LAYOUT, "shards": n, "batches_a_shard": per,
        "batch_a_data_index": BATCH, "launcher_codes": codes,
        "exit_75_relaunches": restarts, "restored_step": restored,
        "shards_covered": covered, "world2_steps": steps2,
        "flash_launches_per_step_and_rank": want,
        "recovery_s": first_round[e_after] - moved[0][1],
        "startup_s": {"world4": first_round[e_before] - launched,
                      "world2": first_round[e_after] - relaunch},
        "world4_round_s": statistics.median(b - a for a, b in zip(rounds, rounds[1:])),
        "world4_step_ms": statistics.median(s["ms"] for s in w4[0]["steps"][1:]),
        "world2_step_ms": statistics.median(s["ms"] for s in w2[0]["steps"][1:]),
        "peak_memory_gib": {f"world{w}": [r.get("peak_memory_gib") for r in rs]
                            for w, rs in by_world.items()},
        "launches": {k: sum(s["launches"][k] for r in (w4[0], w2[0]) for s in r["steps"])
                     for k in want},
    }
    print(f"elastic mp: the LM entry at full width, {RANKS_LM_LAYERS} layers, {EL_MP_AXES} "
          f"interleaved (v 2, M 4), "
          f"ZeRO-1, four ranks on one card over gloo as {meshes[world][0]}; SIGTERM to data "
          f"index 1 ({', '.join(ranks[2:])}) after {covered} shards by step {restored}; "
          f"ranks 0 and 1 exited 75 once and came back as {meshes[world // 2][0]}: recovery "
          f"{out['recovery_s']:.2f} s (epoch move -> the world-2 incarnation's first round); "
          f"start-up {out['startup_s']['world4']:.2f} s (world 4, the last launcher -> first "
          f"round) and {out['startup_s']['world2']:.2f} s (relaunch -> first round); a "
          f"world-4 round ({per} steps and a checkpoint) {out['world4_round_s']:.2f} s, a "
          f"step {out['world4_step_ms']:.1f} ms; world 2 {out['world2_step_ms']:.1f} ms a "
          f"step over {steps2} steps; peak memory "
          + "; ".join(f"{k} " + " / ".join("not measured" if g is None else f"{g:.2f}"
                                           for g in v) + " GiB"
                      for k, v in out["peak_memory_gib"].items())
          + f"; flash launches {want} every step on every rank at both worlds; every shard "
          "done, only the uncommitted ones replayed; the world-4 checkpoint restored bit for "
          "bit into the world-2 {\"pipe\": 2} ranks and into one device")
    return out


def elastic_ckpt_plane() -> dict:
    """The checkpoint plane's smoke on the card (``python -m
    edl_tpu_torch.ckpt_plane``): the twin, the peer restore and the group
    death's blob fallback, the last two EXACTLY the twin's loss."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.ckpt_plane", *EL_PLANE_ARGS],
                         cwd=repo,
                         env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
                         text=True, timeout=300)
    require(out.returncode == 0, f"ckpt_plane smoke exited {out.returncode}: "
                                 f"{out.stderr[-3000:]}")
    report = json.loads(out.stdout[out.stdout.index("{"):])
    require(report["pass"] is True and report["peer"]["source"] == "peer"
            and report["peer"]["loss"] == report["blob_fallback"]["loss"]
            == report["twin_loss"], f"ckpt_plane smoke: {report}")
    report["seconds"] = time.perf_counter() - t0
    require(report["device"].startswith("cuda"), f"ckpt_plane smoke ran on {report['device']}")
    print(f"elastic ckpt_plane ({report['device']}): twin {report['twin_loss']!r}, peer restore "
          f"{report['peer']['loss']!r} ({report['peer']['bytes']} bytes from the plane), "
          f"group death's blob fallback {report['blob_fallback']['loss']!r}: exact; "
          f"{report['seconds']:.1f} s")
    return report


def phase_elastic(device) -> dict:
    """The elastic phase: part (a) the `ElasticWorker` rows on the card,
    part (b) the `MultiHostWorker` through the launcher, the checkpoint
    plane's smoke, part (c) the model-parallel LM through the launcher."""
    return elastic_record(elastic_local(device), elastic_mp(device))


def elastic_local(device) -> dict:
    """The elastic phase's parts (a) and (b) and the checkpoint plane's smoke."""
    return {"rows": elastic_rows(device), "multihost": elastic_multihost(device),
            "ckpt_plane": elastic_ckpt_plane()}


def elastic_record(local: dict, mp: dict) -> dict:
    """The elastic phase's record from `elastic_local`'s and part (c)'s."""
    launches = {k: local["rows"]["lm"]["launches"][k] + mp["launches"][k]
                for k in mp["launches"]}
    return {**local, "mp": mp, "launches": launches}


# -- mp: model parallelism of the LM on one card --------------------------------

#: the arms, each at the slice's width (at MP_LAYERS deep): (label, mesh axes,
#: config overrides).
#: Ranks share the one card, one process each, over gloo with CUDA tensors
#: (NCCL refuses two ranks on one GPU)
MP_M = 4
#: the arms' depth: the slice's width at 4 of its 12 layers (every layout
#: still splits it: two pipe stages of two virtual stages of one layer), to
#: keep the script inside its time limit
MP_LAYERS = 4
#: the MoE arm: phase 4's moe arm B (8 experts, capacity factor 1.25, top-2,
#: aux 0.01), its experts over two ranks, the tokens whole on both
MP_MOE = dict(MOE, moe_top_k=2, moe_aux_weight=0.01)
MP_ARMS = (
    ("a_seq2_flash_ring", {"seq": 2}, {}),
    ("b_model2", {"model": 2}, {}),
    ("c_pipe2_gpipe", {"pipe": 2}, dict(microbatches=MP_M)),
    ("d_pipe2_1f1b", {"pipe": 2}, dict(pipeline_schedule="1f1b", microbatches=MP_M)),
    ("e_pipe2_interleaved", {"pipe": 2}, dict(pipeline_schedule="1f1b-interleaved",
                                              virtual_stages=2, microbatches=MP_M)),
    ("f_expert2_top2", {"expert": 2}, MP_MOE),
    ("g_seq2_model2", {"seq": 2, "model": 2}, {}),
)
#: steps an arm: warm-up, then timed (the median is the step time)
MP_WARMUP, MP_TIMED = 1, 3
#: each arm's losses against the one-device Trainer's from the same seed-0
#: params on the same global batch: the ring merges f32 hop outputs where
#: one device's kernel rounds once, the TP psums add f32 partial products in
#: another order and cuBLAS tiles the narrower matmuls otherwise, so the
#: bf16 residual stream moves by rounding and Adam compounds it over the
#: steps. Measured on an H100: at most 2.23e-4 (arm f, MoE: capacity and aux
#: per device group) and 7.8e-5 in the dense arms; a tensor-parallel psum
#: left out after wo moves the losses by 1.7e-3 at the CPU tests' size
#: (PERF.md), so the bound sits between the two
TOL_MP_LOSS = 1e-3
#: each leaf's first-step gradient (this rank's part, after the Trainer's
#: reductions) against the one-device gradient's same part: relative norm
#: error, the depth-2 step parity's bound (TOL_STEP_GRAD: bf16 rounding at
#: other places through 12 layers)
TOL_MP_GRAD = 5e-2
MP_RANK_TIMEOUT = 900


#: the LM's depth where its entry runs under launchers on ranks that share
#: the card (the elastic phase's part (c), the controller, the chaos
#: phase): its full width at MP_LAYERS of its 12 layers, as the mp arms, so
#: that the whole script keeps inside its time limit; their checks follow
#: the depth (a step's flash launches are one of each kernel a layer)
RANKS_LM_LAYERS = MP_LAYERS


def _mp_config(overrides: dict):
    from edl_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(flash=True, **{**SLICE, **overrides})


def _mp_arm_config(overrides: dict):
    """An arm's config in the mp phase: the slice at ``MP_LAYERS`` deep."""
    return _mp_config({"n_layers": MP_LAYERS, **overrides})


def mp_expected_launches(axes: dict, cfg) -> dict:
    """Flash launches a step on each rank: every layer the rank holds runs
    each kernel once a hop (``seq`` hops) and a microbatch; the 1F1B
    schedules run each stage's forward twice (the F-phase and the
    B-phase's recompute); a ring hop's f32 dO runs each backward kernel
    twice (its bf16 part and the remainder, `_Flash.backward`)."""
    pp, sp = axes.get("pipe", 1), axes.get("seq", 1)
    per = cfg.n_layers // pp * sp * ((cfg.microbatches or pp) if pp > 1 else 1)
    twice = pp > 1 and cfg.pipeline_schedule in ("1f1b", "1f1b-interleaved")
    bwd = per * (2 if sp > 1 else 1)
    return {"fwd": per * (2 if twice else 1), "bwd_dq": bwd, "bwd_dkv": bwd}


def mp_references(device, root: str) -> dict:
    """The one-device Trainer from seed 0 on the global batch, for the dense
    LM and the MoE arm's: the losses of ``MP_WARMUP + MP_TIMED`` steps, and
    the first step's gradients saved to ``root`` for the ranks."""
    import os

    import numpy as np
    import torch

    from edl_tpu_torch.models.transformer import make_model
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    out = {}
    for kind, overrides in (("dense", {}), ("moe", MP_MOE)):
        model = make_model(_mp_arm_config(overrides))
        trainer = Trainer(model, config=TrainerConfig(optimizer="adam", learning_rate=3e-4,
                                                      seed=0), device=device)
        state = trainer.init_state()
        batch = trainer.place_batch(model.synthetic_batch(np.random.default_rng(0), BATCH))
        losses = []
        for i in range(MP_WARMUP + MP_TIMED):
            state, loss = trainer.train_step(state, batch)
            losses.append(float(loss))
            if i == 0:
                path = os.path.join(root, f"grads_{kind}.pt")
                torch.save({n: p.grad.detach().float().cpu()
                            for n, p in state.params.named_parameters()}, path)
        require(all(math.isfinite(x) for x in losses), f"mp reference {kind}: {losses}")
        out[kind] = {"losses": losses, "grads": path}
        print(f"mp reference ({kind}, one device): losses {losses}")
        del trainer, state, batch
        torch.cuda.empty_cache()
    return out


def mp_rank_main(job_path: str, rank: int) -> int:
    """One rank of the mp phase: ``python3 chip_smoke.py --mp-rank R JOB``.
    Each of the job's arms from seed 0 on the global batch (this rank's
    rows and sequence chunk): ``MP_WARMUP + MP_TIMED`` steps, each step's
    flash launches counted on this rank, the first step's gradients held
    against the one-device ones, then one profiled step (rank 0 records
    it). Writes its figures to ``JOB.rank<R>.json``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    from edl_tpu_torch.models.convert import _cut
    from edl_tpu_torch.models.transformer import make_model
    from edl_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from edl_tpu_torch.parallel.sharding import shard_batch
    from edl_tpu_torch.runtime import Trainer, TrainerConfig

    with open(job_path) as f:
        job = json.load(f)
    device = torch.device(job["device"])
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=job["init"], world_size=job["world"],
                            rank=rank, timeout=datetime.timedelta(seconds=MP_RANK_TIMEOUT))
    fa = _flash_module()
    arms = {name: (axes, kw) for name, axes, kw in MP_ARMS}
    out = {"arms": {}}
    try:
        for name in job["arms"]:
            axes, kw = arms[name]
            cfg = _mp_arm_config(kw)
            model = make_model(cfg)
            mesh = build_mesh(MeshSpec(dict(axes)))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            trainer = Trainer(model, mesh, TrainerConfig(optimizer="adam", learning_rate=3e-4,
                                                         seed=0), device=device)
            state = trainer.init_state()
            host = model.synthetic_batch(np.random.default_rng(0), BATCH)
            placed = trainer.place_batch(shard_batch(host, mesh, trainer.config.batch_axis,
                                                     specs=model.batch_spec(mesh)))
            ref = torch.load(job["grads"]["moe" if cfg.moe_experts else "dense"], mmap=True)
            losses, times, launches, grad_err = [], [], [], {}
            for i in range(MP_WARMUP + MP_TIMED):
                fa.reset_launches()
                t0 = time.perf_counter()
                state, loss = trainer.train_step(state, placed)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                launches.append(dict(fa.LAUNCHES))
                losses.append(float(loss))
                if i == 0:
                    for leaf in trainer.layout_for(state.params).leaves:
                        want = _cut(ref[leaf.name], leaf.shards, mesh, leaf.name).to(device)
                        g = leaf.opt_param.grad.float()
                        grad_err[leaf.name] = ((g - want).norm() / want.norm()).item()
                        del want
            step_ms = statistics.median(times[MP_WARMUP:]) * 1e3
            box = {"state": state}

            def step():
                box["state"], _ = trainer.train_step(box["state"], placed)
                torch.cuda.synchronize()

            summary = {}
            if rank == 0:
                _, summary = profile_step(step, step_ms, LM_GROUPS, f"mp {name} rank 0")
            else:
                step()
            plane = trainer.data_plane(box["state"])
            worst = max(grad_err, key=grad_err.get)
            out["arms"][name] = {
                "losses": losses, "step_ms": step_ms, "times_ms": [t * 1e3 for t in times],
                "launches": launches,
                "peak_memory_gib": (torch.cuda.max_memory_allocated(device) - base) / 2**30,
                "grad_rel_err_max": grad_err[worst], "grad_rel_err_worst_leaf": worst,
                "device_busy_share": summary.get("device_busy_share"),
                "device_kernel_ms": summary.get("device_kernel_ms"),
                "data_plane": {k: plane[k] for k in ("grad_sync", "replicated_bytes",
                                                     "sharded_bytes", "grad_bytes_per_step",
                                                     "bytes_per_step")},
                "stash": dict(box["state"].params.pipeline_stats)}
            del trainer, state, placed, box, ref
            torch.cuda.empty_cache()
            dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job_path}.rank{rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def mp_world(device, world: int, arms: list, refs: dict, root: str) -> list:
    """``world`` rank processes on the one card (`mp_rank_main`) running
    ``arms`` in order; any rank's failure fails the phase. Returns each
    rank's figures."""
    import os

    job = os.path.join(root, f"job{world}.json")
    with open(job, "w") as f:
        json.dump({"init": f"file://{root}/rendezvous{world}", "device": str(device),
                   "world": world, "arms": arms,
                   "grads": {k: r["grads"] for k, r in refs.items()}}, f)
    procs = [subprocess.Popen([sys.executable, __file__, "--mp-rank", str(r), job])
             for r in range(world)]
    try:
        codes = [p.wait(timeout=MP_RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(codes == [0] * world, f"mp world {world}: ranks exited {codes}")
    ranks = []
    for r in range(world):
        with open(f"{job}.rank{r}.json") as f:
            ranks.append(json.load(f))
    return ranks


def phase_mp(device) -> dict:
    """The mp phase: every arm of ``MP_ARMS`` (arms a-f on two ranks, g on
    four), each against the one-device references. Returns the arms'
    figures and rank 0's flash launches over the timed steps of all arms."""
    import os

    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="edl-mp-") as root:
        refs = mp_references(device, root)
        torch.cuda.empty_cache()
        by_world = {}
        for name, axes, _ in MP_ARMS:
            by_world.setdefault(math.prod(axes.values()), []).append(name)
        ranks = {world: mp_world(device, world, arms, refs, root)
                 for world, arms in by_world.items()}
        for world in ranks:
            for r in range(world):
                os.remove(os.path.join(root, f"job{world}.json.rank{r}.json"))
    out = {"arms": {}, "launches": {"fwd": 0, "bwd_dq": 0, "bwd_dkv": 0},
           "tolerance": {"loss_rel": TOL_MP_LOSS, "grad_rel_norm": TOL_MP_GRAD}}
    for name, axes, kw in MP_ARMS:
        world = math.prod(axes.values())
        rows = [rank["arms"][name] for rank in ranks[world]]
        cfg = _mp_arm_config(kw)
        ref = refs["moe" if cfg.moe_experts else "dense"]["losses"]
        want = mp_expected_launches(axes, cfg)
        for r, row in enumerate(rows):
            require(row["losses"] == rows[0]["losses"],
                    f"mp {name}: rank {r}'s losses {row['losses']} differ from rank 0's "
                    f"{rows[0]['losses']}")
            require(all(math.isfinite(x) for x in row["losses"]), f"mp {name}: {row['losses']}")
            for i, got in enumerate(row["launches"]):
                require(got == want, f"mp {name}: rank {r} step {i} flash launches {got}, "
                                     f"want {want}")
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(rows[0]["losses"], ref))
        grad_err = max(row["grad_rel_err_max"] for row in rows)
        require(loss_err <= TOL_MP_LOSS, f"mp {name}: losses off one device by "
                                         f"{loss_err:.3e} (bound {TOL_MP_LOSS})")
        require(grad_err <= TOL_MP_GRAD, f"mp {name}: first-step gradients off one device "
                                         f"by {grad_err:.3e} (bound {TOL_MP_GRAD})")
        for k in out["launches"]:
            out["launches"][k] += sum(step[k] for step in rows[0]["launches"][MP_WARMUP:])
        out["arms"][name] = {
            "axes": axes, "world": world, "config": kw, "losses": rows[0]["losses"],
            "loss_rel_err_vs_one_device": loss_err, "grad_rel_err_vs_one_device": grad_err,
            "grad_worst_leaf": max(rows, key=lambda x: x["grad_rel_err_max"])[
                "grad_rel_err_worst_leaf"],
            "step_ms": [row["step_ms"] for row in rows],
            "peak_memory_gib": [row["peak_memory_gib"] for row in rows],
            "device_busy_share_rank0": rows[0]["device_busy_share"],
            "device_kernel_ms_rank0": rows[0]["device_kernel_ms"],
            "flash_launches_per_step_and_rank": want,
            "data_plane_analytic": rows[0]["data_plane"],
            "stash": [row["stash"] for row in rows]}
        busy = rows[0]["device_busy_share"]
        print(f"mp {name} {axes} (world {world}, gloo on one card): step "
              + " / ".join(f"{row['step_ms']:.1f}" for row in rows) + " ms by rank; "
              f"losses {rows[0]['losses'][0]:.6f} -> {rows[0]['losses'][-1]:.6f}, off one "
              f"device by {loss_err:.2e}; first-step gradients off by {grad_err:.2e}; peak "
              + " / ".join(f"{row['peak_memory_gib']:.2f}" for row in rows) + " GiB; busy "
              + ("not measured" if busy is None else f"{busy:.1%}") + " (rank 0); flash "
              f"launches {want} a step and rank; data_plane() (analytic): "
              f"{rows[0]['data_plane']['bytes_per_step'] / 1e6:.1f} MB a step over the batch "
              f"axes, {rows[0]['data_plane']['replicated_bytes'] / 1e6:.1f} MB of "
              f"replicated params")
    out["seconds"] = time.perf_counter() - t0
    print(f"mp: {len(MP_ARMS)} arms in {out['seconds']:.1f} s")
    return out


# -- entries: the zoo's other entries, the profiler, the obs smoke -------------

#: part (a)'s bounds, the JAX package's example tests' own
#: (`tests/test_examples.py`): MNIST and ResNet (tiny) accuracy on the
#: held-out batch, word2vec's steps, steady profiled steps and final loss
#: (below the uniform log(2074))
EN_MNIST_ACCURACY = 0.9
EN_RESNET_ACCURACY = 0.2
EN_W2V = {"steps": 80.0, "profile_steady_steps": 79.0, "final_loss_below": 7.7}
#: ResNet-50 at 224 px, 1000 classes: batch 64 over the entry's 6 hermetic
#: shards of 4 batches
EN_IMAGENET_ARGS = ("--imagenet", "--batch-size", "64", "--batches-per-shard", "4")
#: part (b): word2vec's queue under churn (shards of the entry's 10 batches
#: of 512; 16 so that rounds remain when the SIGTERM lands)
EN_W2V_SHARDS, EN_W2V_BATCHES = 16, 10
#: part (c): `Trainer.run` steps under the `StepProfiler` (2 warm-up)
EN_PROFILER_STEPS, EN_PROFILER_WARMUP = 22, 2
EN_TIMEOUT = 600
#: extra arguments of every entry this phase runs (none on the card: an
#: entry trains on the card by default)
EN_ENTRY_ARGS = ""


def entry_record_main(argv) -> int:
    """``chip_smoke.py --entry-record PATH MODULE -- ARGS`` runs the entry
    ``edl_tpu_torch.examples.MODULE``'s ``main(ARGS)`` with
    ``ElasticWorker.run`` wrapped to write the worker's per-step losses to
    ``PATH`` as it returns (the entry prints only the last)."""
    import importlib

    from edl_tpu_torch.runtime import elastic

    path, module, args = argv[0], argv[1], argv[argv.index("--") + 1:]
    run = elastic.ElasticWorker.run

    def recorded(self, *a, **kw):
        metrics = run(self, *a, **kw)
        with open(path, "w") as f:
            json.dump({"losses": [float(x) for x in self.losses]}, f)
        return metrics

    elastic.ElasticWorker.run = recorded
    importlib.import_module(f"edl_tpu_torch.examples.{module}").main(args)
    return 0


def profiler_on_card(run, device) -> dict:
    """Part (c), on phase 4's LM after its timed and profiled steps: one
    step under `tools.profiler.trace`, whose written trace must name the
    three flash kernels; `device_memory_stats()` against
    ``torch.cuda.max_memory_allocated``; then `Trainer.run` over
    ``EN_PROFILER_STEPS`` steps with a `StepProfiler`, whose host-clock
    step time p50 and MFU (against 989 TFLOP/s) are printed beside the
    synchronised step of `Run.timed`."""
    import os

    import torch

    from edl_tpu_torch.tools.profiler import StepProfiler, device_memory_stats, trace

    with tempfile.TemporaryDirectory(prefix="edl-trace-") as logdir:
        with trace(logdir):
            run.step()
        files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
        require(len(files) == 1, f"profiler: trace() wrote {os.listdir(logdir)}, want one "
                                 "*.pt.trace.json")
        with open(os.path.join(logdir, files[0])) as f:
            text = f.read()
    named = {k: text.count(k) for k in FLASH_NAMES}
    require(all(named.values()), f"profiler: the written trace names the flash kernels "
                                 f"{named} times")
    torch.cuda.synchronize()
    stats = device_memory_stats()
    peak = torch.cuda.max_memory_allocated(device)
    card = str(device.index or 0)
    require(list(stats) == [card], f"profiler: device_memory_stats() reports {list(stats)}, "
                                   f"want this process's card {card} only")
    require(stats[card]["peak_bytes_in_use"] == peak
            and stats[card]["bytes_in_use"] == torch.cuda.memory_allocated(device)
            and stats[card]["bytes_limit"]
            == torch.cuda.get_device_properties(device).total_memory,
            f"profiler: device_memory_stats() {stats[card]} against max_memory_allocated {peak}")
    prof = StepProfiler(warmup=EN_PROFILER_WARMUP)
    run.state, metrics = run.trainer.run(
        run.state, (run.host_batch for _ in range(EN_PROFILER_STEPS)), profiler=prof)
    summary = prof.summary()
    require(summary["steady_steps"] >= 20 and math.isfinite(metrics["final_loss"]),
            f"profiler: {summary}, {metrics}")
    out = {"trace_bytes": len(text), "trace_names": named, "memory_stats": stats[card],
           "max_memory_allocated": peak, "summary": summary,
           "run_samples_per_sec": metrics["samples_per_sec"],
           "timed_step_ms": run.row["step_ms"],
           "host_step_p50_ms": summary["step_time_p50_s"] * 1e3, "mfu": summary.get("mfu")}
    print(f"profiler: trace() wrote {len(text)} bytes naming the flash kernels {named} "
          f"times; device_memory_stats() peak {peak} bytes = max_memory_allocated, limit "
          f"{stats[card]['bytes_limit']}; StepProfiler over {EN_PROFILER_STEPS} Trainer.run "
          f"steps ({summary['steady_steps']:.0f} steady): host step p50 "
          f"{out['host_step_p50_ms']:.3f} ms, mean {summary['step_time_mean_s'] * 1e3:.3f} ms, "
          "MFU " + (f"{out['mfu']:.4f} of 989 TFLOP/s" if out["mfu"] is not None
                    else "not measured (no peak for this card)")
          + f", against Run.timed's synchronised step {run.row['step_ms']:.3f} "
          f"ms; Trainer.run's samples/s after its final sync {metrics['samples_per_sec']:.1f}")
    return out


def _entry_cmd(module: str, *args, record=None) -> list:
    if record is not None:
        return [sys.executable, __file__, "--entry-record", record, module, "--", *args,
                *EN_ENTRY_ARGS.split()]
    return [sys.executable, "-m", f"edl_tpu_torch.examples.{module}", *args,
            *EN_ENTRY_ARGS.split()]


def _run_entries(jobs: dict, root: str) -> dict:
    """Run each of ``jobs`` ({label: command}) as a subprocess in local
    mode, all at once, each with its own checkpoint directory; returns
    {label: (the last JSON line, every JSON line, wall seconds)}. An entry
    that fails fails the phase."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = repo
    procs = {}
    for label, cmd in jobs.items():
        files = [open(os.path.join(root, f"{label}.{k}"), "w") for k in ("out", "err")]
        procs[label] = (time.perf_counter(), subprocess.Popen(
            cmd, cwd=repo, stdout=files[0], stderr=files[1],
            env={**env, "EDL_CHECKPOINT_DIR": os.path.join(root, f"ck-{label}")}))
    out, ended = {}, {}
    deadline = time.perf_counter() + EN_TIMEOUT
    try:
        while len(ended) < len(procs):
            require(time.perf_counter() < deadline,
                    f"entries: {sorted(set(procs) - set(ended))} still running after "
                    f"{EN_TIMEOUT} s")
            for label, (t0, p) in procs.items():
                if label not in ended and p.poll() is not None:
                    ended[label] = time.perf_counter() - t0
            time.sleep(0.05)
        for label, (_, p) in procs.items():
            seconds = ended[label]
            text = open(os.path.join(root, f"{label}.out")).read()
            err = open(os.path.join(root, f"{label}.err")).read()
            require(p.returncode == 0, f"entries: {label} exited {p.returncode}:\n{err[-3000:]}")
            lines = [json.loads(line) for line in text.splitlines() if line.startswith("{")]
            require(lines, f"entries: {label} printed no JSON line:\n{text[-2000:]}")
            out[label] = (lines[-1], lines, seconds)
    finally:
        for _, p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def entries_local() -> dict:
    """Part (a): each entry as a subprocess in local mode on the card, in
    two waves (the ``infer`` runs read the ``train`` runs' checkpoints):
    fit_a_line ``train_local`` and ``train_elastic`` at their defaults,
    MNIST ``train`` then ``infer`` (accuracy above 0.9), ResNet tiny
    ``train`` then ``infer`` (above 0.2), ResNet-50 ``--imagenet`` at batch
    64 over 6 shards of 4 batches (finite per-step losses, the last
    shard's mean below the first's), word2vec ``train_ft`` (80 steps, 79
    steady profiled steps, final loss below 7.7)."""
    import os

    with tempfile.TemporaryDirectory(prefix="edl-entries-") as root:
        mnist_dir, resnet_dir = os.path.join(root, "mnist"), os.path.join(root, "resnet")
        losses = os.path.join(root, "imagenet-losses.json")
        train = _run_entries({
            "fit_a_line_local": _entry_cmd("fit_a_line.train_local"),
            "fit_a_line_elastic": _entry_cmd("fit_a_line.train_elastic"),
            "mnist_train": _entry_cmd("mnist.train", "train", "--model-dir", mnist_dir),
            "resnet_train": _entry_cmd("resnet.train", "train", "--model-dir", resnet_dir),
            "resnet_imagenet": _entry_cmd("resnet.train", "train", *EN_IMAGENET_ARGS,
                                          "--model-dir", os.path.join(root, "imagenet"),
                                          record=losses),
            "word2vec": _entry_cmd("word2vec.train_ft"),
        }, root)
        infer = _run_entries({
            "mnist_infer": _entry_cmd("mnist.train", "infer", "--model-dir", mnist_dir),
            "resnet_infer": _entry_cmd("resnet.train", "infer", "--model-dir", resnet_dir),
        }, root)
        with open(losses) as f:
            imagenet_losses = json.load(f)["losses"]
    got = {k: v[0] for k, v in {**train, **infer}.items()}
    seconds = {k: v[2] for k, v in {**train, **infer}.items()}
    passes = train["fit_a_line_local"][1]
    require(len(passes) == 10 and all(p["steps"] == 50.0 and math.isfinite(p["final_loss"])
                                      for p in passes)
            and passes[-1]["final_loss"] < passes[0]["final_loss"],
            f"entries: fit_a_line train_local passes {passes}")
    fit = got["fit_a_line_elastic"]
    require(fit["steps"] == 160.0 and fit["world"] == 1.0 and math.isfinite(fit["final_loss"]),
            f"entries: fit_a_line train_elastic {fit}")
    require(got["mnist_train"]["steps"] == 60.0 and got["mnist_infer"]["step"] == 60
            and got["mnist_infer"]["accuracy"] > EN_MNIST_ACCURACY,
            f"entries: mnist {got['mnist_train']} then {got['mnist_infer']}")
    require(got["resnet_train"]["steps"] == 60.0 and got["resnet_infer"]["step"] == 60
            and got["resnet_infer"]["accuracy"] > EN_RESNET_ACCURACY,
            f"entries: resnet tiny {got['resnet_train']} then {got['resnet_infer']}")
    k = 4  # a shard's batches
    require(got["resnet_imagenet"]["steps"] == 24.0 and len(imagenet_losses) == 24
            and all(math.isfinite(x) for x in imagenet_losses)
            and statistics.mean(imagenet_losses[-k:]) < statistics.mean(imagenet_losses[:k]),
            f"entries: resnet --imagenet {got['resnet_imagenet']}, losses {imagenet_losses}")
    w2v = got["word2vec"]
    require(w2v["steps"] == EN_W2V["steps"]
            and w2v["profile_steady_steps"] == EN_W2V["profile_steady_steps"]
            and w2v["final_loss"] < EN_W2V["final_loss_below"], f"entries: word2vec {w2v}")
    out = {"results": got, "imagenet_losses": imagenet_losses, "seconds": seconds}
    print(f"entries (a): fit_a_line train_local 10 passes, loss {passes[0]['final_loss']} -> "
          f"{passes[-1]['final_loss']}; train_elastic {fit['steps']:.0f} steps, loss "
          f"{fit['final_loss']}; MNIST {got['mnist_train']['steps']:.0f} steps (host step p50 "
          f"{got['mnist_train']['step_time_p50_s'] * 1e3:.3f} ms), infer accuracy "
          f"{got['mnist_infer']['accuracy']}; ResNet tiny {got['resnet_train']['steps']:.0f} "
          f"steps, loss {got['resnet_train']['final_loss']}, infer accuracy "
          f"{got['resnet_infer']['accuracy']}; ResNet-50 224 px batch 64: 24 steps, loss "
          f"{imagenet_losses[0]:.4f} -> {imagenet_losses[-1]:.4f}; word2vec {w2v['steps']:.0f} "
          f"steps ({w2v['profile_steady_steps']:.0f} steady, host step p50 "
          f"{w2v['profile_step_time_p50_s'] * 1e3:.3f} ms), loss {w2v['final_loss']}; "
          "wall seconds a subprocess (all of a wave at once) "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return out


def entries_churn() -> dict:
    """Part (b): the word2vec entry under two launchers against the native
    coordinator, two ranks sharing the card over gloo (``--dist-backend
    auto``), the table row-sharded over ``data``; SIGTERM to rank 1 once a
    round's checkpoint covers it; rank 0 exits 75, is relaunched at world
    1, restores and drains the queue (`churn_two_launchers`: every shard
    trained exactly once into the final state)."""
    entry = (f"{sys.executable} -m edl_tpu_torch.examples.word2vec.train_ft "
             f"--dist-backend auto {EN_ENTRY_ARGS}").strip()
    out, final = churn_two_launchers("entries (b) word2vec under churn", entry, "imikolov",
                                     EN_W2V_SHARDS, EN_W2V_BATCHES)
    require(final["profile_steps"] == out["world1_steps"] and math.isfinite(final["final_loss"]),
            f"entries (b): the world-1 incarnation's summary {final}")
    out["world1_final_loss"] = final["final_loss"]
    out["world1_profile_step_time_p50_s"] = final["profile_step_time_p50_s"]
    return out


def entries_obs_smoke() -> dict:
    """Part (d): ``python -m edl_tpu_torch.obs`` (the native coordinator, an
    `ElasticWorker` on the card with a `StepProfiler` and its `/metrics`,
    the coordinator status bridge, scraped while it trains) exits 0."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch.obs", *EN_ENTRY_ARGS.split()],
                         cwd=repo, env={**os.environ, "PYTHONPATH": repo},
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0 and "obs-smoke: OK" in out.stdout,
            f"obs smoke exited {out.returncode}: {out.stdout[-1000:]}{out.stderr[-3000:]}")
    line = out.stdout.strip().splitlines()[-1]
    seconds = time.perf_counter() - t0
    print(f"entries (d): {line} ({seconds:.1f} s)")
    return {"exit": out.returncode, "line": line, "seconds": seconds}


def phase_entries(profiler: dict) -> dict:
    """The entries phase: (a) `entries_local`, (b) `entries_churn`, (c)
    ``profiler``, the result of `profiler_on_card` in phase 4, (d)
    `entries_obs_smoke`; with its own seconds."""
    t0 = time.perf_counter()
    local = entries_local()
    churn = entries_churn()
    obs = entries_obs_smoke()
    seconds = time.perf_counter() - t0
    print(f"entries: the phase took {seconds:.1f} s")
    return {"local": local, "churn": churn, "profiler": profiler, "obs_smoke": obs,
            "seconds": seconds}


#: the controller phase: three nodes of one chip each, all three the one
#: card, which the LM's ranks share over gloo as in the elastic and mp phases
CTL_NODES = 3
#: lm-grow's queue: shards of one batch (a round is one step and a
#: checkpoint, so a SIGTERM'd rank leaves within ProcessCluster's 10 s
#: grace), enough that world 2 still trains after the shrink
CTL_LM_SHARDS, CTL_LM_BATCHES = 36, 1
#: world-3 steps every rank takes before w2v-admit arrives
CTL_WORLD3_STEPS = 3
CTL_LM_LR = 3e-4
#: w2v-admit's queue: shards of the entry's 10 batches of 512 (its end frees
#: its chip, and the autoscaler grows lm-grow again if lm-grow still trains)
CTL_W2V_SHARDS = 16
#: the autoscaler's loop (the reference's is 5 s) and the collector's period
CTL_LOOP_S, CTL_COLLECT_S = 2.0, 0.5
#: the deadline of parts (a) and (b) together
CTL_TIMEOUT = 480
#: extra arguments of the pods' entries and of the CLI's train (none on the
#: card: both train on the card by default)
CTL_ENTRY_ARGS = ""
CTL_CLI_ARGS = ""
#: the zoo model the CLI's train runs
CTL_CLI_MODEL = "transformer"


def ctl_entry_main(argv) -> int:
    """One trainer of the controller phase: ``chip_smoke.py --ctl-entry
    RECORD_DIR MODULE -- ARGS`` runs the entry
    ``edl_tpu_torch.examples.MODULE``'s ``main(ARGS)`` and appends, as they
    happen, one JSON line an event to ``RECORD_DIR/<pod>-<pid>.jsonl``: the
    incarnation's start, its restore (rank, world, epoch, the step
    restored), each shard read (at the round's first step), each mesh step
    (its flash launches, loss, time) and its exit (code, peak memory)."""
    import os
    import threading

    record_dir, module, args = argv[0], argv[1], argv[argv.index("--") + 1:]
    pod = os.environ.get("EDL_POD_NAME", "local")
    out = open(os.path.join(record_dir, f"{pod}-{os.getpid()}.jsonl"), "a", buffering=1)
    lock = threading.Lock()
    at = {"rank": None, "world": None, "step": 0}

    def emit(**event):
        with lock:
            out.write(json.dumps({**event, "t": time.time()}) + "\n")

    emit(event="start", pod=pod, pid=os.getpid())  # before the imports: start-up counts them
    import importlib

    import torch

    from edl_tpu_torch.obs.logs import configure_logging
    from edl_tpu_torch.runtime import train_loop
    from edl_tpu_torch.runtime.data import SyntheticShardSource
    from edl_tpu_torch.runtime.multihost import MultiHostWorker

    configure_logging(level="info")  # the worker's epoch and round lines, in the pod's log
    fa = _flash_module()
    mesh_step = train_loop.Trainer._mesh_step
    restore = MultiHostWorker._restore_or_init
    read = SyntheticShardSource.read

    def counted(self, state, batch):
        fa.reset_launches()
        t0 = time.perf_counter()
        new, loss = mesh_step(self, state, batch)
        value = float(loss)  # synchronises on the step's work
        emit(event="step", step=at["step"], rank=at["rank"], world=at["world"],
             launches=dict(fa.LAUNCHES), loss=value, ms=(time.perf_counter() - t0) * 1e3)
        at["step"] += 1
        return new, loss

    def held(self, trainer):
        state = restore(self, trainer)
        at.update(rank=trainer.mesh.rank, world=trainer.mesh.world, step=int(state.step))
        emit(event="restore", rank=trainer.mesh.rank, world=trainer.mesh.world,
             epoch=self._epoch, restored_step=int(state.step))
        return state

    def recorded(self, shard):
        emit(event="read", shard=shard, step=at["step"])
        yield from read(self, shard)

    train_loop.Trainer._mesh_step = counted
    MultiHostWorker._restore_or_init = held
    SyntheticShardSource.read = recorded
    code = 0
    try:
        importlib.import_module(f"edl_tpu_torch.examples.{module}").main(args)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else 1
    finally:
        peak = (torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_available()
                else None)
        emit(event="exit", code=code, peak_memory_gib=peak)
        out.close()
    return code


def _ctl_records(record_dir: str) -> list:
    """Every incarnation's events (`ctl_entry_main`), one dict each: its pod,
    start, restore, reads, steps and exit."""
    import os

    incs = []
    for name in sorted(os.listdir(record_dir)):
        inc = {"reads": [], "steps": [], "restore": None, "exit": None}
        with open(os.path.join(record_dir, name)) as f:
            for line in f:
                if not line.endswith("\n"):
                    break  # a line still being written
                ev = json.loads(line)
                kind = ev.pop("event")
                if kind == "start":
                    inc.update(pod=ev["pod"], pid=ev["pid"], start=ev["t"])
                elif kind in ("restore", "exit"):
                    inc[kind] = ev
                else:
                    inc[f"{kind}s"].append(ev)
        incs.append(inc)
    return sorted(incs, key=lambda i: i["start"])


def _ctl_generations(incs: list) -> list:
    """The incarnations that restored, grouped by the epoch they joined,
    oldest first: [(epoch, world, restored step, [incarnations by rank])]."""
    by_epoch = {}
    for inc in incs:
        if inc["restore"] is not None:
            by_epoch.setdefault(inc["restore"]["epoch"], []).append(inc)
    out = []
    for epoch, group in sorted(by_epoch.items()):
        group.sort(key=lambda i: i["restore"]["rank"])
        worlds = {i["restore"]["world"] for i in group}
        steps = {i["restore"]["restored_step"] for i in group}
        require(len(worlds) == 1 and len(steps) == 1 and len(group) == worlds.copy().pop(),
                f"controller: epoch {epoch}'s incarnations disagree: "
                f"{[(i['pod'], i['restore']) for i in group]}")
        out.append((epoch, worlds.pop(), steps.pop(), group))
    return out


def _ctl_exactly_once(gens: list, tasks: list) -> dict:
    """Every shard trained exactly once into the final state: each
    generation's rounds up to the step the next one restored (all of the
    last one's) form the final state's lineage; their shards (a tail
    round's replicas counted once, as its ranks average one shard's
    gradient) must be every task, each in one round only."""
    from collections import Counter

    lineage = Counter()
    for k, (epoch, world, restored, group) in enumerate(gens):
        upto = gens[k + 1][2] if k + 1 < len(gens) else math.inf
        rounds = {}
        for inc in group:
            for r in inc["reads"]:
                if r["step"] < upto:
                    rounds.setdefault(r["step"], set()).add(r["shard"])
        for shards in rounds.values():
            lineage.update(shards)
    twice = sorted(s for s, n in lineage.items() if n > 1)
    missing = sorted(set(tasks) - set(lineage))
    require(not twice and not missing and set(lineage) == set(tasks),
            f"controller: shards trained more than once into the final state {twice}, "
            f"never {missing}")
    return {"shards": len(lineage), "generations": [(e, w, r) for e, w, r, _ in gens]}


def _live_groups(pgids) -> list:
    """The process groups among ``pgids`` with a live member (a zombie
    awaiting its reaper is not live), from ``/proc``."""
    import os

    live = set()
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue  # exited while we looked
        if fields[0] != "Z" and int(fields[2]) in pgids:
            live.add(int(fields[2]))
    return sorted(live)


def _ctl_job(name: str, port: int, lo: int, hi: int, entry: str, tasks: list, per: int,
             root: str):
    """A TrainingJob of the phase: one chip a trainer, the coordinator pod
    the port's launcher on ``port``, the trainers the port's launcher
    running ``entry`` and dialing the coordinator at 127.0.0.1 (the job's
    DNS name resolves nowhere here)."""
    import os

    from edl_tpu_torch.api.types import TrainingJob

    repo = os.path.dirname(os.path.abspath(__file__))
    coord_dir = os.path.join(root, f"coordinator-{name}")
    os.makedirs(coord_dir, exist_ok=True)
    return TrainingJob.from_dict({
        "metadata": {"name": name},
        "spec": {
            "image": "edl-tpu-torch:local", "port": port, "fault_tolerant": True,
            "tpu": {"chips_per_trainer": 1},
            "data_shards": tasks,
            "checkpoint_dir": os.path.join(root, f"ckpt-{name}"),
            "checkpoint_interval": per,
            "coordinator": {
                "entrypoint": f"{sys.executable} -m edl_tpu_torch.launcher start_coordinator "
                              f"--port {port}",
                "workspace": coord_dir, "env": {"PYTHONPATH": repo}},
            "trainer": {
                "entrypoint": f"{sys.executable} -m edl_tpu_torch.launcher start_trainer",
                "min_instance": lo, "max_instance": hi,
                "resources": {"requests": {"cpu": 1, "memory": "8Gi"}},
                "env": {"EDL_COORDINATOR_ENDPOINT": f"127.0.0.1:{port}", "EDL_ENTRY": entry,
                        "PYTHONPATH": repo, "PYTHONUNBUFFERED": "1",
                        "EDL_TERMINATION_LOG": os.path.join(root, f"term-{name}")}},
        },
    })


def _ctl_cli(root: str) -> dict:
    """Part (c)'s two subprocesses, started at once: ``python -m
    edl_tpu_torch train --model transformer --steps 4 --batch-size 8`` with
    no ``--device`` and ``plan --json`` with the H100 defaults."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("EDL_")}
    env["PYTHONPATH"] = repo
    cmds = {"train": ["train", "--model", CTL_CLI_MODEL, "--steps", "4", "--batch-size", "8",
                      *CTL_CLI_ARGS.split()],
            "plan": ["plan", "--json"]}
    procs = {}
    for label, args in cmds.items():
        files = [open(os.path.join(root, f"cli-{label}.{k}"), "w") for k in ("out", "err")]
        procs[label] = [time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch", *args], cwd=repo, env=env,
            stdout=files[0], stderr=files[1]), None]
    return procs


def _ctl_cli_poll(procs: dict) -> None:
    """Note each CLI subprocess's wall seconds once it has exited."""
    for entry in procs.values():
        if entry[2] is None and entry[1].poll() is not None:
            entry[2] = time.perf_counter() - entry[0]


def _ctl_cli_finish(procs: dict, root: str) -> dict:
    import os

    out = {}
    try:
        for label, (t0, p, _) in procs.items():
            p.wait(timeout=300)
            _ctl_cli_poll(procs)
            text = open(os.path.join(root, f"cli-{label}.out")).read()
            err = open(os.path.join(root, f"cli-{label}.err")).read()
            require(p.returncode == 0, f"controller (c): {label} exited {p.returncode}:\n"
                                       f"{err[-3000:]}")
            out[label] = (json.loads(text), err, procs[label][2])
    finally:
        for _, p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    metrics, err, seconds = out["train"]
    device = re.search(rf"training {CTL_CLI_MODEL} on (\S+)", err)
    require(device is not None and device.group(1).startswith(
        "cpu" if "cpu" in CTL_CLI_ARGS else "cuda") and math.isfinite(metrics["final_loss"])
        and metrics["steps"] == 4.0, f"controller (c): train {metrics} on "
                                     f"{device and device.group(1)}:\n{err[-2000:]}")
    plan = out["plan"][0]
    require(plan["chips"] == 16 and plan["axes"], f"controller (c): plan {plan}")
    print(f"controller (c): python -m edl_tpu_torch train --model {CTL_CLI_MODEL} --steps 4 "
          f"--batch-size 8 (no --device) trained on {device.group(1)}: loss "
          f"{metrics['final_loss']}, {metrics['samples_per_sec']:.1f} samples/s, "
          f"{seconds:.1f} s of wall; plan --json with the H100 defaults chose "
          f"{plan['axes']} over {plan['chips']} cards in {out['plan'][2]:.1f} s")
    return {"train": metrics, "train_device": device.group(1), "train_s": seconds,
            "plan": {k: plan[k] for k in ("chips", "axes", "step_ms")},
            "plan_s": out["plan"][2]}


def _ctl_status(port: int, token: str) -> dict:
    """Part (c): ``python -m edl_tpu_torch status --port P --json`` against
    lm-grow's coordinator while it trains."""
    import os

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "edl_tpu_torch", "status", "--port", str(port),
                          "--json", "--token", token], cwd=repo,
                         env={**os.environ, "PYTHONPATH": repo}, capture_output=True,
                         text=True, timeout=120)
    require(out.returncode == 0, f"controller (c): status exited {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
    st = json.loads(out.stdout)
    require(st["ok"] is True and st["world"] >= 2, f"controller (c): status {st}")
    return {"world": st["world"], "epoch": st["epoch"], "done": st["done"],
            "queued": st["queued"], "seconds": time.perf_counter() - t0}


def controller_drive(root: str) -> dict:
    """Parts (a) and (b): the port's `Controller` over a `ProcessCluster`
    of ``CTL_NODES`` one-chip nodes. The third chip starts out held by
    another tenant's pod (an accounting-only pod, which the controller's
    store does not know, as `K8sCluster.inquire` counts every namespace's
    pods). lm-grow (2..3 trainers, the LM at the slice's full width,
    ``RANKS_LM_LAYERS`` deep, gloo)
    trains at world 2; once it has committed a round, that pod leaves, and
    the autoscaler, on its own, grows lm-grow 2 -> 3 (publish, spawn,
    nudge; both ranks exit 75 and come back at world 3). Once every
    world-3 rank has stepped, w2v-admit (one trainer, word2vec) is
    submitted and pends; the make-room pass shrinks lm-grow 3 -> 2 (the
    newest pod gets SIGTERM and leaves at a round boundary, the others exit
    75 and return at world 2), w2v-admit is placed and trains, and both
    jobs end Succeeded through their updaters. word2vec trains in seconds:
    when w2v-admit ends while lm-grow still trains, its chip is free again,
    and the autoscaler grows lm-grow back to 3 (allowed once, after
    w2v-admit's exit)."""
    import os
    import signal

    from edl_tpu_torch.api.quantity import ResourceList
    from edl_tpu_torch.controller import (AutoscalerConfig, Controller, NodeInfo,
                                          UpdaterConfig)
    from edl_tpu_torch.controller.actuation import EXPECTED_WORLD_KEY
    from edl_tpu_torch.controller.process_cluster import ProcessCluster
    from edl_tpu_torch.coordinator.client import CoordinatorClient, CoordinatorError
    from edl_tpu_torch.coordinator.server import ensure_built
    from edl_tpu_torch.runtime.data import pass_tasks, shard_names
    from edl_tpu_torch.tools.collector import Collector

    ensure_built()  # the coordinator pods' binary, built once before they start
    records = os.path.join(root, "records")
    os.makedirs(records)
    me = os.path.abspath(__file__)
    lm_port, w2v_port = _free_port(), _free_port()
    lm_tasks = shard_names("lm", CTL_LM_SHARDS)
    w2v_tasks = shard_names("imikolov", CTL_W2V_SHARDS)
    lm_entry = (f"{sys.executable} {me} --ctl-entry {records} lm.train -- "
                f"--vocab-size {SLICE['vocab_size']} --d-model {SLICE['d_model']} "
                f"--n-layers {RANKS_LM_LAYERS} --n-heads {SLICE['n_heads']} "
                f"--d-ff {SLICE['d_ff']} --seq-len {SLICE['seq_len']} --batch-size {BATCH} "
                f"--batches-per-shard {CTL_LM_BATCHES} --learning-rate {CTL_LM_LR} "
                f"--dist-backend gloo {CTL_ENTRY_ARGS}").strip()
    w2v_entry = (f"{sys.executable} {me} --ctl-entry {records} word2vec.train_ft -- "
                 f"--dist-backend auto {CTL_ENTRY_ARGS}").strip()
    lm_job = _ctl_job("lm-grow", lm_port, 2, 3, lm_entry, lm_tasks, CTL_LM_BATCHES, root)
    w2v_job = _ctl_job("w2v-admit", w2v_port, 1, 1, w2v_entry, w2v_tasks, 10, root)

    chip = {"cpu": 16, "memory": "64Gi", "tpu": 1}
    cluster = ProcessCluster([NodeInfo(name=f"node{i}", allocatable=ResourceList.make(chip))
                              for i in range(CTL_NODES)], log_dir=os.path.join(root, "pods"))
    print(f"controller: a ProcessCluster of {CTL_NODES} nodes of {chip}; all "
          f"{CTL_NODES} chips are the one card, which the ranks share over gloo")
    controller = Controller(
        cluster, autoscaler_config=AutoscalerConfig(loop_seconds=CTL_LOOP_S,
                                                    max_load_desired=0.97),
        updater_config=UpdaterConfig(convert_seconds=0.5, poll_seconds=0.2,
                                     create_timeout=120.0))
    for job in (lm_job, w2v_job):
        controller.actuator.set_endpoint(job.name, "127.0.0.1", job.spec.port)
    collector = Collector(controller.store, cluster, period_seconds=CTL_COLLECT_S)
    groups = set()  # every pod's process group, to prove none outlives the part
    w2v_phases = []
    deadline = time.monotonic() + CTL_TIMEOUT

    def pods_log() -> str:
        tails = []
        for name in sorted(os.listdir(os.path.join(root, "pods"))):
            with open(os.path.join(root, "pods", name)) as f:
                tails.append(f"--- {name}\n{f.read()[-2500:]}")
        return "\n".join(tails)

    def until(cond, what):
        while True:
            _ctl_cli_poll(cli)
            with cluster._lock:
                groups.update(p.proc.pid for p in cluster.pods if p.proc is not None)
            phases = [p.phase for p in cluster.job_pods(w2v_job.name, "trainer")]
            if phases and (not w2v_phases or w2v_phases[-1] != phases[0]):
                w2v_phases.append(phases[0])
            if cond():
                return
            failed = [p.name for job in (lm_job, w2v_job)
                      for p in cluster.job_pods(job.name, "trainer") if p.phase == "Failed"]
            require(not failed and time.monotonic() < deadline,
                    f"controller: {what} (failed pods {failed}):\n{pods_log()}")
            time.sleep(0.2)

    def scales(name):
        return [(r.from_replicas, r.to_replicas, r.reason, r.timestamp)
                for r in controller.job_status(name).status.scale_history]

    def world_steps(world):
        """Each rank's steps at ``world`` so far."""
        counts = {}
        for i in _ctl_records(records):
            if i["pod"].startswith(lm_job.name) and i["restore"] and \
                    i["restore"]["world"] == world:
                counts[i["restore"]["rank"]] = counts.get(i["restore"]["rank"], 0) + \
                    len(i["steps"])
        return counts

    admin = None
    expected, cli = {}, {}
    t_start = time.time()
    try:
        cli.update(_ctl_cli(root))
        cluster.create_role("other-tenant", "trainer", 1,
                            ResourceList.make({"cpu": 1, "tpu": 1}), ResourceList())
        controller.start()
        collector.start()
        controller.submit(lm_job)
        t_submit_lm = time.time()
        until(lambda: controller.job_status(lm_job.name).spec.auth_token, "no auth token")
        token = controller.job_status(lm_job.name).spec.auth_token

        def lm_done(n):
            nonlocal admin
            try:
                if admin is None:
                    admin = CoordinatorClient("127.0.0.1", lm_port, worker="chip-smoke-admin",
                                              connect_timeout=2.0, token=token)
                return int(admin.status().get("done", 0)) >= n
            except (CoordinatorError, OSError):
                return False  # the coordinator pod is still starting

        until(lambda: lm_done(2), "lm-grow never committed a round at world 2")
        status = _ctl_status(lm_port, token)
        # the other tenant's pod leaves: the third chip is free
        cluster.delete_role("other-tenant", "trainer")
        t_free = time.time()
        collector.sample()
        until(lambda: len(scales(lm_job.name)) >= 1, "the autoscaler never grew lm-grow")
        expected["grow"] = admin.kv_get(EXPECTED_WORLD_KEY)
        until(lambda: len(world_steps(3)) == 3 and min(world_steps(3).values())
              >= CTL_WORLD3_STEPS, "lm-grow never stepped at world 3 on every rank")
        controller.submit(w2v_job)
        t_submit_w2v = time.time()
        until(lambda: len(scales(lm_job.name)) >= 2, "the make-room pass never shrank lm-grow")
        expected["shrink"] = admin.kv_get(EXPECTED_WORLD_KEY)
        until(lambda: all(controller.job_status(j.name).status.phase.value == "Succeeded"
                          for j in (lm_job, w2v_job)), "the jobs never both succeeded")
        t_end = time.time()
        pods = {j.name: [(p.name, p.phase) for p in cluster.job_pods(j.name, "trainer")]
                for j in (lm_job, w2v_job)}
        phases = {j.name: controller.job_status(j.name).status.phase.value
                  for j in (lm_job, w2v_job)}
        history = {j.name: scales(j.name) for j in (lm_job, w2v_job)}
        cli_out = _ctl_cli_finish(cli, root)
    finally:
        for _, p, _ in cli.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        if admin is not None:
            admin.close()
        collector.stop()
        controller.stop()
        cluster.shutdown(grace=min(10.0, max(1.0, deadline - time.monotonic())))
        alive = _live_groups(groups)
        for pgid in alive:
            os.killpg(pgid, signal.SIGKILL)
    require(not alive, f"controller: pod process groups {alive} outlived the part")

    # -- the holds ----------------------------------------------------------------
    incs = _ctl_records(records)
    lm = [i for i in incs if i["pod"].startswith(lm_job.name)]
    w2v = [i for i in incs if i["pod"].startswith(w2v_job.name)]
    require(len(w2v) == 1 and w2v[0]["exit"] is not None and w2v[0]["exit"]["code"] == 0
            and w2v[0]["restore"]["world"] == 1
            and len(w2v[0]["steps"]) == CTL_W2V_SHARDS * 10,
            f"controller: w2v-admit's incarnations "
            f"{[(i['restore'], i['exit'], len(i['steps'])) for i in w2v]}")
    w2v_end = w2v[0]["exit"]["t"]
    got = [(a, b, r) for a, b, r, _ in history[lm_job.name]]
    # once w2v-admit has succeeded its chip is free again, and the autoscaler
    # may grow lm-grow back to 3 if its queue outlasts w2v-admit's
    regrows = history[lm_job.name][2:]
    require(got[:2] == [(2, 3, "autoscale"), (3, 2, "make-room")]
            and all(r[:3] == (2, 3, "autoscale") and r[3] > w2v_end for r in regrows)
            and len(regrows) <= 1 and not history[w2v_job.name],
            f"controller: scale records {history}, want lm-grow (2, 3) then (3, 2) (then "
            "(2, 3) again once w2v-admit has succeeded)")
    require(expected == {"grow": "3", "shrink": "2"},
            f"controller: edl/expected_world read {expected}, want 3 then 2")
    require(phases == {lm_job.name: "Succeeded", w2v_job.name: "Succeeded"}
            and all(ph == "Succeeded" for ps in pods.values() for _, ph in ps)
            and len(pods[lm_job.name]) == 2 + len(regrows) and len(pods[w2v_job.name]) == 1,
            f"controller: jobs {phases}, pods {pods}")
    require("Running" in w2v_phases and w2v_phases[-1] == "Succeeded",
            f"controller: w2v-admit's pod went {w2v_phases}, want Running then Succeeded")
    gens = _ctl_generations(lm)
    worlds = [w for _, w, _, _ in gens]
    require(worlds[:3] == [2, 3, 2] and all(w == 3 for w in worlds[3:])
            and len(worlds) <= 3 + len(regrows),
            f"controller: lm-grow's generations ran at worlds {worlds}")
    once = _ctl_exactly_once(gens, pass_tasks(lm_tasks, 1))
    finals, ended = {}, {}
    for inc in lm:
        finals[inc["pod"]] = inc
        if inc["restore"] is not None:
            ended[inc["pod"]] = inc["restore"]["world"]
    reported = {}
    for pod in finals:
        with open(os.path.join(root, "pods", f"{pod}.log")) as f:
            lines = [json.loads(x) for x in f.read().splitlines() if x.startswith("{")]
        if lines:
            reported[pod] = lines[-1]["world"]
    require(all(i["exit"] is not None and i["exit"]["code"] == 0 for i in finals.values())
            and all(reported[p] == ended[p] for p in reported)
            and len(reported) >= 2,
            f"controller: lm-grow pods' final incarnations "
            f"{[(p, i['restore'], i['exit']) for p, i in finals.items()]}, the worlds their "
            f"metrics lines report {reported}: want each to exit 0 and report the world it "
            "ended at")
    want = mp_expected_launches({}, _mp_config({"n_layers": RANKS_LM_LAYERS}))
    steps = [(w, s) for _, w, _, group in gens for i in group for s in i["steps"]]
    bad = [(w, s["rank"], s["launches"]) for w, s in steps if s["launches"] != want]
    require(not bad and {w for w, _ in steps} == {2, 3},
            f"controller: flash launches a step {bad[:5]}, want {want} on every rank")
    losses = [s["loss"] for _, s in steps] + [s["loss"] for i in w2v for s in i["steps"]]
    require(all(math.isfinite(x) for x in losses), f"controller: losses {losses}")

    # -- the collector's samples: chips used of 3 and running trainers ----------
    samples = []
    for s in collector.samples:
        row = (round(s.tpu_utilization * CTL_NODES),
               {k: v for k, v in s.running_trainers.items() if v})
        if not samples or samples[-1][1:] != row:
            samples.append((round(s.timestamp - t_start, 2), *row))
    marks = [(2, {lm_job.name: 2}), (3, {lm_job.name: 3}),
             (3, {lm_job.name: 2, w2v_job.name: 1})]
    it = iter((u, r) for _, u, r in samples)
    require(all(m in it for m in marks),
            f"controller: the collector's samples {samples} lack chips used/total 2/3, then "
            "3/3, then 3/3 with both jobs")

    # -- the figures ----------------------------------------------------------------
    def latency(record, gen):
        """The record's time to the last rank's first step at the new world:
        the rest (the record to the last new incarnation's process start:
        the old ranks' round boundary, exit 75 and relaunch; negative for a
        shrink, whose record is written after the victim's drain, while the
        survivors already relaunch) and the start-up (that start to the
        first step: imports, the group, the build and restore, the step)."""
        _, world, _, group = gen
        starts = [i["start"] for i in group]
        firsts = [i["steps"][0]["t"] for i in group]
        return {"world": world, "total_s": max(firsts) - record[3],
                "startup_s": max(firsts) - max(starts), "rest_s": max(starts) - record[3],
                "startup_by_rank_s": [f - s for f, s in zip(firsts, starts)]}

    def step_ms(gen):
        """The median step of a generation's ranks, each incarnation's first
        step (its warm-up) left out."""
        steady = [s["ms"] for i in gen[3] for s in i["steps"][1:]]
        return statistics.median(steady) if steady else None

    grow, shrink = history[lm_job.name][:2]
    lat = {"grow": latency(grow, gens[1]), "shrink": latency(shrink, gens[2])}
    if regrows and len(gens) > 3:
        lat["regrow"] = latency(regrows[0], gens[3])
    w2v_first = w2v[0]["steps"][0]["t"]
    out = {
        "nodes": CTL_NODES, "lm_shards": CTL_LM_SHARDS, "w2v_shards": CTL_W2V_SHARDS,
        "scale_records": got, "expected_world": expected, "jobs": phases, "pods": pods,
        "worlds_reported": reported,
        "w2v_pod_phases": w2v_phases, "exactly_once": once,
        "flash_launches_per_step_and_rank": want,
        "launches": {k: sum(s["launches"][k] for _, s in steps) for k in want},
        "actuation": lat,
        "step_ms": {"world2_before": step_ms(gens[0]), "world3": step_ms(gens[1]),
                    "world2_after": step_ms(gens[2]),
                    **({"world3_regrown": step_ms(gens[3])} if len(gens) > 3 else {})},
        "peak_memory_gib": {i["pod"]: i["exit"]["peak_memory_gib"] for i in lm + w2v},
        "first_step_s": {"lm_grow": min(s["t"] for i in gens[0][3] for s in i["steps"][:1])
                         - t_submit_lm, "w2v_admit": w2v_first - t_submit_w2v},
        "w2v_wait_s": w2v_first - t_submit_w2v,
        "chip_free_to_decision_s": grow[3] - t_free,
        "w2v_submit_to_decision_s": shrink[3] - t_submit_w2v,
        "samples": samples, "status": status, "wall_s": t_end - t_start,
    }
    print(f"controller (a): lm-grow (the LM at d {SLICE['d_model']}, {RANKS_LM_LAYERS} "
          f"layers, batch {BATCH} a rank) trained at world 2 from {out['first_step_s']['lm_grow']:.2f} "
          f"s after its submit; status --json answered (world {status['world']}, done "
          f"{status['done']}); the third chip freed, the autoscaler decided 2 -> 3 "
          f"{out['chip_free_to_decision_s']:.2f} s later (edl/expected_world "
          f"{expected['grow']}); actuation {lat['grow']['total_s']:.2f} s to the first world-3 "
          f"step on every rank: {lat['grow']['rest_s']:.2f} s to the last new incarnation's "
          f"process start, then {lat['grow']['startup_s']:.2f} s of start-up to the last "
          f"rank's first step (each rank's start-up {lat['grow']['startup_by_rank_s']})")
    print(f"controller (b): w2v-admit submitted and pending; make-room 3 -> 2 "
          f"{out['w2v_submit_to_decision_s']:.2f} s after its submit (edl/expected_world "
          f"{expected['shrink']}); actuation {lat['shrink']['total_s']:.2f} s to the first "
          f"world-2 step on both ranks ({lat['shrink']['startup_s']:.2f} s start-up, "
          f"{lat['shrink']['rest_s']:.2f} s the rest); w2v-admit's wait from submit to its "
          f"first step {out['w2v_wait_s']:.2f} s; both jobs Succeeded, every pod "
          f"Succeeded, {once['shards']} LM shards each trained once into the final state over "
          f"generations {once['generations']}")
    if "regrow" in lat:
        print(f"controller (b): w2v-admit's end freed its chip while lm-grow still trained: "
              f"the autoscaler grew lm-grow 2 -> 3 again, actuation "
              f"{lat['regrow']['total_s']:.2f} s ({lat['regrow']['startup_s']:.2f} s start-up)")
    print(f"controller: LM step ms {out['step_ms']}; flash launches {want} every step on every "
          f"rank at worlds 2 and 3; peak memory GiB {out['peak_memory_gib']}")
    print("controller: collector samples (s, chips used of 3, running trainers): "
          + "; ".join(f"{t} {u}/3 {r}" for t, u, r in samples))
    print(f"controller: parts (a)-(b) took {out['wall_s']:.1f} s")
    out["cli"] = cli_out
    return out


def phase_controller() -> dict:
    """The controller phase: parts (a) and (b) `controller_drive`, part (c)
    the CLI (`_ctl_cli`, `_ctl_status`); with its own seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="edl-controller-") as root:
        out = controller_drive(root)
    out["seconds"] = time.perf_counter() - t0
    print(f"controller: the phase took {out['seconds']:.1f} s")
    return out


# -- chaos: the composed chaos scenario on the card ------------------------------

#: job alpha (the SIGKILL axis): the LM entry at the slice's width as one
#: `ProcessCluster` trainer pod, shards of CH_ALPHA_BATCHES batches, a
#: checkpoint a shard (the entry's cloud mode commits a shard once a save
#: covers it)
CH_ALPHA_SHARDS, CH_ALPHA_BATCHES = 4, 2
#: job beta (the partition axis): an in-process `ElasticWorker` on the LM,
#: shards of CH_BETA_BATCHES, a checkpoint a shard; each batch paced by
#: CH_BETA_PACE seconds (`tests/test_chaos_composed.py`'s BETA_PACE) so its
#: queue outlives the three blips and the storm (the gates synchronise)
CH_BETA_SHARDS, CH_BETA_BATCHES, CH_BETA_PACE = 12, 4, 0.2
#: a blip's length as beta sees it (the JAX test holds each for 1.2 s)
CH_BLIP_S = 1.2
#: both jobs' coordinators: the launcher's heartbeat TTL
CH_TTL = 10.0
#: the phase's deadline
CH_TIMEOUT = 420
#: extra arguments of alpha's entry (none on the card)
CH_ENTRY_ARGS = ""


def _ch_paced_source(model, counts: dict):
    """Beta's source: `SyntheticShardSource` with each shard's reads
    counted and each batch paced by ``CH_BETA_PACE``."""
    from edl_tpu_torch.runtime import SyntheticShardSource

    class Paced(SyntheticShardSource):
        def read(self, shard):
            counts[shard] = counts.get(shard, 0) + 1
            for batch in super().read(shard):
                time.sleep(CH_BETA_PACE)
                yield batch

    return Paced(model, batch_size=BATCH, batches_per_shard=CH_BETA_BATCHES)


def _ch_beta_config(root: str, name: str, **kw):
    import os

    from edl_tpu_torch.runtime import ElasticConfig, TrainerConfig

    return ElasticConfig(checkpoint_dir=os.path.join(root, f"ck-{name}"),
                         checkpoint_interval=CH_BETA_BATCHES, heartbeat_interval=0.0,
                         trainer=TrainerConfig(optimizer="adam", learning_rate=3e-4), **kw)


def chaos_drive(device, root: str) -> dict:
    """The port's counterpart of `tests/test_chaos_composed.py` at the
    slice's width, its SIGKILL and partition axes overlapping under one
    `ChaosScenario` whose every fault gates on observed progress.

    Alpha: the LM entry under the port's launcher as one `ProcessCluster`
    trainer pod (``--ctl-entry`` records its events) against a native
    coordinator with the launcher's 10 s TTL; once a shard has committed,
    `kill_pod` SIGKILLs the pod's whole process group, `restart_failed`
    starts a replacement that restores the durable checkpoint and drains
    the queue. Beta: an `ElasticWorker` on the LM whose client goes through
    the port's `ChaosProxy` to its own native coordinator (10 s TTL), with
    the adaptive fault-tolerance policy: three blips, each healed once beta
    has seen 1.2 s of it, then a storm held until beta has parked and its
    ``/metrics`` has been scraped, then the heal. An unfaulted twin of beta trains on the card first, while
    alpha's pod starts."""
    import os
    import threading
    import urllib.request

    import torch

    import edl_tpu_torch
    from edl_tpu_torch.api.quantity import ResourceList
    from edl_tpu_torch.api.types import TrainingJob
    from edl_tpu_torch.api.validation import normalize
    from edl_tpu_torch.controller.cluster import NodeInfo
    from edl_tpu_torch.controller.jobparser import parse_to_trainer
    from edl_tpu_torch.controller.process_cluster import ProcessCluster
    from edl_tpu_torch.coordinator import (CoordinatorServer, InProcessCoordinator,
                                           RetryPolicy)
    from edl_tpu_torch.coordinator.client import CoordinatorClient
    from edl_tpu_torch.coordinator.server import ensure_built
    from edl_tpu_torch.models.transformer import TransformerConfig, make_model
    from edl_tpu_torch.obs.metrics import parse_prometheus
    from edl_tpu_torch.runtime import ElasticWorker, SyntheticShardSource, train_loop
    from edl_tpu_torch.runtime.data import shard_names
    from edl_tpu_torch.runtime.elastic import FT_POLICY_KEY
    from edl_tpu_torch.runtime.ft_policy import PARK, RECONNECT, FTPolicyConfig
    from edl_tpu_torch.testing import ChaosProxy, ChaosScenario

    ensure_built()
    fa = _flash_module()
    want = {k: RANKS_LM_LAYERS for k in ("fwd", "bwd_dq", "bwd_dkv")}
    t0 = time.perf_counter()
    deadline = time.monotonic() + CH_TIMEOUT
    me = os.path.abspath(__file__)
    records = os.path.join(root, "records")
    os.makedirs(records)

    # -- alpha: the job, its coordinator and its pod ----------------------------
    alpha_tasks = shard_names("alpha", CH_ALPHA_SHARDS)
    server_a = CoordinatorServer(port=_free_port(), task_lease_sec=120.0,
                                 heartbeat_ttl_sec=CH_TTL)
    entry = (f"{sys.executable} {me} --ctl-entry {records} lm.train -- "
             f"--vocab-size {SLICE['vocab_size']} --d-model {SLICE['d_model']} "
             f"--n-layers {RANKS_LM_LAYERS} --n-heads {SLICE['n_heads']} "
             f"--d-ff {SLICE['d_ff']} --seq-len {SLICE['seq_len']} --batch-size {BATCH} "
             f"--batches-per-shard {CH_ALPHA_BATCHES} --learning-rate 3e-4 "
             f"--dist-backend gloo {CH_ENTRY_ARGS}").strip()
    job = normalize(TrainingJob.from_dict({
        "metadata": {"name": "alpha"},
        "spec": {
            "port": server_a.port, "fault_tolerant": True, "tpu": {"chips_per_trainer": 1},
            "checkpoint_dir": os.path.join(root, "ck-alpha"),
            "checkpoint_interval": CH_ALPHA_BATCHES,
            "trainer": {
                "entrypoint": f"{sys.executable} -m edl_tpu_torch.launcher start_trainer",
                "min_instance": 1, "max_instance": 1,
                "resources": {"requests": {"cpu": 1, "memory": "8Gi"}},
                "env": {"EDL_COORDINATOR_ENDPOINT": server_a.address, "EDL_ENTRY": entry,
                        "PYTHONPATH": os.path.dirname(os.path.dirname(
                            os.path.abspath(edl_tpu_torch.__file__))),
                        "PYTHONUNBUFFERED": "1",
                        "EDL_TERMINATION_LOG": os.path.join(root, "term-alpha")}},
        }}))
    cluster = ProcessCluster([NodeInfo(name="node0", allocatable=ResourceList.make(
        {"cpu": 16, "memory": "64Gi", "tpu": 1}))], log_dir=os.path.join(root, "pods"))
    killed = {}

    def kill_alpha():
        (pod,) = [p for p in cluster.job_pods("alpha") if p.phase == "Running"]
        killed.update(pod=pod.name, t=time.time(), done=int(admin_a.status()["done"]))
        cluster.kill_pod(pod.name)  # SIGKILL to the whole group: no drain, no leave

    def respawn_alpha():
        """The Job controller's reconcile: once the pod reads Failed, a
        replacement (a new member; the dead one expires by the TTL)."""
        while not any(p.phase == "Failed" for p in cluster.job_pods("alpha")):
            require(time.monotonic() < deadline, "chaos: the killed pod never failed")
            time.sleep(0.1)
        require(cluster.restart_failed("alpha") == 1, "chaos: no replacement for alpha")

    def pods_log() -> str:
        tails = []
        for name in sorted(os.listdir(os.path.join(root, "pods"))):
            with open(os.path.join(root, "pods", name)) as f:
                tails.append(f"--- {name}\n{f.read()[-2500:]}")
        return "\n".join(tails)

    # -- beta: the worker behind the proxy, its launches counted ----------------
    server_b = CoordinatorServer(task_lease_sec=120.0, heartbeat_ttl_sec=CH_TTL)
    beta_tasks = shard_names("beta", CH_BETA_SHARDS)
    cfg = TransformerConfig(flash=True, **{**SLICE, "n_layers": RANKS_LM_LAYERS})
    #: each in-process step's launches, by the thread that stepped ("chaos-
    #: twin", then "chaos-beta": the launch counters are the process's, so
    #: the two never step at once)
    step_log = {}
    mesh_step = train_loop.Trainer._mesh_step

    def counted(self, state, batch):
        fa.reset_launches()
        new, loss = mesh_step(self, state, batch)
        step_log.setdefault(threading.current_thread().name, []).append(
            dict(fa.LAUNCHES))
        return new, loss

    # -- the unfaulted twin of beta, on the card while alpha's pod starts -------
    def run_twin():
        try:
            coord = InProcessCoordinator(task_lease_sec=120.0, heartbeat_ttl_sec=120.0)
            coord.client("admin").add_tasks(beta_tasks)
            twin = ElasticWorker(make_model(cfg), coord.client("w-twin"),
                                 SyntheticShardSource(make_model(cfg), batch_size=BATCH,
                                                      batches_per_shard=CH_BETA_BATCHES),
                                 _ch_beta_config(root, "twin"), device=device)
            twin_out["metrics"] = twin.run()
        except BaseException as e:  # edl: noqa[EDL005] raised on the main thread below
            twin_out["error"] = e

    counts = {}
    beta_out, twin_out = {}, {}
    sc = None
    twin_t = threading.Thread(target=run_twin, name="chaos-twin", daemon=True)
    train_loop.Trainer._mesh_step = counted
    try:
        server_a.start()
        server_b.start()
        admin_a = server_a.client("admin")
        admin_a.add_tasks(alpha_tasks)
        admin_b = server_b.client("admin")
        admin_b.add_tasks(beta_tasks)
        trainer = parse_to_trainer(job)
        cluster.create_role("alpha", "trainer", 1, trainer.requests, trainer.limits,
                            workload=trainer)
        twin_t.start()
        with ChaosProxy(server_b.port, seed=11) as proxy:
            raw_b = CoordinatorClient(port=proxy.port, worker="w-beta",
                                      retry=RetryPolicy(deadline=0.5, seed=11))
            worker_b = ElasticWorker(
                make_model(cfg), raw_b, _ch_paced_source(make_model(cfg), counts),
                _ch_beta_config(root, "beta", metrics_port=0, ft_policy=FTPolicyConfig(
                    outage_budget=6.0, min_history=3, min_wait=1.0,
                    storm_retry_deadline=0.5)),
                device=device)
            policy = worker_b.policy

            def run_beta():
                try:
                    beta_out["metrics"] = worker_b.run()
                except BaseException as e:  # edl: noqa[EDL005] raised on the main thread below
                    beta_out["error"] = e

            scraped = threading.Event()
            beta_t = threading.Thread(target=run_beta, name="chaos-beta", daemon=True)

            def hist(k):
                return lambda: len(policy.history) >= k

            sc = (ChaosScenario("composed-on-card")
                  .register_proxy("beta", proxy)
                  .register("alpha.kill", kill_alpha)
                  .register("alpha.respawn", respawn_alpha)
                  .register("beta.start", beta_t.start)
                  .predicate("twin_done", lambda: bool(twin_out))
                  .predicate("alpha_progress",
                             lambda: int(admin_a.status().get("done", 0)) >= 1)
                  .predicate("beta_warm", lambda: worker_b.steps_done >= 2)
                  # a blip heals once beta has seen it for CH_BLIP_S: a step or
                  # a checkpoint's wait makes no coordinator call, and a
                  # blip no call met would be no incident
                  .predicate("beta_down", lambda: worker_b.client.unreachable
                             and worker_b.client.outage_seconds() >= CH_BLIP_S)
                  .predicate("hist1", hist(1))
                  .predicate("hist2", hist(2))
                  .predicate("hist3", hist(3))
                  .predicate("scraped", scraped.is_set)
                  .add("alpha.kill", when="alpha_progress", timeout=CH_TIMEOUT,
                       note="SIGKILL alpha's pod once a shard has committed")
                  .add("alpha.respawn", note="Job-controller reconcile: replacement pod")
                  # beta starts now: its partitions land while alpha's
                  # replacement starts up, restores and drains
                  .add("beta.start", when="twin_done", timeout=CH_TIMEOUT,
                       note="beta's worker starts (the twin has ended)")
                  .add("beta.partition", when="beta_warm", timeout=120.0,
                       note="blip 1")
                  .add("beta.heal", when="beta_down", timeout=60.0)
                  .add("beta.partition", when="hist1", timeout=60.0, note="blip 2")
                  .add("beta.heal", when="beta_down", timeout=60.0)
                  .add("beta.partition", when="hist2", timeout=60.0, note="blip 3")
                  .add("beta.heal", when="beta_down", timeout=60.0)
                  .add("beta.partition", when="hist3", timeout=60.0,
                       note="the storm: held until beta parks")
                  .add("beta.heal", when="scraped", timeout=120.0,
                       note="heal once beta has parked and /metrics was scraped"))
            sc.start()
            while policy.decisions[PARK] < 1:
                require(time.monotonic() < deadline and sc.failed is None
                        and "error" not in beta_out
                        and (beta_t.is_alive() or beta_t.ident is None),
                        f"chaos: beta never parked: {policy.state()} {sc.events} "
                        f"{sc.failed} {beta_out.get('error')!r}\n{pods_log()}")
                time.sleep(0.05)
            url = getattr(worker_b, "metrics_url", None)
            require(url is not None, "chaos: beta's metrics server never came up")
            with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                families = parse_prometheus(r.read().decode())
            with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
                health = json.loads(r.read().decode())
            ft_families = sorted(n for n in families if n.startswith("edl_ft_policy_"))
            require({"edl_ft_policy_decisions_total", "edl_ft_policy_mode",
                     "edl_ft_policy_incidents_total",
                     "edl_ft_policy_park_threshold_seconds"} <= set(ft_families),
                    f"chaos: beta's /metrics families {ft_families}")
            require(health["ft_policy"]["mode"] == PARK, f"chaos: /healthz {health}")
            scraped.set()
            sc.join(timeout=max(1.0, deadline - time.monotonic()))
            require(sc.completed, f"chaos: the scenario did not complete: {sc.failed} "
                                  f"{sc.events}\n{pods_log()}")
            beta_t.join(timeout=max(1.0, deadline - time.monotonic()))
            require(not beta_t.is_alive(), "chaos: beta never drained after the heal")
            if "error" in beta_out:
                raise beta_out["error"]
        metrics_b = beta_out["metrics"]
        st_b = admin_b.status()
        audit = json.loads(admin_b.kv_get(FT_POLICY_KEY.format(worker="w-beta")))
        while any(p.proc is not None and p.proc.poll() is None for p in cluster.pods):
            require(time.monotonic() < deadline, f"chaos: alpha never drained\n{pods_log()}")
            time.sleep(0.2)
        phases = [p.phase for p in cluster.job_pods("alpha")]
        st_a = admin_a.status()
    finally:
        train_loop.Trainer._mesh_step = mesh_step
        if sc is not None:
            sc.close()
        cluster.shutdown(grace=2.0)
        server_a.stop()
        server_b.stop()
    twin_t.join(timeout=max(1.0, deadline - time.monotonic()))
    require(not twin_t.is_alive(), "chaos: the twin never ended")
    if "error" in twin_out:
        raise twin_out["error"]
    metrics_twin = twin_out["metrics"]
    spans = worker_b.tracer.find(name="ft_decision")
    beta_steps, beta_loss = metrics_b["steps"], metrics_b["final_loss"]
    del worker_b
    torch.cuda.empty_cache()

    # -- the checks -------------------------------------------------------------
    require(phases == ["Succeeded"], f"chaos: alpha's pods {phases}\n{pods_log()}")
    for name, st, n in (("alpha", st_a, CH_ALPHA_SHARDS), ("beta", st_b, CH_BETA_SHARDS)):
        require((int(st["done"]), int(st["queued"]), int(st["leased"])) == (n, 0, 0),
                f"chaos: {name}'s queue done/queued/leased {st['done']}/{st['queued']}/"
                f"{st['leased']}, want {n}/0/0")
    incs = [i for i in _ctl_records(records) if i["pod"].startswith("alpha")]
    gens = _ctl_generations(incs)
    once = _ctl_exactly_once(gens, alpha_tasks)
    (replacement,) = [i for i in incs if i["pod"] != killed["pod"]]
    require(replacement["exit"] is not None and replacement["exit"]["code"] == 0
            and replacement["steps"], f"chaos: alpha's replacement {replacement['exit']}")
    alpha_steps = [s for i in incs for s in i["steps"]]
    for s in alpha_steps:
        require(s["launches"] == want, f"chaos: an alpha step launched {s['launches']}, "
                                       f"want {want}")
        require(math.isfinite(s["loss"]), f"chaos: alpha loss {s['loss']}")
    require(sorted(step_log) == ["chaos-beta", "chaos-twin"]
            and all(s == want for run in step_log.values() for s in run),
            f"chaos: in-process steps launched {step_log}, want {want} each")
    used = sorted(m for m, n in policy.decisions.items() if n > 0)
    require(len(used) >= 2 and policy.decisions[RECONNECT] >= 3
            and policy.decisions[PARK] >= 1 and policy.incidents >= 4,
            f"chaos: beta's decisions {policy.decisions}, incidents {policy.incidents}")
    require(len(spans) >= policy.incidents and all(
        {"mode", "threshold", "elapsed", "park_breakeven"} <= set(s.attrs) for s in spans),
        f"chaos: beta's decision spans {[s.attrs for s in spans]}")
    require(audit["policy"] == "adaptive" and audit["incidents"] >= 4, f"chaos: {audit}")
    require(set(counts) == set(beta_tasks), f"chaos: beta read {counts}")
    replayed = sorted(s for s, n in counts.items() if n > 1)
    require(len(replayed) <= 1 and all(counts[s] == 2 for s in replayed),
            f"chaos: beta re-read {counts}")
    extra = beta_steps - metrics_twin["steps"]
    loss_rel = abs(beta_loss - metrics_twin["final_loss"]) / abs(metrics_twin["final_loss"])
    require(0 <= extra <= CH_BETA_BATCHES and loss_rel <= 0.05,
            f"chaos: beta {beta_steps} steps, loss {beta_loss}; twin "
            f"{metrics_twin['steps']} steps, loss {metrics_twin['final_loss']}")
    first = replacement["steps"][0]["t"]
    park = [s for s in spans if s.attrs["mode"] == PARK][0]
    out = {
        "alpha": {"shards": CH_ALPHA_SHARDS, "killed_after_done": killed["done"],
                  "recovery_s": first - killed["t"],
                  "startup_s": first - replacement["start"],
                  "startup_share": (first - replacement["start"]) / (first - killed["t"]),
                  "restored_step": replacement["restore"]["restored_step"],
                  "steps": len(alpha_steps), "exactly_once": once,
                  "peak_memory_gib": replacement["exit"]["peak_memory_gib"]},
        "beta": {"shards": CH_BETA_SHARDS, "decisions": dict(policy.decisions),
                 "modes": used, "incidents": policy.incidents,
                 "blip_rides_s": list(policy.history[:3]),
                 "park_decision_elapsed_s": park.attrs["elapsed"],
                 "park_threshold_s": park.attrs["threshold"],
                 "steps": beta_steps, "final_loss": beta_loss, "replayed_shards": replayed,
                 "spec": json.loads(sc.spec()), "fired": [e["action"] for e in sc.events]},
        "twin": {"steps": metrics_twin["steps"], "final_loss": metrics_twin["final_loss"]},
        "extra_steps": extra, "loss_diff": beta_loss - metrics_twin["final_loss"],
        "loss_rel_diff": loss_rel, "flash_launches_per_step": want,
        "launches": {k: sum(s["launches"][k] for s in alpha_steps)
                     + sum(s[k] for run in step_log.values() for s in run) for k in want},
        "exactly_once": {"alpha": [int(st_a["done"]), CH_ALPHA_SHARDS],
                         "beta": [int(st_b["done"]), CH_BETA_SHARDS]},
        "wall_s": time.perf_counter() - t0,
    }
    print(f"chaos alpha: SIGKILL after {killed['done']} of {CH_ALPHA_SHARDS} shards "
          f"committed; the replacement restored step {out['alpha']['restored_step']}, "
          f"kill-to-first-step recovery {out['alpha']['recovery_s']:.2f} s, of it "
          f"{out['alpha']['startup_s']:.2f} s the replacement's start-up "
          f"({out['alpha']['startup_share']:.1%}); every shard trained once over "
          f"generations {once['generations']}")
    print(f"chaos beta: blips ridden in {[round(x, 3) for x in out['beta']['blip_rides_s']]} s; "
          f"parked {park.attrs['elapsed']:.2f} s into the storm (threshold "
          f"{park.attrs['threshold']:.2f} s); decisions {policy.decisions}; steps "
          f"{beta_steps} against the twin's {metrics_twin['steps']}; final loss "
          f"{beta_loss!r} against {metrics_twin['final_loss']!r} (difference "
          f"{out['loss_diff']!r}, {'zero' if out['loss_diff'] == 0 else 'not zero'})")
    print(f"chaos: flash launches {want} every step of alpha, beta and the twin; the "
          f"scenario fired {out['beta']['fired']}")
    print("chaos: the fired timeline's spec " + sc.spec().replace("\n", " "))
    return out


def phase_chaos(device) -> dict:
    """The chaos phase (`chaos_drive`), with its own seconds."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="edl-chaos-") as root:
        out = chaos_drive(device, root)
    out["seconds"] = time.perf_counter() - t0
    print(f"chaos: the phase took {out['seconds']:.1f} s")
    return out


# -- deploy: the trainer image's file tree, and the LM job run from it -----------

#: the trainer image the deploy phase stages, and the job it runs from it
DEPLOY_DOCKERFILE = "deploy/torch/Dockerfile.trainer"
DEPLOY_MANIFEST = "edl_tpu_torch/examples/lm/job.yaml"
#: the instructions the stager knows; it refuses any other
DOCKER_INSTRUCTIONS = ("FROM", "RUN", "WORKDIR", "ENV", "COPY", "ENTRYPOINT", "CMD")
#: a package line's packages, each checked on the host in place of its
#: install: a pip requirement's name -> the module it provides (imported, at
#: the pinned version if the line pins one), an apt package -> the command
#: it provides (found on the staged PATH)
PIP_MODULES = {"torch": "torch", "numpy": "numpy", "pyyaml": "yaml"}
APT_COMMANDS = {"python3": "python3", "python3-pip": "pip", "python-is-python3": "python",
                "g++": "g++", "make": "make"}
#: pip's options that take a value (the next word is no package)
PIP_VALUE_OPTIONS = ("--index-url",)
#: the deploy job's one node: the chip machine (one card, 8 cores, 96 GiB)
DEPLOY_NODE = {"cpu": 8, "memory": "96Gi", "tpu": 1}
#: the manifest's data shards the job keeps (the first ones)
DEPLOY_SHARDS = 2
#: the seconds the job may take from its submit to Succeeded
DEPLOY_TIMEOUT = 300


def parse_dockerfile(path: str) -> list:
    """(line number, instruction, arguments) of each instruction of the
    Dockerfile at ``path``: comments and blank lines dropped, a line that
    ends in a backslash joined to the next. Raises ``ValueError`` on an
    instruction not in ``DOCKER_INSTRUCTIONS``, so that none is passed over
    without a word."""
    out, pending, start = [], "", 0
    with open(path) as f:
        for no, raw in enumerate(f, 1):
            line = raw.rstrip("\n")
            if not line.strip() or line.lstrip().startswith("#"):
                continue
            start = start if pending else no
            if line.endswith("\\"):
                pending += line[:-1]
                continue
            instruction, _, args = (pending + line).strip().partition(" ")
            pending = ""
            if instruction.upper() not in DOCKER_INSTRUCTIONS:
                raise ValueError(f"{path}:{start}: the stager does not know {instruction}")
            out.append((start, instruction.upper(), args.strip()))
    if pending:
        raise ValueError(f"{path}:{start}: the last line continues past the end")
    return out


def _rooted(root: str, path: str) -> str:
    """The image's absolute ``path`` under the staged ``root``."""
    import os

    return os.path.join(root, path.lstrip("/"))


def _copy_into(src: str, dest: str, into_dir: bool) -> None:
    """Docker's COPY of one source: a directory's contents into ``dest``, a
    file to ``dest`` or, when ``into_dir``, into it; mtimes kept, as Docker
    keeps a context file's."""
    import os
    import shutil

    if os.path.isdir(src):
        shutil.copytree(src, dest, dirs_exist_ok=True)
        return
    if into_dir:
        dest = os.path.join(dest, os.path.basename(src))
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    shutil.copy2(src, dest)


def _packages(command: str) -> tuple:
    """A package line's installer (``apt-get`` or ``pip``) and the packages
    its ``install`` commands name; the rest of the line (the index update,
    the cleanup) does nothing on the host."""
    import shlex

    words = shlex.split(command)
    installer, packages, segment = words[0], [], []
    for word in words + ["&&"]:
        if word != "&&":
            segment.append(word)
            continue
        if segment[:2] == [installer, "install"]:
            args = iter(segment[2:])
            for arg in args:
                if arg in PIP_VALUE_OPTIONS:
                    next(args)
                elif not arg.startswith("-"):
                    packages.append(arg)
        segment = []
    return installer, packages


def check_packages(command: str, env: dict) -> dict:
    """A package line, checked on the host in place of its install: each
    apt package's command on the staged PATH, each pip requirement's
    module imported by the staged ``python`` (at the pinned version if
    pinned). Returns package -> what was found."""
    import shutil

    installer, packages = _packages(command)
    found = {}
    if installer == "apt-get":
        for package in packages:
            require(package in APT_COMMANDS, f"deploy: no check for apt package {package}")
            found[package] = shutil.which(APT_COMMANDS[package], path=env["PATH"])
            require(found[package] is not None,
                    f"deploy: {package}'s {APT_COMMANDS[package]} is not on the host's PATH")
        return found
    pins = dict((req.split("==") + [""])[:2] for req in packages)
    require(pins and all(name in PIP_MODULES for name in pins),
            f"deploy: no check for pip requirements {sorted(set(pins) - set(PIP_MODULES))}")
    code = ("import importlib, importlib.metadata as m, json, sys\n"
            "print(json.dumps({d: [importlib.import_module(mod).__file__, m.version(d)]\n"
            "                  for d, mod in json.loads(sys.argv[1]).items()}))")
    proc = subprocess.run([shutil.which("python", path=env["PATH"]), "-c", code,
                           json.dumps({d: PIP_MODULES[d] for d in pins})],
                          env=env, capture_output=True, text=True, timeout=300)
    require(proc.returncode == 0, f"deploy: the host cannot import {sorted(pins)}:\n"
                                  f"{proc.stderr[-2000:]}")
    for name, (module, version) in json.loads(proc.stdout).items():
        require(not pins[name] or version.split("+")[0] == pins[name],
                f"deploy: the host has {name} {version}, the image pins {pins[name]}")
        found[name] = f"{version} {module}"
    return found


def stage_run(command: str, cwd: str, env: dict) -> dict:
    """One RUN line, timed: a package line (one that begins with
    ``apt-get`` or ``pip``) is checked on the host (`check_packages`); any
    other runs through ``sh -c`` in ``cwd`` with ``env`` and must exit 0."""
    t0 = time.perf_counter()
    if command.split()[0] in ("apt-get", "pip"):
        return {"run": command, "checked": check_packages(command, env),
                "seconds": time.perf_counter() - t0}
    proc = subprocess.run(["sh", "-c", command], cwd=cwd, env=env, capture_output=True,
                          text=True)
    require(proc.returncode == 0, f"deploy: RUN {command} exited {proc.returncode}:\n"
                                  f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return {"run": command, "seconds": time.perf_counter() - t0}


def stage_image(dockerfile: str, context: str, root: str) -> dict:
    """The image ``dockerfile`` builds from ``context``, staged as a file
    tree under ``root``: its WORKDIR, COPY and ENV lines applied there (an
    absolute path of the image, a destination or an ENV value's, maps under
    ``root``, and a COPY destination outside WORKDIR goes first on PATH),
    its RUN lines run in the staged WORKDIR (`stage_run`), FROM's image
    taken to be the host. Returns the staged WORKDIR, the environment the
    image gives a process (the host's, without its PYTHONPATH, with the
    image's ENV and PATH), each RUN line's record, ENTRYPOINT and CMD."""
    import os
    import posixpath
    import shlex

    workdir, env_lines, path_dirs, steps = "/", {}, [], []
    image = {"from": None, "entrypoint": None, "cmd": None}

    def environ() -> dict:
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(env_lines)
        env["PATH"] = os.pathsep.join([*path_dirs, os.environ.get("PATH", "")])
        return env

    for no, instruction, args in parse_dockerfile(dockerfile):
        if instruction == "FROM":
            image["from"] = args
        elif instruction == "WORKDIR":
            workdir = posixpath.join(workdir, args)
            os.makedirs(_rooted(root, workdir), exist_ok=True)
        elif instruction == "ENV":
            for pair in shlex.split(args):
                key, sep, value = pair.partition("=")
                require(sep == "=", f"deploy: {dockerfile}:{no}: ENV {pair} is not KEY=VALUE")
                env_lines[key] = os.pathsep.join(
                    _rooted(root, part) if part.startswith("/") else part
                    for part in value.split(":"))
        elif instruction == "COPY":
            *sources, dest = shlex.split(args)
            require(sources and not any(s.startswith("--") for s in sources),
                    f"deploy: {dockerfile}:{no}: COPY {args} (no sources, or a flag)")
            target = posixpath.join(workdir, dest)
            into_dir = dest.endswith("/") or len(sources) > 1
            if not (target + "/").startswith(workdir.rstrip("/") + "/"):
                bin_dir = _rooted(root, target if into_dir else posixpath.dirname(target))
                if bin_dir not in path_dirs:
                    path_dirs.insert(0, bin_dir)
            for src in sources:
                full = os.path.realpath(os.path.join(context, src))
                require(full.startswith(os.path.realpath(context) + os.sep)
                        and os.path.exists(full),
                        f"deploy: {dockerfile}:{no}: COPY source {src} is not in the context")
                _copy_into(full, _rooted(root, target), into_dir)
        elif instruction == "RUN":
            steps.append(stage_run(args, _rooted(root, workdir), environ()))
        else:  # ENTRYPOINT, CMD: the exec form
            image[instruction.lower()] = json.loads(args)
    return {**image, "workdir": _rooted(root, workdir), "env": environ(), "steps": steps}


def _job_port() -> int:
    """A port for the job whose next port (where its process group listens,
    ``EDL_PORT`` + 1) is free too, both below the host's ephemeral range,
    from which the kernel hands ports to outgoing connections (the other
    groups' processes make many)."""
    import random
    import socket

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    rng = random.Random()
    for _ in range(100):
        port = rng.randrange(low // 2, low - 2)
        with contextlib.ExitStack() as stack:
            try:
                for p in (port, port + 1):
                    stack.enter_context(socket.socket()).bind(("", p))
            except OSError:
                continue
        return port
    raise RuntimeError("deploy: no free pair of ports below the ephemeral range")


def _proc_read(pid: int, name: str) -> str:
    """``/proc/<pid>/<name>``, or "" once the process has gone."""
    try:
        with open(f"/proc/{pid}/{name}", "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace").strip()
    except OSError:
        return ""


def _children_exes(pid: int) -> list:
    """The executables of ``pid``'s children, from ``/proc``."""
    import os

    exes = []
    for child in filter(str.isdigit, os.listdir("/proc")):
        stat = _proc_read(int(child), "stat")
        if stat and int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            with contextlib.suppress(OSError):
                exes.append(os.readlink(f"/proc/{child}/exe"))
    return exes


def _pod_logs(root: str) -> dict:
    """Each pod's log under ``root/pods``, by pod name."""
    import os

    logs = {}
    for name in sorted(os.listdir(os.path.join(root, "pods"))):
        with open(os.path.join(root, "pods", name)) as f:
            logs[name.removesuffix(".log")] = f.read()
    return logs


def deploy_drive_main(job_path: str) -> int:
    """``chip_smoke.py --deploy-drive JOB``: `deploy_drive` in the image's
    environment and WORKDIR, as the deploy phase starts it; its record
    written to the job's ``out``."""
    with open(job_path) as f:
        job = json.load(f)
    with open(job["out"], "w") as f:
        json.dump(deploy_drive(job["root"], job["manifest"], job["library"]), f)
    return 0


def deploy_drive(root: str, manifest: str, library: str) -> dict:
    """Run ``manifest``'s job through the port's `Controller` over a
    `ProcessCluster` of one node of one card (``DEPLOY_NODE``), from this
    process's working directory and environment, which are the staged
    image's. The overrides, and no others: one card a trainer, one trainer,
    no model axes, the first ``DEPLOY_SHARDS`` shards, a free port, the
    checkpoint dir and the coordinator's workspace under ``root``, and the
    coordinator's address 127.0.0.1 (no cluster DNS here). Polls the pods
    until the job has Succeeded: each pod's process start (`_proc_started`)
    and command lines, the coordinator's native child, and the trainer's
    ``/proc/<pid>/maps`` for ``library`` and ``libcuda``. Returns what it
    saw."""
    import os
    import shutil
    import signal

    from edl_tpu_torch.api.quantity import ResourceList
    from edl_tpu_torch.api.types import TrainingJob
    from edl_tpu_torch.api.validation import normalize
    from edl_tpu_torch.controller import (AutoscalerConfig, Controller, NodeInfo,
                                          UpdaterConfig)
    from edl_tpu_torch.controller.jobparser import parse_job
    from edl_tpu_torch.controller.process_cluster import ProcessCluster

    with open(manifest) as f:
        job = normalize(TrainingJob.from_yaml(f.read()))
    port = _job_port()
    overrides = {
        "tpu.chips_per_trainer": 1, "trainer.min_instance": 1, "trainer.max_instance": 1,
        "parallelism": {}, "data_shards": job.spec.data_shards[:DEPLOY_SHARDS], "port": port,
        "checkpoint_dir": _rooted(root, job.spec.checkpoint_dir),
        "coordinator.workspace": _rooted(root, job.spec.coordinator.workspace),
        "trainer.env.EDL_COORDINATOR_ENDPOINT": f"127.0.0.1:{port}",
    }
    for key, value in overrides.items():
        *path, last = key.split(".")
        obj = job.spec
        for name in path:
            obj = getattr(obj, name)
        if isinstance(obj, dict):
            obj[last] = value
        else:
            setattr(obj, last, value)
    job = normalize(job)
    os.makedirs(job.spec.coordinator.workspace)  # the volume a pod would mount there
    workloads = {w.role: w.entrypoint for w in parse_job(job)}
    print(f"deploy: {manifest}'s job {job.name}, with these overrides and no others: "
          f"{overrides}; the controller dials its coordinator at 127.0.0.1:{port} too")
    print(f"deploy: the pods' commands {workloads}; edl-launch is "
          f"{shutil.which('edl-launch')}; PYTHONPATH {os.environ.get('PYTHONPATH')}; "
          f"working directory {os.getcwd()}")
    cluster = ProcessCluster([NodeInfo(name="h100-0",
                                       allocatable=ResourceList.make(DEPLOY_NODE))],
                             log_dir=os.path.join(root, "pods"))
    controller = Controller(
        cluster, autoscaler_config=AutoscalerConfig(loop_seconds=2.0, max_load_desired=0.9),
        updater_config=UpdaterConfig(convert_seconds=0.5, poll_seconds=0.2,
                                     create_timeout=120.0))
    controller.actuator.set_endpoint(job.name, "127.0.0.1", port)
    pods, trainer, coordinator = {}, {}, {}
    groups = set()
    t_submit = time.time()
    deadline = time.monotonic() + DEPLOY_TIMEOUT
    try:
        controller.start()
        controller.submit(job)
        while True:
            with cluster._lock:
                live = [(p.info.name, p.info.role, p.proc.pid, p.entrypoint)
                        for p in cluster.pods if p.proc is not None]
            now = time.time()
            for name, role, pid, entry in live:
                groups.add(pid)
                if name not in pods:
                    pods[name] = {"role": role, "pid": pid, "entrypoint": entry,
                                  "started": _proc_started(pid), "cmdlines": []}
                pod = pods[name]
                cmdline = _proc_read(pid, "cmdline")
                if cmdline and cmdline not in pod["cmdlines"]:
                    pod["cmdlines"].append(cmdline)
                if role == "trainer" and "library_mapped" not in trainer:
                    maps = _proc_read(pid, "maps")
                    if library in maps:
                        trainer.update(pod=name, library_mapped=now,
                                       libcuda="libcuda.so" in maps,
                                       mapped=sorted({line.split()[-1] for line in
                                                      maps.splitlines()
                                                      if "edl_tpu_torch_kernels" in line}))
                if role == "coordinator" and "native" not in coordinator:
                    native = [e for e in _children_exes(pid) if e.endswith("edl-coordinator")]
                    if native:
                        coordinator.update(pod=name, native=native[0])
            phase = controller.job_status(job.name).status.phase.value
            if phase == "Succeeded":
                break
            failed = [p.name for role in ("coordinator", "trainer")
                      for p in cluster.job_pods(job.name, role) if p.phase == "Failed"]
            if failed or phase == "Failed" or time.monotonic() > deadline:
                tails = "\n".join(f"--- {n}\n{text[-3000:]}"
                                  for n, text in _pod_logs(root).items())
                raise RuntimeError(f"deploy: the job is {phase}, failed pods {failed}, "
                                   f"{DEPLOY_TIMEOUT} s allowed:\n{tails}")
            time.sleep(0.05)
        t_done = time.time()
        exits = {p.name: p.phase for p in cluster.job_pods(job.name, "trainer")}
    finally:
        controller.stop()
        cluster.shutdown(grace=5.0)
        alive = _live_groups(groups)
        for pgid in alive:
            os.killpg(pgid, signal.SIGKILL)
    require(not alive, f"deploy: pod process groups {alive} outlived the job")
    return {"job": job.name, "overrides": overrides, "workloads": workloads,
            "edl_launch": shutil.which("edl-launch"), "pods": pods, "pod_phases": exits,
            "trainer": trainer, "coordinator": coordinator, "logs": _pod_logs(root),
            "submit_to_succeeded_s": t_done - t_submit, "t_submit": t_submit}


def deploy_state(workdir: str) -> dict:
    """What a pod that compiled would change: each file under the staged
    ``build/kernels`` (the baked library, its ``.log``, any ``*.objs``
    directory) with its mtime and size, and the coordinator binary's
    mtime."""
    import os

    kernels = os.path.join(workdir, "build", "kernels")
    binary = os.path.join(workdir, "native", "coordinator", "edl-coordinator")
    return {"kernels": {n: [os.stat(os.path.join(kernels, n)).st_mtime_ns,
                            os.stat(os.path.join(kernels, n)).st_size]
                        for n in sorted(os.listdir(kernels))},
            "coordinator_mtime_ns": os.stat(binary).st_mtime_ns}


def _proc_started(pid: int) -> float:
    """The wall time ``pid`` started at, from its start tick in
    ``/proc/<pid>/stat`` (field 22) and ``/proc/uptime``."""
    import os

    ticks = int(_proc_read(pid, "stat").rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def _deploy_entry() -> tuple:
    """The LM manifest's trainer spec, its entrypoint's words and the
    entry's parsed arguments."""
    import os
    import shlex

    from edl_tpu_torch.api.types import TrainingJob
    from edl_tpu_torch.examples.lm import train as lm_train

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), DEPLOY_MANIFEST)) as f:
        spec = TrainingJob.from_yaml(f.read()).spec
    entry = shlex.split(spec.trainer.entrypoint)
    return spec, entry, lm_train.parse_args(entry[3:])


def stage_deploy(root: str) -> dict:
    """The deploy phase's first part: the trainer image's tree staged from
    this checkout under ``root`` (`stage_image`), its kernels baked. It
    runs alone, before the phase groups: the bake's ``nvcc`` processes
    would load the host's cores under the groups' start-up times. Holds
    that the bake left the library and its log and nothing else; returns
    the staged image with ``root``, the library's path and `deploy_state`."""
    import os

    from edl_tpu_torch.ops import _build

    _, _, args = _deploy_entry()
    attention = (args.batch_size, args.seq_len, args.n_heads, args.d_model // args.n_heads)
    require(attention == DEPLOY_ATTENTION, f"deploy: the manifest's entry attends at "
                                           f"{attention}, phase 3 times {DEPLOY_ATTENTION}")
    repo = os.path.dirname(os.path.abspath(__file__))
    image = stage_image(os.path.join(repo, DEPLOY_DOCKERFILE), repo, root)
    for step in image["steps"]:
        print(f"deploy: RUN {step['run']}: {step['seconds']:.1f} s"
              + (f", checked on the host: {step['checked']}" if "checked" in step else ""))
    library = os.path.join(image["workdir"], "build", "kernels", _build.library_path().name)
    before = deploy_state(image["workdir"])
    require(sorted(before["kernels"]) == sorted(
        [os.path.basename(library), os.path.basename(library)[:-3] + ".log"]),
        f"deploy: the bake left {sorted(before['kernels'])}, want the library "
        f"{os.path.basename(library)} and its log")
    return {**image, "root": root, "library": library, "before": before}


def phase_deploy(staged: dict) -> dict:
    """The deploy phase's second part: the port's LM manifest run from the
    tree `stage_deploy` staged (`deploy_drive`, in a process of its own
    with the image's environment and WORKDIR) and held: the job Succeeded,
    the coordinator pod started through ``edl-launch`` and ran the staged
    native binary, the trainer ran the manifest's entrypoint on the card
    with the baked library mapped, its metrics line shows the expected
    steps and a finite loss and the line before it the flash launches those
    steps make (steps x layers, the forward twice under ``--remat``), and no
    pod compiled
    anything (`deploy_state` unchanged)."""
    import os

    fa = _flash_module()
    t0 = time.perf_counter()
    spec, entry, args = _deploy_entry()
    want_steps = DEPLOY_SHARDS * args.batches_per_shard * spec.passes
    root, workdir, library = staged["root"], staged["workdir"], staged["library"]
    job = os.path.join(root, "drive.json")
    with open(job, "w") as f:
        json.dump({"root": root, "manifest": os.path.join(workdir, DEPLOY_MANIFEST),
                   "library": library, "out": f"{job}.out"}, f)
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--deploy-drive", job],
                          cwd=workdir, env=staged["env"], capture_output=True, text=True,
                          timeout=DEPLOY_TIMEOUT + 120)
    sys.stdout.write(proc.stdout)
    require(proc.returncode == 0, f"deploy: the drive exited {proc.returncode}:\n"
                                  f"{proc.stderr[-5000:]}")
    with open(f"{job}.out") as f:
        drive = json.load(f)
    after = deploy_state(workdir)
    pods = drive["pods"]
    trainer_pod = next(n for n, p in pods.items() if p["role"] == "trainer")
    coord_pod = next(n for n, p in pods.items() if p["role"] == "coordinator")
    lines = [json.loads(x) for x in drive["logs"][trainer_pod].splitlines()
             if x.startswith("{")]
    launched, metrics = lines[-2:] if len(lines) > 1 else ({}, {})
    tr, co = drive["trainer"], drive["coordinator"]
    require(drive["pod_phases"] == {trainer_pod: "Succeeded"} and len(pods) == 2,
            f"deploy: pods {sorted(pods)}, trainers {drive['pod_phases']}: want one "
            "coordinator pod and one trainer pod, Succeeded")
    require(metrics.get("steps") == want_steps and math.isfinite(metrics.get("final_loss", math.nan)),
            f"deploy: the trainer's metrics {metrics}, want {want_steps} steps and a finite "
            f"loss:\n{drive['logs'][trainer_pod][-3000:]}")
    variants = {tuple(v[:4]): v[4] for v in launched.get("flash_launches", [])}
    launches = dict.fromkeys(fa.LAUNCHES, 0)
    for (kernel, dtype, dp, _), n in variants.items():
        require(dtype == "bfloat16" and dp == fa.padded_head_dim(DEPLOY_ATTENTION[3]),
                f"deploy: the trainer launched {kernel} in {dtype} at padded head dim {dp}, "
                f"want bfloat16 at {fa.padded_head_dim(DEPLOY_ATTENTION[3])}")
        launches[kernel] += n
    per_step = args.n_layers * want_steps
    want_launches = {"fwd": per_step * (2 if args.remat else 1), "bwd_dq": per_step,
                     "bwd_dkv": per_step}
    require(launches == want_launches,
            f"deploy: the trainer's flash launches {launches}, want {want_launches} "
            f"({want_steps} steps of {args.n_layers} layers, remat {args.remat})")
    require(staged["before"] == after,
            f"deploy: a pod compiled: {staged['before']} before the job, {after} after")
    require(tr.get("mapped") == [library] and tr.get("libcuda"),
            f"deploy: the trainer's maps {tr}, want {library} and libcuda")
    require(pods[trainer_pod]["entrypoint"] == spec.trainer.entrypoint
            and any(c.split()[1:] == entry[1:] for c in pods[trainer_pod]["cmdlines"]),
            f"deploy: the trainer ran {pods[trainer_pod]}, want {spec.trainer.entrypoint}")
    shim = _rooted(root, "/usr/local/bin/edl-launch")
    require(pods[coord_pod]["entrypoint"].split()[0] == "edl-launch"
            and drive["edl_launch"] == shim
            and any("-m edl_tpu_torch.launcher start_coordinator" in c
                    for c in pods[coord_pod]["cmdlines"])
            and co.get("native") == os.path.join(workdir, "native", "coordinator",
                                                 "edl-coordinator"),
            f"deploy: the coordinator pod {pods[coord_pod]}, native child {co}, edl-launch "
            f"{drive['edl_launch']}: want edl-launch from the staged tree and its binary")
    started = pods[trainer_pod]["started"]
    first_step = launched["first_step_at"] - started
    require(0 < first_step < DEPLOY_TIMEOUT,
            f"deploy: the trainer's first step {first_step} s after its pod's process started")
    out = {"base": staged["from"], "entrypoint": staged["entrypoint"], "cmd": staged["cmd"],
           "bake": [{"run": s["run"], "seconds": s["seconds"]} for s in staged["steps"]],
           "overrides": drive["overrides"], "workloads": drive["workloads"],
           "pod_start_to_first_step_s": first_step,
           "pod_start_to_library_mapped_s": tr["library_mapped"] - started,
           "submit_to_trainer_start_s": started - drive["t_submit"],
           "submit_to_succeeded_s": drive["submit_to_succeeded_s"],
           "steps": metrics["steps"], "final_loss": metrics["final_loss"],
           "launches": launches, "variant_launches": [[*k, n] for k, n in variants.items()],
           "trainer_seconds": metrics.get("seconds"), "want_steps": want_steps,
           "coordinator_cmdlines": pods[coord_pod]["cmdlines"],
           "library": os.path.basename(library), "libcuda": tr["libcuda"],
           "unchanged": sorted(after["kernels"]) + ["edl-coordinator"],
           "seconds": time.perf_counter() - t0}
    print(f"deploy: {drive['job']} Succeeded {out['submit_to_succeeded_s']:.1f} s after its "
          f"submit from the staged tree: the coordinator through edl-launch "
          f"({pods[coord_pod]['cmdlines']}), the trainer `{spec.trainer.entrypoint}` "
          f"{out['steps']:.0f} steps, loss {out['final_loss']}, flash launches {launches}; "
          f"its first step's loss back {first_step:.2f} s after its pod's process started "
          f"(the baked library mapped at {out['pod_start_to_library_mapped_s']:.2f} s, "
          f"polled); no pod compiled ({', '.join(out['unchanged'])} unchanged); the "
          f"drive took {out['seconds']:.1f} s")
    return out


# -- phases 12-16 at once --------------------------------------------------------

#: phases 12-16 drive processes of their own (ranks, launchers, entries, pods),
#: whose start-ups take most of their time while the card idles: each group
#: runs in a process of its own (`phases_main`), every group at once, its
#: phases in order; the elastic phase is cut in two (`elastic_local`, part
#: (c)) to even the groups out. The controller and chaos phases run after
#: them, each alone: the controller's regrow must come while lm-grow's
#: queue lasts, and chaos's faults gate on heartbeats timed to the second
PHASE_GROUPS = (("elastic_mp", "dp"), ("elastic_local", "mp"), ("entries", "deploy"))
#: the seconds the groups may take together before the script stops them
PHASE_GROUPS_TIMEOUT = 720
#: name -> the phase, called with the device and the group's job
GROUP_PHASES = {
    "dp": lambda device, job: phase_dp(device),
    "elastic_local": lambda device, job: elastic_local(device),
    "elastic_mp": lambda device, job: elastic_mp(device),
    "mp": lambda device, job: phase_mp(device),
    "entries": lambda device, job: phase_entries(job["profiler"]),
    "deploy": lambda device, job: phase_deploy(job["deploy_stage"]),
}


def phases_main(job_path: str) -> int:
    """One group of `PHASE_GROUPS` (``chip_smoke.py --phases JOB``): its
    phases in order on the job's device, TF32 off as phase 1 leaves it; each
    phase's record and seconds written to the job's ``out``."""
    import torch

    with open(job_path) as f:
        job = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device, seconds, records = torch.device(job["device"]), {}, {}
    for name in job["phases"]:
        records[name] = timed(seconds, name, GROUP_PHASES[name], device, job)
    with open(job["out"], "w") as f:
        json.dump({"records": records, "seconds": seconds}, f)
    return 0


def run_phase_groups(device, seconds: dict, profiler: dict,
                     groups=PHASE_GROUPS, timeout: float = PHASE_GROUPS_TIMEOUT,
                     deploy_stage: dict | None = None) -> dict:
    """Every group of ``groups`` at once, each in a process of its own,
    given ``profiler`` and the tree `stage_deploy` staged; returns each
    phase's record by name and adds its seconds to ``seconds``. A group's standard output is printed whole once it has
    ended, so that the groups' lines do not interleave. A group that fails,
    or that is still running ``timeout`` seconds after the start, fails the
    run once every group has ended or been stopped."""
    import os

    from edl_tpu_torch.coordinator.server import ensure_built

    ensure_built()  # once here, so that no two groups' first `make` race
    sys.stdout.flush()
    records, failed = {}, []
    with tempfile.TemporaryDirectory(prefix="edl-groups-") as root:
        started = []
        for i, names in enumerate(groups):
            job = os.path.join(root, f"group{i}.json")
            with open(job, "w") as f:
                json.dump({"phases": list(names), "device": str(device), "profiler": profiler,
                           "deploy_stage": deploy_stage, "out": f"{job}.out"}, f)
            log = open(f"{job}.log", "w+")
            started.append((names, job, log, subprocess.Popen(
                [sys.executable, __file__, "--phases", job], stdout=log)))
        deadline = time.monotonic() + timeout
        for names, job, log, proc in started:
            try:
                code = proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                code = f"stopped after {timeout} s"
            with log:
                log.seek(0)
                sys.stdout.write(log.read())
            sys.stdout.flush()
            if code != 0:
                failed.append(f"{' + '.join(names)}: exit {code}")
                continue
            with open(f"{job}.out") as f:
                done = json.load(f)
            records.update(done["records"])
            seconds.update(done["seconds"])
    require(not failed, f"phase groups failed: {'; '.join(failed)}")
    return records


def main(argv) -> int:
    if "--dp-rank" in argv:  # one rank of the dp phase's part (b)
        i = argv.index("--dp-rank")
        return dp_rank_main(argv[i + 2], int(argv[i + 1]))
    if "--mp-rank" in argv:  # one rank of the mp phase
        i = argv.index("--mp-rank")
        return mp_rank_main(argv[i + 2], int(argv[i + 1]))
    if argv and argv[0] == "--el-mp-entry":  # one rank of the elastic phase's part (c)
        return el_mp_entry_main(argv[1:])
    if argv and argv[0] == "--entry-record":  # one entry of the entries phase's part (a)
        return entry_record_main(argv[1:])
    if argv and argv[0] == "--ctl-entry":  # one trainer of the controller phase
        return ctl_entry_main(argv[1:])
    if argv and argv[0] == "--deploy-drive":  # the deploy phase's job, in the image's tree
        return deploy_drive_main(argv[1])
    if argv and argv[0] == "--turns":  # the f32 forward of a checkout, timed
        return turns_main(argv[1])
    adopt_orphans()
    try:
        if argv and argv[0] == "--phases":  # one group of phases 12-16
            return phases_main(argv[1])
        return run(argv)
    finally:
        stop_descendants()


#: ``PR_SET_CHILD_SUBREAPER`` of ``<linux/prctl.h>``
PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> None:
    """Make this process the reaper of its orphaned descendants, so that
    none passes to the machine's init, where it would go on dying, or stay
    a zombie, after the script has exited. `stop_descendants` ends them."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    require(libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) == 0,
            f"prctl(PR_SET_CHILD_SUBREAPER) failed: errno {ctypes.get_errno()}")


def _children() -> dict:
    """This process's children, from ``/proc``: pid -> (state, command)."""
    import os

    me, kids = os.getpid(), {}
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
            if int(fields[1]) != me:
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue  # exited while we looked
        kids[int(pid)] = (fields[0], cmd)
    return kids


def stop_descendants(timeout: float = 60.0) -> list:
    """SIGKILL and reap every child still alive, and reap the zombies of
    those that ended, until no child is left: a killed child's own children
    come to this process (`adopt_orphans`) and go in the next round. Prints
    on standard error the command of each it found alive, and returns them."""
    import os
    import signal

    alive = []
    deadline = time.monotonic() + timeout
    while kids := _children():
        for pid, (state, cmd) in kids.items():
            if state != "Z":
                alive.append(cmd or str(pid))
                with contextlib.suppress(ProcessLookupError):
                    os.kill(pid, signal.SIGKILL)
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, 0)
        if time.monotonic() > deadline:
            print(f"chip_smoke: children {sorted(_children())} outlived {timeout} s of "
                  "stopping", file=sys.stderr)
            break
    for cmd in alive:
        print(f"chip_smoke: stopped a process left running: {cmd[:300]}", file=sys.stderr)
    return alive


def run(argv) -> int:
    """Every phase, or those that ``argv``'s flag names (the docstring)."""
    import os

    t0, seconds = time.perf_counter(), {}
    device = phase_device()
    if "--deploy" in argv:  # the deploy phase only: it bakes the kernels of its own tree
        with tempfile.TemporaryDirectory(prefix="edl-deploy-") as root:
            staged = timed(seconds, "deploy_stage", stage_deploy, os.path.realpath(root))
            deploy = timed(seconds, "deploy", phase_deploy, staged)
        print(json.dumps({"deploy": deploy}))
        print(json.dumps({"phase_seconds": {**seconds, "script": time.perf_counter() - t0}}))
        return 0
    build = timed(seconds, "build", phase_build)
    table_out = argv[argv.index("--tile-table") + 1] if "--tile-table" in argv else None
    rows, checks = timed(seconds, "kernels", phase_kernels, device, table_out)
    timed(seconds, "sass", check_sass, build)  # counted while phase 3 ran
    fa = _flash_module()
    import torch

    for row in rows:
        f32 = row["dtype"] == "float32"
        i = list(KERNELS).index(row["name"])
        dp = fa.padded_head_dim(row["head_dim"])
        if dp > 256:
            fn = (FLASH_F32_SLICED_NAMES if f32 else FLASH_SLICED_NAMES)[i]
        else:
            fn = FLASH_F32_NAMES[i] if f32 else DESIGNS[row["name"]][0]
        label = _label(row["dtype"], dp, row["block_k"])
        row["sass"] = build["sass"][fn].get(label)
        row["ptxas"] = build["ptxas"].get(f"{fn} {label}")
    checks["build_seconds"] = build["seconds"]
    # the rows of the D-64 bf16 kernels at the slice's shape, the forward at
    # the tile the slice's LM resolves, which every model phase but the wide
    # LMs' runs; kernels maps each kernel to its row
    slice_bk = fa.resolve_blocks(SLICE["seq_len"], SLICE["d_model"] // SLICE["n_heads"],
                                 torch.bfloat16)[1]
    kernels = {r["name"]: r for r in rows if r["timed_at"] == "slice" and r["block_k"] in
               (None, slice_bk)}

    #: the wide LMs' phases: name -> the padded head dim of their kernels
    wide_dp = {"lm_d128": 128, "lm_d256": 256, "lm_d512": 512}

    def emit(main_variants, in_step=None, wide=None) -> None:
        """Each row's launches on the main path (a call each, by variant) and
        in-step ms, then the kernels line and the phase 3 records. ``wide``
        maps a wide LM phase's name to its record."""
        wide = wide or {}
        for row in rows:
            dp = fa.padded_head_dim(row["head_dim"])
            key = (row["name"], row["dtype"], dp, row["block_k"])
            row["launches"] = main_variants.get(key, 0)
            lm_name = next((n for n in wide if wide_dp[n] == dp), None)
            if lm_name is not None and row["dtype"] == "bfloat16":
                row[f"launches_{lm_name}"] = row["launches"]
                if row["launches"] and row["timed_at"] == lm_name:
                    row["in_step_ms"] = wide[lm_name]["in_step_ms"].get(row["name"])
            elif in_step is not None and row in kernels.values():
                row["in_step_ms"] = in_step.get(row["name"])
        print(json.dumps({"kernels": rows}))
        print(json.dumps({"kernel_checks": checks}))
        print(json.dumps({"phase_seconds": {**seconds, "script": time.perf_counter() - t0}}))

    def variants_of(launches: dict) -> dict:
        """The slice's variants' launches from per-kernel counts."""
        return {(name, "bfloat16", 64, slice_bk if name == "fwd" else None): n
                for name, n in launches.items()}

    def wide_variants(name: str, lm: dict) -> dict:
        """A wide LM phase's calls by kernel row."""
        return {(k, "bfloat16", wide_dp[name], lm["block_k"] if k == "fwd" else None): n
                for k, n in lm["launches"].items()}

    if "--kernels" in argv:
        emit({})
        return 0
    for name, phase in (("lm_d128", phase_lm_d128), ("lm_d256", phase_lm_d256),
                        ("lm_d512", phase_lm_d512)):
        if "--" + name.replace("_", "-") in argv:  # the kernels and this phase only
            lm = timed(seconds, name, phase, device)
            emit(wide_variants(name, lm), wide={name: lm})
            print(json.dumps({name: lm}))
            return 0
    if "--mp" in argv:  # the kernels and the mp phase only
        mp = timed(seconds, "mp", phase_mp, device)
        for name, row in kernels.items():
            row["launches_mp"] = mp["launches"][name]
        emit(variants_of(mp["launches"]))
        print(json.dumps({"mp": mp}))
        return 0
    if "--entries" in argv:  # the kernels, phase 4's LM (part (c)) and the entries phase
        launches, _, lm, lm_state = timed(seconds, "slice", phase_slice, device)
        del lm_state
        entries = timed(seconds, "entries", phase_entries, lm["profiler"])
        emit(variants_of(launches))
        print(json.dumps({"entries": entries}))
        return 0
    if "--controller" in argv:  # the kernels and the controller phase only
        controller = timed(seconds, "controller", phase_controller)
        for name, row in kernels.items():
            row["launches_controller"] = controller["launches"][name]
        emit(variants_of(controller["launches"]))
        print(json.dumps({"controller": controller}))
        return 0
    if "--chaos" in argv:  # the kernels and the chaos phase only
        chaos = timed(seconds, "chaos", phase_chaos, device)
        for name, row in kernels.items():
            row["launches_chaos"] = chaos["launches"][name]
        emit(variants_of(chaos["launches"]))
        print(json.dumps({"chaos": chaos}))
        return 0
    if "--elastic" in argv:  # the kernels and the elastic phase only
        elastic = timed(seconds, "elastic", phase_elastic, device)
        for name, row in kernels.items():
            row["launches_elastic"] = elastic["launches"][name]
        emit(variants_of(elastic["launches"]))
        print(json.dumps({"elastic": elastic}))
        return 0
    with tempfile.TemporaryDirectory(prefix="edl-serve-") as serve_root:
        launches, in_step, lm, lm_state = timed(seconds, "slice", phase_slice, device)
        # exported as its run ends, as a trainer publishes; the state is then
        # freed, so the later phases' peak memory does not hold it
        lm_export = export_lm(lm_state, serve_root)
        del lm_state
        moe = timed(seconds, "moe", phase_moe, device, lm)
        timed(seconds, "step_parity", phase_step_parity, device)
        lm_d128 = timed(seconds, "lm_d128", phase_lm_d128, device)
        lm_d256 = timed(seconds, "lm_d256", phase_lm_d256, device)
        lm_d512 = timed(seconds, "lm_d512", phase_lm_d512, device)
        ctr_row, ctr_run = timed(seconds, "ctr", phase_ctr, device)
        ctr_staged = stage_ctr_versions(ctr_run, serve_root)
        del ctr_run
        ctr_row["cpu_parity"] = timed(seconds, "ctr_cpu_parity", phase_ctr_cpu_parity, device)
        data_path = timed(seconds, "data_path", phase_data_path, device, ctr_row)
        others = timed(seconds, "zoo", phase_zoo, device)
        remat = timed(seconds, "remat", phase_remat, device, lm)
        serve = timed(seconds, "serve", phase_serve, device, lm_export, ctr_staged)
    # the deploy phase's bake runs alone, its job in a group; /proc/<pid>/maps
    # names the library by its real path
    with tempfile.TemporaryDirectory(prefix="edl-deploy-") as deploy_root:
        staged = timed(seconds, "deploy_stage", stage_deploy, os.path.realpath(deploy_root))
        grouped = timed(seconds, "groups", run_phase_groups, device, seconds, lm["profiler"],
                        deploy_stage=staged)
    dp, mp, entries = grouped["dp"], grouped["mp"], grouped["entries"]
    elastic = elastic_record(grouped["elastic_local"], grouped["elastic_mp"])
    controller = timed(seconds, "controller", phase_controller)
    chaos = timed(seconds, "chaos", phase_chaos, device)
    deploy = grouped["deploy"]
    deploy_variants = {tuple(v[:4]): v[4] for v in deploy["variant_launches"]}
    for row in rows:
        key = (row["name"], row["dtype"], fa.padded_head_dim(row["head_dim"]), row["block_k"])
        if key in deploy_variants:
            row["launches_deploy"] = deploy_variants[key]
    for name, row in kernels.items():
        row["launches_remat"] = remat["launches"][name]
        row["launches_serve"] = serve["lm"]["flash_launches"][name]
        row["launches_data_path"] = data_path["grad_accum"]["launches"][name]
        row["launches_moe"] = moe["launches"][name]
        row["launches_dp"] = dp["launches"][name]
        row["launches_elastic"] = elastic["launches"][name]
        row["launches_mp"] = mp["launches"][name]
        row["launches_controller"] = controller["launches"][name]
        row["launches_chaos"] = chaos["launches"][name]
    emit({**variants_of(launches), **wide_variants("lm_d128", lm_d128),
          **wide_variants("lm_d256", lm_d256), **wide_variants("lm_d512", lm_d512),
          **deploy_variants}, in_step,
         {"lm_d128": lm_d128, "lm_d256": lm_d256, "lm_d512": lm_d512})
    print(json.dumps({"zoo": [ctr_row, *others, lm, remat]}))
    print(json.dumps({"lm_d128": lm_d128}))
    print(json.dumps({"lm_d256": lm_d256}))
    print(json.dumps({"lm_d512": lm_d512}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"data_path": data_path}))
    print(json.dumps({"moe": moe}))
    print(json.dumps({"dp": dp}))
    print(json.dumps({"elastic": elastic}))
    print(json.dumps({"mp": mp}))
    print(json.dumps({"entries": entries}))
    print(json.dumps({"deploy": deploy}))
    print(json.dumps({"controller": controller}))
    print(json.dumps({"chaos": chaos}))
    # count: the devices this run uses
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
