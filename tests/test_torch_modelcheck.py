"""Tests for the port's EDL009/EDL010 protocol model checker
(`edl_tpu_torch.analysis.modelcheck`, a copy of the JAX package's with its
imports rewritten), run over the port's `InProcessCoordinator`: the cases
of `tests/test_modelcheck.py` with the JAX run's explored and pinned trace
counts, and the two checkers side by side (the same explored space a
schedule, the same seeded mutants caught).

Layers:

- the acceptance configuration: exhaustive DFS over the default 2-worker
  faulty schedule (crash+restart, duplicate acquire, duplicate kv_incr, a
  batch frame) is green, every trace replayed against InProcessCoordinator;
- the EDL010 durability lanes: crash points enumerated between persistence
  effects (clean / pre-ack / torn tail / during compaction) with recovery
  replay, checked against the file-backed persistence twin — and the
  sleep-set POR's soundness (reduced exploration reaches the same
  violation set as unreduced);
- teeth: a deliberately mutated twin (request dedup disabled via the
  test-only ``_test_disable_dedup`` flag) is caught, through both the
  model/oracle divergence and the exactly-once monitor; a twin that skips
  torn-tail detection (``skip_tail_scan``) replays partial frames and is
  caught by the acked-durability invariant;
- the fuzz mode's soundness contract: any violation the seeded random walk
  reports is also reported by the exhaustive run at the same depth;
- parked-op handling: barrier/sync release and bounded-progress deadlock
  detection;
- the --dump-trace / --replay-trace round trip on a violating
  interleaving.
"""

import json
import time
from pathlib import Path

import pytest

from edl_tpu_torch.analysis.modelcheck import (
    LAST_TASK,
    DurableTwinOracle,
    ModelCheckError,
    ProtocolModel,
    Schedule,
    ScriptOp,
    default_scripts,
    dump_trace_spec,
    durability_base_scripts,
    durability_dedup_scripts,
    durability_schedules,
    durability_torn_scripts,
    explore,
    load_state_effects,
    main as modelcheck_main,
    replay_trace_spec,
    run_default,
)

mk = ScriptOp.make

REPO_ROOT = str(Path(__file__).resolve().parents[1])


def _mutant_factory():
    """The deliberately broken twin: replay dedup disabled. Duplicate
    acquire req_ids hand out a second task; duplicate kv_incr op_ids
    double-apply."""
    from edl_tpu_torch.coordinator.inprocess import InProcessCoordinator

    c = InProcessCoordinator(task_lease_sec=1e9, heartbeat_ttl_sec=1e9)
    c._test_disable_dedup = True
    return c


def _effects():
    effects, ops, err = load_state_effects(REPO_ROOT)
    assert err is None, err
    return effects


# -- the acceptance configuration ----------------------------------------------


def test_default_exhaustive_is_green_and_fully_replayed():
    """2 workers, 13 ops incl. batch, crash+restart, two duplicate
    deliveries: every interleaving model-checked AND oracle-replayed,
    zero violations, comfortably under the 60 s budget."""
    t0 = time.monotonic()
    result = run_default()
    elapsed = time.monotonic() - t0
    assert result.violations == []
    # C(13, 6) interleavings of the default scripts + C(8, 4) of the
    # checkpoint-plane schedule + C(11, 3) watch/notify + the preempt
    # notice/watch/leave lane + C(10, 4) redirect-during-watch + the
    # EDL010 durability rows (POR-reduced except durability-compact,
    # which runs unreduced at C(13, 6)):
    # 118 + 50 + 28 + 1716 + 21 + 196 + 38 = 2167. run_default merges
    # all twelve.
    assert result.traces == 1716 + 70 + 165 + 210 + 210 + 2167
    assert result.replays == result.traces
    assert result.ok()
    assert elapsed < 90.0


def test_default_scripts_meet_the_bounded_config_contract():
    scripts = default_scripts()
    assert set(scripts) == {"w0", "w1"}
    ops = [op.op for s in scripts.values() for op in s]
    assert len(ops) >= 6 and "batch" in ops
    notes = [op.note for s in scripts.values() for op in s]
    assert "restart" in notes  # crash+restart
    assert notes.count("dup") == 2  # duplicate deliveries


def test_state_effects_cover_the_full_op_set():
    effects, ops, err = load_state_effects(REPO_ROOT)
    assert err is None
    assert set(effects) == ops
    assert len(ops) >= 22


def test_every_op_carries_a_valid_durability_tag():
    """The EDL010 ratchet, pinned to the repo schema: every op in the
    dispatch table declares what it persists, with a well-formed tag —
    and the journaled core is tagged as such."""
    from edl_tpu_torch.analysis.checkers.durability import validate_durability_tag

    effects, ops, err = load_state_effects(REPO_ROOT)
    assert err is None
    assert len(ops) >= 22
    for op in sorted(ops):
        tag = (effects.get(op) or {}).get("durability")
        assert validate_durability_tag(tag) is None, (
            f"op {op!r}: bad durability tag {tag!r}")
    assert effects["acquire_task"]["durability"] == "journal:lease"
    assert effects["kv_incr"]["durability"] == "journal:kv"
    assert effects["register"]["durability"] == "journal:meta,lease"
    assert effects["shard_put"]["durability"] == "volatile"  # unjournaled


# -- teeth: the mutated twin ----------------------------------------------------


def test_mutant_twin_with_dedup_disabled_is_caught():
    result = run_default(coordinator_factory=_mutant_factory,
                         max_violations=10)
    assert result.violations, "mutant twin must not pass"
    kinds = {v.kind for v in result.violations}
    # the duplicate acquire shows up both as a model/oracle reply
    # divergence and as a second grant for the same req_id
    assert kinds & {"oracle-divergence", "exactly-once"}


def test_mutant_violation_messages_name_the_replayed_request():
    result = run_default(coordinator_factory=_mutant_factory,
                         max_violations=50)
    blob = " ".join(v.message for v in result.violations)
    assert "w0-a1" in blob or "w1-i1" in blob or "duplicate" in blob


# -- fuzz mode ------------------------------------------------------------------


def test_fuzz_on_green_twin_stays_green():
    result = run_default(fuzz_samples=40, fuzz_seed=7)
    assert result.violations == []
    # 40 samples per schedule (5 legacy + 7 durability rows), identical
    # ones dedup
    assert 0 < result.traces <= 480
    assert result.replays == result.traces


def test_fuzz_findings_are_subset_of_exhaustive_at_equal_depth():
    """The soundness contract of --fuzz: same per-trace checking, sampled
    schedule set — so on the mutant twin every fuzz violation key appears
    in the exhaustive run's violation set."""
    exhaustive = run_default(coordinator_factory=_mutant_factory,
                             max_violations=10 ** 6)
    fuzz = run_default(coordinator_factory=_mutant_factory,
                       fuzz_samples=30, fuzz_seed=3,
                       max_violations=10 ** 6)
    assert fuzz.violations, "fuzz must hit the planted bug at this budget"
    assert fuzz.violation_keys() <= exhaustive.violation_keys()
    assert len(exhaustive.violation_keys()) > len(fuzz.violation_keys())


def test_fuzz_is_deterministic_per_seed():
    a = run_default(fuzz_samples=25, fuzz_seed=11)
    b = run_default(fuzz_samples=25, fuzz_seed=11)
    assert a.traces == b.traces
    assert a.violation_keys() == b.violation_keys()


# -- EDL010: crash-point durability schedules -----------------------------------


def test_durability_schedules_green_with_pinned_trace_counts():
    """Each durability lane explored in isolation, every trace replayed
    against the file-backed persistence twin — per-schedule trace counts
    pinned so a schedule silently shrinking (lost crash points) fails."""
    result = run_default(schedules=[s.name for s in durability_schedules()])
    assert result.violations == []
    assert result.replays == result.traces
    counts = {name: traces for name, traces, _s in result.timings}
    assert counts == {
        "durability-base": 118,           # clean crash, POR-reduced
        "durability-dedup": 50,           # pre_ack + straddling dups
        "durability-torn": 28,            # torn tail, all-or-nothing
        "durability-compact": 1716,       # snapshot path, unreduced C(13,6)
        "durability-crash-compact": 21,   # crash inside snapshot write
        "durability-shard": 196,          # unjournaled shard-store honesty
        "durability-preempt": 38,         # volatile notices forgotten by crash
    }
    assert sum(counts.values()) == 2167


def test_schedule_name_filter_rejects_unknown_names():
    with pytest.raises(ModelCheckError, match="unknown schedule"):
        run_default(schedules=["durability-base", "no-such-lane"])


def test_nonclean_crash_with_compaction_is_a_spec_error():
    """torn / pre_ack / during_compaction crash points assume the inflight
    frame is the journal tail; under an active compaction threshold the
    tail may be a snapshot instead, so the combination is rejected up
    front rather than modeled wrong."""
    mk2 = ScriptOp.make
    scripts = {"w0": [mk2("register", worker="w0"),
                      mk2("crash", mode="torn", worker="w0",
                          inflight=[{"op": "kv_put", "key": "k",
                                     "value": "v"}])]}
    with pytest.raises(ModelCheckError):
        explore(scripts, _effects(),
                coordinator_factory=lambda: DurableTwinOracle(compact_every=4),
                durable=True, compact_every=4)


def test_por_soundness_reduced_equals_unreduced_on_green_twin():
    """Sleep-set POR prunes interleavings that only reorder independent
    ops; on the green twin both runs must be empty AND the reduction must
    actually reduce."""
    full = explore(durability_base_scripts(), _effects(),
                   coordinator_factory=lambda: DurableTwinOracle(),
                   durable=True, por=False)
    reduced = explore(durability_base_scripts(), _effects(),
                      coordinator_factory=lambda: DurableTwinOracle(),
                      durable=True, por=True)
    assert full.violations == [] and reduced.violations == []
    assert reduced.traces == 118
    assert reduced.traces < full.traces


def test_por_soundness_reduced_catches_what_unreduced_catches():
    """On the dedup-disabled mutant the reduced exploration must reach
    the same violation KINDS as the unreduced one, and every reduced
    violation key must exist in the unreduced set (POR may drop redundant
    witnesses, never bug classes)."""
    mutant = lambda: DurableTwinOracle(disable_dedup=True)  # noqa: E731
    full = explore(durability_dedup_scripts(), _effects(),
                   coordinator_factory=mutant, durable=True, por=False,
                   max_violations=10 ** 6)
    reduced = explore(durability_dedup_scripts(), _effects(),
                      coordinator_factory=mutant, durable=True, por=True,
                      max_violations=10 ** 6)
    assert reduced.violations, "POR must not hide the planted bug"
    assert reduced.violation_keys() <= full.violation_keys()
    assert ({v.kind for v in reduced.violations}
            == {v.kind for v in full.violations})


def test_torn_tail_mutant_skip_tail_scan_is_caught():
    """The mutant-teeth scenario: a twin whose recovery skips torn-tail
    frame detection replays the half-written kv_incr value record without
    its op_id marker — the post-crash retry double-applies, caught as an
    acked-durability divergence (and/or exactly-once)."""
    mutant = lambda: DurableTwinOracle(skip_tail_scan=True)  # noqa: E731
    result = explore(durability_torn_scripts(), _effects(),
                     coordinator_factory=mutant, durable=True, por=True,
                     max_violations=100)
    assert result.violations, "torn-tail-blind twin must not pass"
    kinds = {v.kind for v in result.violations}
    assert kinds & {"acked-durability", "exactly-once"}


def test_dedup_mutant_is_caught_across_the_crash():
    """Replay dedup disabled: the duplicate acquire AFTER recovery hands
    out a second grant for the same req_id — exactly-once must hold
    across the crash, not merely within one incarnation."""
    mutant = lambda: DurableTwinOracle(disable_dedup=True)  # noqa: E731
    result = explore(durability_dedup_scripts(), _effects(),
                     coordinator_factory=mutant, durable=True, por=True,
                     max_violations=100)
    assert result.violations
    assert {v.kind for v in result.violations} & {
        "acked-durability", "exactly-once", "oracle-divergence"}


def test_fuzz_with_durability_schedules_is_deterministic():
    a = run_default(schedules=["durability-base", "durability-torn"],
                    fuzz_samples=20, fuzz_seed=13)
    b = run_default(schedules=["durability-base", "durability-torn"],
                    fuzz_samples=20, fuzz_seed=13)
    assert a.violations == [] and b.violations == []
    assert a.traces == b.traces > 0
    assert ([(n, tr) for n, tr, _s in a.timings]
            == [(n, tr) for n, tr, _s in b.timings])
    assert a.violation_keys() == b.violation_keys()


# -- trace spec round trip (--dump-trace / --replay-trace) ----------------------


def test_dump_and_replay_trace_spec_roundtrip():
    """A violating interleaving dumped as a JSON spec re-executes in
    isolation — exact step order, no exploration — and reproduces the
    violation on the same mutant."""
    mutant = lambda: DurableTwinOracle(skip_tail_scan=True)  # noqa: E731
    sched = Schedule("durability-torn", durability_torn_scripts(), mutant,
                     durable=True, por=True)
    result = explore(sched.scripts, _effects(), coordinator_factory=mutant,
                     durable=True, por=True, max_violations=10,
                     name="durability-torn")
    assert result.violations
    spec = dump_trace_spec(result.violations[0], schedules=[sched])
    spec = json.loads(json.dumps(spec))  # must survive JSON round trip
    assert spec["schedule"] == "durability-torn"
    assert spec["durable"] is True
    assert spec["order"], "dumped spec must carry the worker step order"
    repro = replay_trace_spec(spec, _effects(), coordinator_factory=mutant)
    assert repro, "dumped interleaving must reproduce on the mutant"
    assert {v.kind for v in repro} & {"acked-durability", "exactly-once"}


def test_replayed_spec_is_green_on_the_fixed_twin():
    """The same dumped interleaving replayed against the HEALTHY twin
    (the spec's default factory) passes — the bug is in the mutant, not
    the schedule."""
    mutant = lambda: DurableTwinOracle(skip_tail_scan=True)  # noqa: E731
    sched = Schedule("durability-torn", durability_torn_scripts(), mutant,
                     durable=True, por=True)
    result = explore(sched.scripts, _effects(), coordinator_factory=mutant,
                     durable=True, por=True, max_violations=10,
                     name="durability-torn")
    spec = dump_trace_spec(result.violations[0], schedules=[sched])
    assert replay_trace_spec(spec, _effects()) == []


def test_cli_schedules_filter_and_timings(capsys):
    rc = modelcheck_main(["--schedules", "durability-torn", "--timings"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "28 trace(s)" in out and "0 violation(s)" in out
    assert "durability-torn:" in out


# -- parked ops: barrier / sync -------------------------------------------------


def _barrier_scripts(count):
    return {
        "w0": [mk("register", worker="w0"),
               mk("barrier", name="b", count=count, worker="w0")],
        "w1": [mk("register", worker="w1"),
               mk("barrier", name="b", count=count, worker="w1")],
    }


def test_barrier_release_explored_and_green():
    result = explore(_barrier_scripts(count=2), _effects())
    assert result.traces == 6  # C(4, 2) interleavings
    assert result.violations == []
    assert result.replays == result.traces


def test_unsatisfiable_barrier_is_a_progress_violation():
    """count=3 with two workers: every complete interleaving deadlocks, and
    the model reports it WITHOUT replaying (replay would hang)."""
    result = explore(_barrier_scripts(count=3), _effects())
    assert result.traces == 6
    assert result.violations
    assert {v.kind for v in result.violations} == {"progress"}
    assert result.replays == 0


def test_sync_parking_detects_the_stranded_worker():
    """sync(epoch=2) issued before the second register gets an immediate
    resync and drains; interleavings where it parks after both registers
    but the peer already drained deadlock — the checker must see exactly
    those."""
    scripts = {
        "w0": [mk("register", worker="w0"),
               mk("sync", epoch=2, worker="w0")],
        "w1": [mk("register", worker="w1"),
               mk("sync", epoch=2, worker="w1")],
    }
    result = explore(scripts, _effects())
    assert result.traces == 6
    deadlocks = [v for v in result.violations if v.kind == "progress"]
    assert len(deadlocks) == 2
    assert len(result.violations) == 2  # nothing besides the deadlocks


# -- model plumbing -------------------------------------------------------------


def test_scriptop_make_freezes_nested_fields():
    op = mk("batch", ops=[{"op": "ping"}], worker="w0")
    assert isinstance(op.fields, tuple)
    d = op.field_dict()
    assert d["ops"] == [{"op": "ping"}]
    assert hash(op) is not None  # frozen dataclass stays hashable


def test_unknown_effect_tag_is_a_spec_error_not_a_violation():
    effects = dict(_effects())
    effects["ping"] = {"quantum": "entangle"}
    with pytest.raises(ModelCheckError):
        ProtocolModel(effects)


def test_load_state_effects_reports_missing_block(tmp_path):
    (tmp_path / "protocol_schema.json").write_text(
        json.dumps({"ops": {"ping": {}}})
    )
    effects, ops, err = load_state_effects(str(tmp_path))
    assert effects is None
    assert ops == {"ping"}
    assert "state_effects" in err


def test_load_state_effects_reports_missing_file(tmp_path):
    effects, ops, err = load_state_effects(str(tmp_path))
    assert effects is None and ops is None
    assert "missing" in err


# -- CLI ------------------------------------------------------------------------


def test_cli_exhaustive_exits_zero(capsys):
    rc = modelcheck_main([])
    out = capsys.readouterr().out
    assert rc == 0
    assert "4538 trace(s)" in out and "0 violation(s)" in out


def test_cli_json_fuzz(capsys):
    rc = modelcheck_main(["--fuzz", "10", "--seed", "5", "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert payload["violations"] == []
    assert payload["replays"] == payload["traces"] > 0


# -- native crash-injected oracle (make modelcheck-native's lane) ---------------


@pytest.mark.sanitizer
def test_native_oracle_replays_torn_tail_lane():
    """One full durability lane against the REAL binary: each trace boots
    an edl-coordinator armed to _exit(2) at the modeled crash point (torn
    mode rewinds the journal tail first), then restarts it and checks
    recovery against the model. Small lane (28 traces) so the per-trace
    server boots stay inside the tier-1 budget."""
    from tests.test_torch_coordinator import has_toolchain

    if not has_toolchain():
        pytest.skip("native toolchain unavailable")
    result = run_default(schedules=["durability-torn"], native=True)
    assert result.violations == []
    assert result.traces == 28
    assert result.replays == 28


# -- the two packages side by side --------------------------------------------------

SCHEDULES = ["default", "ckpt-plane", "watch", "preempt", "watch-redirect",
             "durability-base", "durability-dedup", "durability-torn",
             "durability-compact", "durability-crash-compact", "durability-shard",
             "durability-preempt"]


def test_the_schedule_set_is_the_jax_packages():
    from edl_tpu.analysis import modelcheck as jax_mc
    from edl_tpu_torch.analysis import modelcheck as port_mc

    assert [s.name for s in port_mc.default_schedules()] == SCHEDULES
    assert [s.name for s in jax_mc.default_schedules()] == SCHEDULES


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_both_checkers_explore_the_same_space(schedule):
    """One schedule through the JAX checker over the JAX coordinator and the
    port's over the port's: green on both, with the same traces explored and
    replayed."""
    from edl_tpu.analysis import modelcheck as jax_mc

    port = run_default(schedules=[schedule])
    jax = jax_mc.run_default(schedules=[schedule])
    assert port.violations == [] and jax.violations == []
    assert (port.traces, port.replays) == (jax.traces, jax.replays)
    assert port.traces > 0


def _jax_dedup_mutant():
    from edl_tpu.coordinator.inprocess import InProcessCoordinator as JaxCoordinator

    c = JaxCoordinator(task_lease_sec=1e9, heartbeat_ttl_sec=1e9)
    c._test_disable_dedup = True
    return c


@pytest.mark.parametrize("mutant", ["dedup", "torn-tail", "durable-dedup"])
def test_both_checkers_catch_the_seeded_mutants(mutant):
    """The JAX suite's seeded mutants through both checkers: each is caught
    by both, with the same violation kinds."""
    from edl_tpu.analysis import modelcheck as jax_mc

    results = []
    for mc, dedup_factory in ((jax_mc, _jax_dedup_mutant),
                              (__import__("edl_tpu_torch.analysis.modelcheck",
                                          fromlist=["x"]), _mutant_factory)):
        if mutant == "dedup":
            r = mc.run_default(coordinator_factory=dedup_factory, max_violations=10)
        else:
            torn = mutant == "torn-tail"
            factory = (lambda: mc.DurableTwinOracle(skip_tail_scan=True)) if torn \
                else (lambda: mc.DurableTwinOracle(disable_dedup=True))
            scripts = mc.durability_torn_scripts() if torn else mc.durability_dedup_scripts()
            effects, _ops, err = mc.load_state_effects(REPO_ROOT)
            assert err is None, err
            r = mc.explore(scripts, effects, coordinator_factory=factory, durable=True,
                           por=True, max_violations=100)
        assert r.violations, f"{mc.__name__}: the {mutant} mutant must not pass"
        results.append(sorted({v.kind for v in r.violations}))
    assert results[0] == results[1]
