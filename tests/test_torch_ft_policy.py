"""The port's fault-tolerance policy, straggler detector and replica
placement (`edl_tpu_torch.runtime.ft_policy`, `runtime.straggler`,
`ckpt_plane.placement`) against the JAX package's.

The cases of ``tests/test_ft_policy.py`` and the policy, straggler and
placement cases of ``tests/test_preempt.py`` run on both packages (the
``P`` fixture is one package's namespace); the ``test_both_*`` cases feed
both the same inputs and require equal decisions, thresholds, verdicts and
span attributes. Everything runs in injected fake time.
"""

import importlib
import json
import time
from types import SimpleNamespace

import pytest

PACKAGES = ("jax", "torch")
ROOTS = {"jax": "edl_tpu", "torch": "edl_tpu_torch"}


def _pkg(name):
    root = ROOTS[name]

    def m(mod):
        return importlib.import_module(f"{root}.{mod}")

    ft, st = m("runtime.ft_policy"), m("runtime.straggler")
    return SimpleNamespace(
        name=name, ft=ft, FTPolicy=ft.FTPolicy, FTPolicyConfig=ft.FTPolicyConfig,
        FTPolicyInstruments=m("obs.instruments").FTPolicyInstruments,
        PreemptInstruments=m("obs.instruments").PreemptInstruments,
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        parse_prometheus=m("obs.metrics").parse_prometheus,
        Tracer=m("obs.tracing").Tracer,
        StragglerConfig=st.StragglerConfig, StragglerDetector=st.StragglerDetector,
        nearest_rank_quantile=st.nearest_rank_quantile,
        placement=m("ckpt_plane.placement"),
        InProcessCoordinator=m("coordinator.inprocess").InProcessCoordinator,
        make_epoch_watch=m("coordinator.watch").make_epoch_watch,
        OutboxClient=m("coordinator.outbox").OutboxClient,
        CoordinatorUnreachable=m("coordinator.client").CoordinatorUnreachable,
        ElasticConfig=m("runtime.elastic").ElasticConfig,
        ChaosScenario=m("testing.chaosproxy").ChaosScenario,
    )


@pytest.fixture(params=PACKAGES)
def P(request):
    return _pkg(request.param)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_policy(P, cfg=None, **kwargs):
    """Policy with isolated instruments/tracer so tests don't share the
    process registry's counters."""
    clock = kwargs.pop("clock", None) or FakeClock()
    reg = P.MetricsRegistry()
    tracer = P.Tracer(component="test")
    p = P.FTPolicy(cfg if cfg is not None else P.FTPolicyConfig(),
                   worker="wtest", instruments=P.FTPolicyInstruments(reg),
                   tracer=tracer, clock=clock)
    return p, clock, reg, tracer


# -- static escape hatch -------------------------------------------------------


def test_static_policy_reproduces_outage_budget(P):
    cfg = P.FTPolicyConfig(policy="static", outage_budget=10.0, min_history=1)
    p, clock, _, _ = make_policy(P, cfg)
    for _ in range(8):
        p.on_outage(0.1)
        p.note_outage_closed(300.0)
        clock.advance(1.0)
    assert p.threshold() == 10.0
    assert p.on_outage(9.9) == P.ft.WAIT
    assert p.on_outage(10.1) == P.ft.PARK


def test_adaptive_cold_start_defers_to_static_budget(P):
    p, _, _, _ = make_policy(P, P.FTPolicyConfig(outage_budget=60.0, min_history=3))
    p.note_outage_closed(0.5)
    p.note_outage_closed(0.4)
    assert p.threshold() == 60.0
    assert p.on_outage(59.0) == P.ft.WAIT


# -- mode transitions ----------------------------------------------------------


def test_blip_history_waits_then_reconnects_in_place(P):
    p, clock, _, _ = make_policy(P, P.FTPolicyConfig(min_history=3, min_wait=1.0))
    for _ in range(3):
        p.on_outage(0.2)
        p.note_outage_closed(0.5)
        clock.advance(60.0)
    assert p.threshold() == 1.0
    assert p.on_outage(0.6) == P.ft.WAIT
    p.note_outage_closed(0.7)
    assert p.last_mode == P.ft.RECONNECT
    assert p.decisions[P.ft.PARK] == 0


def test_storm_outage_escalates_to_park_long_before_static_budget(P):
    p, clock, _, _ = make_policy(
        P, P.FTPolicyConfig(outage_budget=60.0, min_history=3, min_wait=1.0))
    for _ in range(3):
        p.on_outage(0.2)
        p.note_outage_closed(0.5)
        clock.advance(60.0)
    t = p.threshold()
    assert t < 5.0
    assert p.on_outage(t + 0.1) == P.ft.PARK
    assert p.decisions[P.ft.PARK] == 1


def test_multihost_escalation_terminal_is_warm_restart(P):
    p, _, _, _ = make_policy(P, P.FTPolicyConfig(policy="static", outage_budget=1.0))
    assert p.on_outage(0.5, escalate_mode=P.ft.WARM_RESTART) == P.ft.WAIT
    assert p.on_outage(1.5, escalate_mode=P.ft.WARM_RESTART) == P.ft.WARM_RESTART


# -- hysteresis ----------------------------------------------------------------


def test_hysteresis_flapping_input_cannot_flap_the_mode(P):
    p, _, _, _ = make_policy(P, P.FTPolicyConfig(policy="static", outage_budget=2.0))
    assert p.on_outage(1.0) == P.ft.WAIT
    assert p.on_outage(2.5) == P.ft.PARK
    for elapsed in (0.1, 3.0, 0.0, 2.1, 1.0):
        assert p.on_outage(elapsed) == P.ft.PARK
    assert p.decisions[P.ft.PARK] == 1


def test_hysteresis_threshold_frozen_at_incident_open(P):
    p, clock, _, _ = make_policy(P, P.FTPolicyConfig(min_history=3, min_wait=1.0))
    for _ in range(3):
        p.on_outage(0.1)
        p.note_outage_closed(0.5)
        clock.advance(60.0)
    frozen = p.threshold()
    assert p.on_outage(0.2) == P.ft.WAIT
    p.note_checkpoint_cost(50.0)
    p.note_restore_cost(50.0)
    assert p.threshold() > frozen
    assert p.on_outage(frozen + 0.1) == P.ft.PARK


def test_incident_close_resets_the_ladder(P):
    p, _, _, _ = make_policy(P, P.FTPolicyConfig(policy="static", outage_budget=1.0))
    p.on_outage(0.5)
    assert p.on_outage(1.5) == P.ft.PARK
    p.note_outage_closed(2.0)
    assert not p.incident_open
    assert p.on_outage(0.5) == P.ft.WAIT


# -- cost model ----------------------------------------------------------------


def test_park_breakeven_raises_threshold_when_parking_is_expensive(P):
    cfg = P.FTPolicyConfig(min_history=1, min_wait=0.1, park_cost_factor=2.0)
    p, _, _, _ = make_policy(P, cfg)
    p.note_outage_closed(0.1)
    cheap = p.threshold()
    p.note_checkpoint_cost(3.0)
    p.note_restore_cost(2.0)
    for _ in range(10):
        p.note_step(0.5)
    assert p.restep_cost() == pytest.approx(5.0)
    assert p.park_breakeven() == pytest.approx(2.0 * (3.0 + 2.0 + 5.0))
    assert p.threshold() > cheap
    p.note_checkpoint_cost(3.0)
    assert p.restep_cost() == 0.0


def test_threshold_is_capped_by_the_static_budget(P):
    p, _, _, _ = make_policy(P, P.FTPolicyConfig(outage_budget=10.0, min_history=1))
    p.note_outage_closed(500.0)
    p.note_checkpoint_cost(500.0)
    assert p.threshold() == 10.0


def test_storm_detector_shortens_retry_deadline(P):
    cfg = P.FTPolicyConfig(min_history=3, storm_rate_per_min=6.0,
                           storm_retry_deadline=5.0)
    p, clock, _, _ = make_policy(P, cfg)
    assert p.retry_deadline() is None
    for _ in range(6):
        p.note_outage_closed(0.3)
        clock.advance(1.0)
    assert p.in_storm()
    assert p.retry_deadline() == 5.0
    q, qclock, _, _ = make_policy(P, cfg)
    for _ in range(6):
        q.note_outage_closed(0.3)
        qclock.advance(600.0)
    assert not q.in_storm()
    assert q.retry_deadline() is None


# -- observability -------------------------------------------------------------


def test_decisions_surface_as_metrics_and_spans(P):
    p, _, reg, tracer = make_policy(
        P, P.FTPolicyConfig(policy="static", outage_budget=1.0))
    p.on_outage(0.5)
    p.on_outage(1.5)
    p.note_outage_closed(2.0)
    p.on_outage(0.2)
    p.note_outage_closed(0.3)
    families = P.parse_prometheus(reg.render_prometheus())
    incidents = families["edl_ft_policy_incidents_total"]["samples"]
    assert incidents["edl_ft_policy_incidents_total"] == 2.0
    decisions = families["edl_ft_policy_decisions_total"]["samples"]
    assert decisions['edl_ft_policy_decisions_total{mode="wait"}'] == 2.0
    assert decisions['edl_ft_policy_decisions_total{mode="park"}'] == 1.0
    assert decisions['edl_ft_policy_decisions_total{mode="reconnect"}'] == 1.0
    assert "edl_ft_policy_park_threshold_seconds" in families
    events = tracer.find(name="ft_decision")
    assert len(events) == 4
    for ev in events:
        for key in ("mode", "threshold", "elapsed", "park_breakeven",
                    "failure_rate_per_min"):
            assert key in ev.attrs, ev.attrs
    assert {e.attrs["mode"] for e in events} == {P.ft.WAIT, P.ft.PARK, P.ft.RECONNECT}


def test_state_dict_is_json_ready(P):
    p, _, _, _ = make_policy(P)
    p.on_outage(0.5)
    p.note_outage_closed(1.0)
    st = json.loads(json.dumps(p.state()))
    assert st["policy"] == "adaptive"
    assert st["mode"] == P.ft.RECONNECT
    assert st["incidents"] == 1


# -- the mutant check ----------------------------------------------------------


def _run_trace(P, policy, trace, clock, park_overhead=2.0, wait_drag=0.1):
    """Replay a failure trace through a policy and price its choices (the
    JAX test's cost model); also returns every decision taken."""
    cost, log = 0.0, []
    for duration, gap in trace:
        t = 0.0
        escalated = False
        while t < duration:
            t = min(duration, t + 0.1)
            mode = policy.on_outage(t)
            log.append((round(t, 6), mode, policy.frozen_threshold))
            if mode == P.ft.PARK:
                escalated = True
                break
        if escalated:
            cost += t * wait_drag + park_overhead
        else:
            cost += duration * wait_drag
        policy.note_outage_closed(duration)
        clock.advance(gap)
    return cost, log


#: 8 blips then 3 storms — the regime change the adaptive rule exists for.
TRACE = [(0.4, 60.0)] * 8 + [(120.0, 60.0)] * 3


def test_mutant_forced_modes_measurably_underperform_adaptive(P):
    adaptive, clock_a, _, _ = make_policy(
        P, P.FTPolicyConfig(outage_budget=10.0, min_history=3, min_wait=1.0))
    cost_adaptive, _ = _run_trace(P, adaptive, TRACE, clock_a)
    forced_wait, clock_w, _, _ = make_policy(
        P, P.FTPolicyConfig(policy="static", outage_budget=1000.0))
    cost_wait, _ = _run_trace(P, forced_wait, TRACE, clock_w)
    forced_park, clock_p, _, _ = make_policy(
        P, P.FTPolicyConfig(policy="static", outage_budget=0.2))
    cost_park, _ = _run_trace(P, forced_park, TRACE, clock_p)
    assert adaptive.decisions[P.ft.PARK] == 3
    assert adaptive.decisions[P.ft.RECONNECT] == 8
    assert cost_adaptive < 0.7 * cost_wait, (cost_adaptive, cost_wait)
    assert cost_adaptive < 0.7 * cost_park, (cost_adaptive, cost_park)


# -- config validation ---------------------------------------------------------


def test_elastic_config_rejects_bad_fault_tolerance_knobs(P, tmp_path):
    ck = str(tmp_path / "ck")
    for kw, match in ((dict(outage_budget=-5.0), "outage_budget"),
                      (dict(heartbeat_interval=-1.0), "heartbeat_interval"),
                      (dict(heartbeat_jitter=1.5), "heartbeat_jitter"),
                      (dict(checkpoint_interval=0), "checkpoint_interval"),
                      (dict(pipeline_depth=-1), "pipeline_depth"),
                      (dict(rescale_barrier_timeout=0.0), "rescale_barrier_timeout"),
                      (dict(policy="yolo"), "policy"),
                      (dict(epoch_discovery="telepathy"), "epoch_discovery"),
                      (dict(peer_replicas=-1), "peer_replicas")):
        with pytest.raises(ValueError, match=match):
            P.ElasticConfig(checkpoint_dir=ck, **kw)
    P.ElasticConfig(checkpoint_dir=ck, heartbeat_interval=0.0)
    P.ElasticConfig(checkpoint_dir=ck, heartbeat_jitter=0.0)
    P.ElasticConfig(checkpoint_dir=ck, policy="static")


def test_ft_policy_config_validation(P):
    with pytest.raises(ValueError, match="policy"):
        P.FTPolicyConfig(policy="aggressive")
    with pytest.raises(ValueError, match="outage_budget"):
        P.FTPolicyConfig(outage_budget=0.0)
    with pytest.raises(ValueError, match="min_history"):
        P.FTPolicyConfig(min_history=0)
    with pytest.raises(ValueError, match="residual_quantile"):
        P.FTPolicyConfig(residual_quantile=1.5)


# -- outbox incident callback (the policy's sensor feed) -----------------------


def test_outbox_reports_per_incident_durations(P):
    class Flaky:
        worker = "wflaky"

        def __init__(self):
            self.up = True

        def call(self, op, **fields):
            if not self.up:
                raise P.CoordinatorUnreachable("down")
            return {"ok": True, "op": op}

        def heartbeat(self):
            return self.call("heartbeat")

        def register(self, takeover=False):
            return self.call("register")

        def close(self):
            pass

    raw = Flaky()
    client = P.OutboxClient(raw)
    closed = []
    client.on_outage_close = closed.append
    raw.up = False
    client.heartbeat()
    client.heartbeat()
    assert closed == []
    raw.up = True
    client.heartbeat()
    assert len(closed) == 1 and closed[0] >= 0.0
    raw.up = False
    client.complete_task("s1")
    raw.up = True
    client.heartbeat()
    assert len(closed) == 2
    assert client.outages == 2


# -- scripted scenarios (the composed-chaos conductor): tests/test_ft_policy.py ----


def test_scenario_fires_steps_in_order_with_gates(P):
    fired = []
    gate = {"open": False}
    sc = (P.ChaosScenario("unit")
          .register("a", lambda: fired.append("a"))
          .register("b", lambda tag: fired.append(f"b:{tag}"))
          .predicate("gate", lambda: gate["open"])
          .add("a")
          .add("b", when="gate", tag="x")
          .add("a", after=0.05))
    sc.start()
    time.sleep(0.1)
    assert fired == ["a"]  # step 2 is gated
    gate["open"] = True
    sc.join(timeout=5.0)
    assert sc.completed and sc.failed is None
    assert fired == ["a", "b:x", "a"]
    assert [e["action"] for e in sc.events] == ["a", "b", "a"]


def test_scenario_gate_timeout_fails_loudly(P):
    sc = (P.ChaosScenario("stuck")
          .register("never", lambda: None)
          .predicate("no", lambda: False)
          .add("never", when="no", timeout=0.1))
    sc.start()
    sc.join(timeout=5.0)
    assert not sc.completed
    assert "never opened" in sc.failed


def test_scenario_spec_round_trips_through_json(P):
    sc = (P.ChaosScenario("rt")
          .add("x.partition", when="warm", after=1.5, note="sever")
          .add("x.heal", after=2.0))
    clone = P.ChaosScenario.from_spec(sc.spec())
    assert [s.to_dict() for s in clone.steps] == [s.to_dict() for s in sc.steps]


def test_scenario_rejects_unregistered_names(P):
    sc = P.ChaosScenario("bad").add("ghost")
    with pytest.raises(ValueError, match="ghost"):
        sc.start()


# -- restore-source break-even (checkpoint plane) ------------------------------


def test_restore_source_defaults_to_peer_until_both_measured(P):
    p, _, _, _ = make_policy(P)
    assert p.restore_source() == "peer"
    p.note_restore_cost(5.0)
    assert p.restore_source() == "peer"
    p.note_peer_restore(0.2)
    assert p.restore_source() == "peer"


def test_restore_source_flips_to_blob_when_measurably_cheaper(P):
    p, _, _, _ = make_policy(P)
    p.note_peer_restore(4.0)
    p.note_restore_cost(0.5)
    assert p.restore_source() == "blob"


def test_effective_restore_cost_prices_the_cheapest_source(P):
    p, _, _, _ = make_policy(P)
    assert p.effective_restore_cost() == 0.0
    p.note_restore_cost(5.0)
    assert p.effective_restore_cost() == 5.0
    p.note_peer_restore(0.5)
    assert p.effective_restore_cost() == 0.5
    p.note_checkpoint_cost(1.0)
    cfg = p.config
    assert p.park_breakeven() == pytest.approx(
        cfg.park_cost_factor * (p._ckpt_ema + 0.5 + p.restep_cost()))


def test_note_peer_restore_records_decision_and_gauges(P):
    p, _, reg, _ = make_policy(P)
    p.note_peer_restore(0.25)
    assert P.ft.MODE_CODES[P.ft.PEER_RESTORE] == 4
    families = P.parse_prometheus(reg.render_prometheus())
    decisions = families["edl_ft_policy_decisions_total"]["samples"]
    assert decisions['edl_ft_policy_decisions_total{mode="peer_restore"}'] == 1.0
    costs = families["edl_ft_policy_restore_cost_seconds"]["samples"]
    assert costs['edl_ft_policy_restore_cost_seconds{source="peer"}'] == 0.25
    st = p.state()
    assert st["restore_source"] == "peer"
    assert st["restore_cost_peer"] == 0.25


# -- the notice-budget decision (tests/test_preempt.py) ------------------------


def _priced_policy(P, **cfg_kw):
    p, _, _, tracer = make_policy(P, P.FTPolicyConfig(**cfg_kw))
    for _ in range(4):
        p.note_checkpoint_cost(4.0)
        p.note_restore_cost(2.0)
        p.note_replan_cost(1.0)
    return p, tracer


def test_notice_budget_decision_table(P):
    p, _ = _priced_policy(P, notice_margin=1.0)
    assert p.drain_cost() == pytest.approx(7.0)
    assert p.on_preempt_notice(60.0) == P.ft.DRAIN_SHRINK
    assert p.on_preempt_notice(5.0) == P.ft.PARK
    assert p.on_preempt_notice(2.0) == P.ft.RIDE_OUT
    assert p.on_preempt_notice(-1.0) == P.ft.RIDE_OUT


def test_notice_margin_derates_the_budget(P):
    p, _ = _priced_policy(P, notice_margin=2.0)
    assert p.on_preempt_notice(6.0) == P.ft.RIDE_OUT
    assert p.on_preempt_notice(10.0) == P.ft.PARK


def test_cold_start_is_optimistic_drain(P):
    p, _, _, _ = make_policy(P)
    assert p.on_preempt_notice(1.0) == P.ft.DRAIN_SHRINK


def test_ft_decision_span_carries_notice_remaining(P):
    p, _, _, tracer = make_policy(P)
    p.on_preempt_notice(42.0)
    spans = [s for s in tracer.spans if s.name == "ft_decision"]
    assert spans and spans[-1].attrs["notice_remaining_s"] == 42.0
    assert "drain_cost" in spans[-1].attrs
    assert "drain_cost" in p.state()


# -- placement override: revoked ranks never hold a replica --------------------


def test_replica_group_excludes_revoked_ranks(P):
    for world in (2, 4, 6, 8):
        for k in (1, 2, 3):
            for revoked in ([0], [world - 1], [1, 2]):
                for rank in range(world):
                    group = P.placement.replica_group(rank, world, k, exclude=revoked)
                    assert not set(group) & set(revoked)
                    assert rank not in group


def test_replica_group_keeps_and_clamps_holders(P):
    rg = P.placement.replica_group
    assert rg(0, 6, 2, exclude=[1]) == [2, 3]
    assert rg(0, 3, 2, exclude=[2]) == [1]
    assert rg(0, 2, 1, exclude=[1]) == []


def test_placement_map_with_exclusions_covers_survivors_only(P):
    m = P.placement.placement_map(4, 2, exclude=[1])
    assert set(m) == {0, 1, 2, 3}
    for rank, group in m.items():
        assert 1 not in group, (rank, group)


def test_publish_placement_documents_exclusions(P):
    coord = P.InProcessCoordinator()
    c = coord.client("w0")
    c.register()
    doc = P.placement.publish_placement(c, epoch=3, world=4, k=1, exclude=[2])
    stored = json.loads(c.kv_get(P.placement.PLACEMENT_KEY.format(epoch=3)))
    assert stored == doc
    assert stored["excluded"] == [2]
    for group in stored["groups"].values():
        assert 2 not in group


# -- straggler quantile math ---------------------------------------------------


def test_nearest_rank_quantile_matches_by_hand(P):
    q = P.nearest_rank_quantile
    assert q([], 0.95) == 0.0
    assert q([3.0, 1.0, 2.0], 0.5) == 2.0
    assert q([1.0, 2.0, 3.0, 4.0], 1.0) == 4.0


def _detector(P, **kw):
    clock = FakeClock()
    cfg = P.StragglerConfig(window_steps=32, min_samples=16,
                            consecutive_breaches=3, **kw)
    det = P.StragglerDetector(cfg, P.PreemptInstruments(P.MetricsRegistry()),
                              clock=clock)
    return det, clock


def test_uniform_noise_never_evicts(P):
    det, _ = _detector(P)
    for i in range(64):
        for h in ("h0", "h1", "h2"):
            det.note_step(h, 1.0 + 0.01 * ((i * 7 + int(h[1]) % 5) % 11))
        if i % 4 == 0:
            assert det.evaluate() == []


def test_sustained_p95_breach_evicts_after_hysteresis(P):
    det, _ = _detector(P)
    for _ in range(40):
        det.note_step("good-a", 1.0)
        det.note_step("good-b", 1.0)
        det.note_step("slow", 2.0)
    verdicts, rounds = [], 0
    while not verdicts and rounds < 10:
        verdicts = det.evaluate()
        rounds += 1
    assert verdicts == ["slow"]
    assert rounds == det.config.consecutive_breaches


def test_one_slow_step_never_evicts(P):
    det, _ = _detector(P)
    for _ in range(40):
        det.note_step("h0", 1.0)
        det.note_step("h1", 1.0)
    det.note_step("h0", 50.0)
    for _ in range(6):
        assert det.evaluate() == []


def test_single_breach_evaluation_resets_on_recovery(P):
    det, _ = _detector(P)
    for _ in range(32):
        det.note_step("h0", 2.0)
        det.note_step("h1", 1.0)
        det.note_step("h2", 1.0)
    assert det.evaluate() == []
    assert det.evaluate() == []
    for _ in range(32):
        for h in ("h0", "h1", "h2"):
            det.note_step(h, 1.0)
    for _ in range(6):
        assert det.evaluate() == []


def test_cooldown_suppresses_repeat_verdicts(P):
    det, clock = _detector(P, cooldown_s=300.0)
    for _ in range(40):
        det.note_step("slow", 2.0)
        det.note_step("h1", 1.0)
        det.note_step("h2", 1.0)
    verdicts = []
    for _ in range(5):
        verdicts += det.evaluate()
    assert verdicts == ["slow"]
    clock.advance(301.0)
    verdicts = []
    for _ in range(5):
        verdicts += det.evaluate()
    assert verdicts == ["slow"]


def test_fleet_of_one_is_never_evaluated(P):
    det, _ = _detector(P)
    for _ in range(64):
        det.note_step("only", 9.0)
    assert det.evaluate() == []


def test_evict_routes_through_preempt_notice(P):
    det, _ = _detector(P, notice_s=17.0)

    class FakeClient:
        def __init__(self):
            self.calls = []

        def preempt_notice(self, targets, notice_s=30.0, reason="preempt"):
            self.calls.append((list(targets), notice_s, reason))
            return list(targets)

    client = FakeClient()
    assert det.evict(client, ["slow-host"]) == ["slow-host"]
    assert client.calls == [(["slow-host"], 17.0, "straggler")]
    assert det.evictions == 1
    assert det.evict(client, []) == []


# -- watch client: preempt frames ----------------------------------------------


def test_preempt_frame_pushes_to_live_subscriber(P):
    coord = P.InProcessCoordinator()
    w0 = coord.client("w0")
    w0.register()
    watch = P.make_epoch_watch(w0, "watch")
    assert watch.subscribe()
    admin = coord.client("admin")
    admin.register()
    t0 = time.monotonic()
    assert admin.preempt_notice(["w0"], notice_s=30.0, reason="spot") == ["w0"]
    watch.poll()
    notices = watch.take_preempts()
    assert len(notices) == 1
    n = notices[0]
    assert n["worker"] == "w0" and n["reason"] == "spot"
    assert n["notice_s"] == 30.0 and n["seq"] == 1
    assert t0 <= n["arrival"] <= n["deadline"] - 29.0
    assert watch.take_preempts() == []


def test_preempt_replays_to_late_subscriber_and_dedups(P):
    coord = P.InProcessCoordinator()
    w0 = coord.client("w0")
    w0.register()
    admin = coord.client("admin")
    admin.register()
    admin.preempt_notice(["w0"], notice_s=45.0, reason="maint")
    watch = P.make_epoch_watch(w0, "watch")
    assert watch.subscribe()
    watch.poll()
    assert [n["seq"] for n in watch.take_preempts()] == [1]
    assert watch.subscribe()
    watch.poll()
    assert watch.take_preempts() == []


# -- both packages on the same inputs ------------------------------------------


def _ft_span_attrs(tracer):
    return [dict(s.attrs) for s in tracer.find(name="ft_decision")]


@pytest.mark.parametrize("cfg", [
    dict(outage_budget=10.0, min_history=3, min_wait=1.0),
    dict(policy="static", outage_budget=1000.0),
    dict(policy="static", outage_budget=0.2),
], ids=["adaptive", "static_wait", "static_park"])
def test_both_take_equal_decisions_on_the_trace(cfg):
    """The blips-then-storms trace through both packages' policies: every
    decision, frozen threshold, decision count, state and ``ft_decision``
    span attribute is equal."""
    runs = []
    for name in PACKAGES:
        P = _pkg(name)
        p, clock, _, tracer = make_policy(P, P.FTPolicyConfig(**cfg))
        p.note_checkpoint_cost(0.7)
        p.note_restore_cost(0.3)
        for _ in range(5):
            p.note_step(0.2)
        cost, log = _run_trace(P, p, TRACE, clock)
        runs.append((cost, log, dict(p.decisions), p.state(), _ft_span_attrs(tracer)))
    assert runs[0] == runs[1]


def test_both_decide_notices_alike():
    runs = []
    for name in PACKAGES:
        P = _pkg(name)
        p, tracer = _priced_policy(P, notice_margin=1.5)
        got = [p.on_preempt_notice(b) for b in (-1.0, 0.0, 3.0, 6.5, 10.0, 10.6, 60.0)]
        runs.append((got, p.drain_cost(), p.state(), _ft_span_attrs(tracer)))
    assert runs[0] == runs[1]


def test_both_stragglers_and_placements_agree():
    """Same step times -> same per-window verdicts and ratio gauges; same
    (world, k, exclusions) -> same replica rings."""
    runs = []
    for name in PACKAGES:
        P = _pkg(name)
        det, clock = _detector(P, cooldown_s=100.0)
        verdicts = []
        for i in range(120):
            for h, base in (("a", 1.0), ("b", 1.1), ("c", 1.0 + (i // 30) * 0.5)):
                det.note_step(h, base + 0.01 * (i % 7))
            if i % 5 == 4:
                verdicts.append(det.evaluate())
                clock.advance(10.0)
        ratios = {h: det.obs.straggler_ratio.value(host=h) for h in "abc"}
        rings = {(w, k, tuple(ex)): P.placement.placement_map(w, k, exclude=ex)
                 for w in (2, 5, 8) for k in (1, 2) for ex in ([], [1], [0, 3])}
        runs.append((verdicts, ratios, det.evictions, rings))
    assert runs[0] == runs[1]
