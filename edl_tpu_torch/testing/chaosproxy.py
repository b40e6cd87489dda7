"""ChaosProxy: a seeded, deterministic TCP fault-injection proxy.

Sits between a coordinator client and the coordinator service and injects
the transport failures the resilience machinery must survive:

- **delays** — hold a chunk before forwarding (latency spike / GC pause);
- **resets** — close both sides mid-stream (the peer sees ECONNRESET or a
  clean EOF, i.e. ``CoordinatorUnreachable``);
- **drops**  — swallow a chunk (the peer blocks until its read timeout,
  i.e. ``CoordinatorTimeout`` — the "request fate unknown" case that the
  req_id/op_id dedup machinery exists for);
- **partitions** — :meth:`partition` severs every live connection and
  resets new ones on arrival until :meth:`heal`, modeling a network split
  or a coordinator restart window.

Determinism: every fault decision comes from a ``random.Random`` seeded
by ``(seed, connection-index, direction)`` — integers only, so runs are
reproducible regardless of PYTHONHASHSEED or thread scheduling. The same
seed against the same connection/request sequence yields the same faults.

The proxy is transport-level only: it never parses the coordinator
protocol, so it exercises exactly what a real middlebox failure would.
"""

from __future__ import annotations

import json
import logging
import random
import socket
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

log = logging.getLogger("edl_tpu_torch.testing.chaosproxy")

__all__ = ["ChaosProxy", "ScenarioStep", "ChaosScenario", "StepSlowShim"]


def _hard_close(sock: socket.socket) -> None:
    """Close with RST semantics where possible (no lingering FIN handshake),
    so the peer observes the abrupt death a crashed process produces."""
    try:
        sock.setsockopt(
            socket.SOL_SOCKET, socket.SO_LINGER,
            __import__("struct").pack("ii", 1, 0),
        )
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


class _ConnPair:
    """One proxied connection: the client socket and its upstream twin."""

    def __init__(self, client: socket.socket, upstream: socket.socket):
        self.client = client
        self.upstream = upstream
        self._closed = threading.Event()

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        # shutdown() before close(): the twin pump may be blocked in recv()
        # on the other socket, and its in-kernel syscall pins the file — a
        # bare close() would neither wake it nor send FIN/RST, leaving the
        # proxied peer hung forever. shutdown() tears the connection down
        # and wakes blocked readers regardless of who holds the fd.
        for sock in (self.client, self.upstream):
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            _hard_close(sock)


class ChaosProxy:
    """Deterministic TCP fault injector between one client and one target.

    Fault probabilities are per forwarded chunk and per direction; with all
    probabilities zero the proxy is a transparent relay (useful as the
    baseline of a chaos test: same topology, no faults).

    ``stats`` counts what was actually injected so tests can assert the
    chaos happened (a chaos test whose faults never fired proves nothing).
    """

    def __init__(
        self,
        target_port: int,
        target_host: str = "127.0.0.1",
        port: Optional[int] = None,
        seed: int = 0,
        delay_prob: float = 0.0,
        delay_range: Tuple[float, float] = (0.005, 0.05),
        reset_prob: float = 0.0,
        drop_prob: float = 0.0,
    ):
        self.target = (target_host, target_port)
        self.seed = seed
        self.delay_prob = delay_prob
        self.delay_range = delay_range
        self.reset_prob = reset_prob
        self.drop_prob = drop_prob
        self._lock = threading.Lock()
        self._partitioned = False
        self._conns: List[_ConnPair] = []
        self._conn_seq = 0
        self.stats: Dict[str, int] = {
            "connections": 0, "delays": 0, "resets": 0,
            "drops": 0, "refused": 0,
        }
        self._stop = threading.Event()
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", port or 0))
        self._lsock.listen(64)
        self.port: int = self._lsock.getsockname()[1]
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------------

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def start(self) -> "ChaosProxy":
        if self._thread is None:
            self._thread = threading.Thread(  # edl: noqa[EDL001] lifecycle field; start/close are owner-thread-only by contract
                target=self._accept_loop, name="edl-chaosproxy", daemon=True
            )
            self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        try:
            # closing a listener does not wake a thread blocked in its
            # accept(); a shutdown does, so the join below returns at once
            self._lsock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        _hard_close(self._lsock)
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for pair in conns:
            pair.close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None  # edl: noqa[EDL001] lifecycle field; start/close are owner-thread-only by contract

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- partition control -----------------------------------------------------

    def partition(self) -> None:
        """Sever every live connection and reset new ones until heal().

        From the client's perspective this is indistinguishable from the
        coordinator process dying: in-flight requests see EOF/RST
        (``CoordinatorUnreachable``) and reconnects are refused."""
        with self._lock:
            self._partitioned = True
            conns = list(self._conns)
            self._conns.clear()
        for pair in conns:  # close outside the lock: peers may be mid-recv
            pair.close()
        log.info("partitioned (%d connections severed)", len(conns))

    def heal(self) -> None:
        with self._lock:
            self._partitioned = False
        log.info("healed")

    @property
    def partitioned(self) -> bool:
        with self._lock:
            return self._partitioned

    # -- data path -------------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                client, _ = self._lsock.accept()
            except OSError:
                return  # listener closed by close()
            with self._lock:
                partitioned = self._partitioned
                self._conn_seq += 1
                cid = self._conn_seq
                if partitioned:
                    self.stats["refused"] += 1
            if partitioned:
                _hard_close(client)
                continue
            try:
                upstream = socket.create_connection(self.target, timeout=5.0)
            except OSError:
                # Target genuinely down: behave like it (reset the client).
                with self._lock:
                    self.stats["refused"] += 1
                _hard_close(client)
                continue
            pair = _ConnPair(client, upstream)
            with self._lock:
                self._conns.append(pair)
                self.stats["connections"] += 1
            # Integer-mixed seeds: deterministic under PYTHONHASHSEED and
            # independent per direction, so thread interleaving between the
            # two pumps cannot perturb either one's fault sequence.
            base = self.seed * 1_000_003 + cid * 2
            for src, dst, rng_seed, name in (
                (client, upstream, base, f"c2s-{cid}"),
                (upstream, client, base + 1, f"s2c-{cid}"),
            ):
                threading.Thread(
                    target=self._pump,
                    args=(pair, src, dst, random.Random(rng_seed)),
                    name=f"edl-chaosproxy-{name}",
                    daemon=True,
                ).start()

    def _pump(self, pair: _ConnPair, src: socket.socket,
              dst: socket.socket, rng: random.Random) -> None:
        try:
            while not self._stop.is_set():
                try:
                    data = src.recv(65536)
                except OSError:
                    break
                if not data:
                    break
                roll = rng.random()
                if roll < self.reset_prob:
                    with self._lock:
                        self.stats["resets"] += 1
                    pair.close()
                    break
                if roll < self.reset_prob + self.drop_prob:
                    with self._lock:
                        self.stats["drops"] += 1
                    continue  # swallowed: the peer waits out its timeout
                if roll < self.reset_prob + self.drop_prob + self.delay_prob:
                    with self._lock:
                        self.stats["delays"] += 1
                    time.sleep(rng.uniform(*self.delay_range))
                try:
                    dst.sendall(data)
                except OSError:
                    break
        finally:
            pair.close()
            with self._lock:
                if pair in self._conns:
                    self._conns.remove(pair)


class StepSlowShim:
    """Per-step sleep shim: the straggler injector.

    Installed as a step hook (``ElasticConfig.step_callback``, or called
    once per step from any custom loop). With factor 1.0 it is a no-op;
    :meth:`slow` makes every subsequent step take ~``factor`` x its
    natural duration by sleeping the difference — the shim EMAs the
    observed inter-step interval as its baseline, so the injected
    slowness scales with the real workload instead of a hardcoded sleep
    (the straggler detector must see a RATIO breach, and a fixed pause
    under- or over-shoots depending on step time). Thread-safe: the
    scenario driver flips ``factor`` while the step loop runs.
    """

    def __init__(self, alpha: float = 0.3, max_sleep: float = 5.0):
        self.alpha = alpha
        self.max_sleep = max_sleep
        self.factor = 1.0
        self.injected_steps = 0
        self.injected_seconds = 0.0
        self._ema = 0.0
        self._last = 0.0
        self._lock = threading.Lock()

    def slow(self, factor: float = 2.0) -> None:
        with self._lock:
            self.factor = max(1.0, float(factor))

    def restore(self) -> None:
        self.slow(1.0)

    def __call__(self, *_args, **_kwargs) -> None:
        now = time.monotonic()
        with self._lock:
            if self._last:
                dt = now - self._last
                self._ema = dt if self._ema == 0.0 else (
                    self.alpha * dt + (1.0 - self.alpha) * self._ema)
            self._last = now
            factor, base = self.factor, self._ema
        if factor > 1.0 and base > 0.0:
            pause = min(self.max_sleep, (factor - 1.0) * base)
            time.sleep(pause)
            with self._lock:
                self.injected_steps += 1
                self.injected_seconds += pause
                # Re-anchor so the injected pause never feeds the baseline
                # EMA (the shim would otherwise compound itself).
                self._last = time.monotonic()


# -- scripted scenarios --------------------------------------------------------


@dataclass
class ScenarioStep:
    """One step of a scripted fault timeline.

    ``action`` names a registered callable; ``when`` (optional) names a
    registered predicate the step blocks on before firing — gating on
    *workload state* ("job alpha finished 2 shards") rather than wall
    clock is what makes a composed chaos run deterministic across
    machines of different speeds. ``after`` adds a fixed delay once the
    gate opens (e.g. "partition, hold 5 s, heal"). ``timeout`` bounds the
    gate wait; an expired gate aborts the scenario (a chaos run whose
    trigger never fired proves nothing, and must say so loudly).
    """

    action: str
    when: str = ""
    after: float = 0.0
    timeout: float = 120.0
    note: str = ""
    kwargs: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "action": self.action, "when": self.when, "after": self.after,
            "timeout": self.timeout, "note": self.note,
            "kwargs": dict(self.kwargs),
        }


class ChaosScenario:
    """Deterministic multi-axis fault conductor.

    A composed chaos test (trainer SIGKILL × apiserver faults × network
    partition) needs its faults *overlapping in a reproducible order* — ad
    hoc ``sleep``-and-fire threads drift across machines and reorder under
    load. The scenario runs an ordered step list on one driver thread:
    each step optionally blocks on a named predicate (polled), waits a
    fixed delay, then fires a named action. The fired timeline lands in
    ``events`` (scheduled vs actual), and :meth:`spec` round-trips through
    JSON so a failing run's exact fault schedule can be replayed.

    Actions and predicates are registered by name::

        sc = (ChaosScenario("composed")
              .register_proxy("beta", proxy)           # beta.partition/.heal
              .register("kill_alpha", proc.kill)
              .predicate("alpha_warm", lambda: worker.steps_done >= 2)
              .add("beta.partition", when="alpha_warm")
              .add("beta.heal", after=1.5)
              .add("kill_alpha"))
        sc.start()
        ...
        sc.join()
        assert sc.completed, sc.events
    """

    def __init__(self, name: str = "scenario"):
        self.name = name
        self.steps: List[ScenarioStep] = []
        self._actions: Dict[str, Callable[..., object]] = {}
        self._predicates: Dict[str, Callable[[], bool]] = {}
        #: fired-event log: one dict per executed step, appended in order.
        self.events: List[Dict] = []
        self.completed = False
        self.failed: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = 0.0

    # -- registry --------------------------------------------------------------

    def register(self, name: str, fn: Callable[..., object]) -> "ChaosScenario":
        self._actions[name] = fn
        return self

    def register_proxy(self, name: str, proxy: ChaosProxy) -> "ChaosScenario":
        """Expose a proxy's fault controls as ``<name>.partition`` /
        ``<name>.heal`` actions."""
        self._actions[f"{name}.partition"] = proxy.partition
        self._actions[f"{name}.heal"] = proxy.heal
        return self

    def register_coordinator(self, name: str, client) -> "ChaosScenario":
        """Expose the advance-notice revocation trigger as
        ``<name>.revoke``: a scripted step like
        ``add("coord.revoke", worker="w0", notice_s=5.0)`` pushes the
        doomed worker a preempt frame through the real control plane —
        the scenario models the cloud scheduler, not a transport fault.
        Kwargs ride the spec JSON, so revocation waves replay exactly."""
        def _revoke(worker: str, notice_s: float = 30.0,
                    reason: str = "preempt") -> None:
            client.preempt_notice([worker], notice_s=notice_s, reason=reason)
        self._actions[f"{name}.revoke"] = _revoke
        return self

    def register_slow(self, name: str, shim: StepSlowShim) -> "ChaosScenario":
        """Expose a straggler shim as ``<name>.slow`` (kwargs: factor) and
        ``<name>.restore`` — the slow-host half of the fault vocabulary."""
        self._actions[f"{name}.slow"] = shim.slow
        self._actions[f"{name}.restore"] = shim.restore
        return self

    def predicate(self, name: str, fn: Callable[[], bool]) -> "ChaosScenario":
        self._predicates[name] = fn
        return self

    def add(self, action: str, when: str = "", after: float = 0.0,
            timeout: float = 120.0, note: str = "", **kwargs) -> "ChaosScenario":
        self.steps.append(ScenarioStep(action=action, when=when, after=after,
                                       timeout=timeout, note=note,
                                       kwargs=kwargs))
        return self

    def spec(self) -> str:
        """The schedule as JSON — committed into a failing test's output so
        the exact fault timeline is replayable."""
        return json.dumps(
            {"name": self.name, "steps": [s.to_dict() for s in self.steps]},
            indent=2)

    @classmethod
    def from_spec(cls, raw: str) -> "ChaosScenario":
        data = json.loads(raw)
        sc = cls(data.get("name", "scenario"))
        for s in data.get("steps", []):
            sc.steps.append(ScenarioStep(
                action=s["action"], when=s.get("when", ""),
                after=float(s.get("after", 0.0)),
                timeout=float(s.get("timeout", 120.0)),
                note=s.get("note", ""), kwargs=dict(s.get("kwargs", {}))))
        return sc

    # -- execution -------------------------------------------------------------

    def start(self) -> "ChaosScenario":
        missing = [s.action for s in self.steps if s.action not in self._actions]
        missing += [s.when for s in self.steps
                    if s.when and s.when not in self._predicates]
        if missing:
            raise ValueError(f"unregistered scenario names: {missing}")
        self._t0 = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, name=f"edl-scenario-{self.name}", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def close(self) -> None:
        self._stop.set()
        self.join(timeout=5.0)

    def __enter__(self) -> "ChaosScenario":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _wait_for(self, step: ScenarioStep) -> bool:
        pred = self._predicates[step.when]
        deadline = time.monotonic() + step.timeout
        while not self._stop.is_set():
            try:
                if pred():
                    return True
            except Exception:  # edl: noqa[EDL005] a predicate probing a worker being chaos-killed may transiently throw; that is "not yet", not a driver crash
                pass
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return False

    def _run(self) -> None:
        for i, step in enumerate(self.steps):
            if self._stop.is_set():
                return
            waited = 0.0
            if step.when:
                t_gate = time.monotonic()
                if not self._wait_for(step):
                    self.failed = (f"step {i} ({step.action}): gate "
                                   f"{step.when!r} never opened")
                    log.error("scenario %s aborted: %s", self.name, self.failed)
                    return
                waited = time.monotonic() - t_gate
            if step.after > 0.0:
                if self._stop.wait(step.after):
                    return
            try:
                self._actions[step.action](**step.kwargs)
            except Exception as e:  # edl: noqa[EDL005] the event log must record WHICH step blew up before the driver dies; tests assert completed/failed
                self.failed = f"step {i} ({step.action}): {e!r}"
                log.exception("scenario %s step %d (%s) failed",
                              self.name, i, step.action)
                return
            self.events.append({
                "step": i, "action": step.action, "when": step.when,
                "note": step.note, "gate_wait": round(waited, 3),
                "at": round(time.monotonic() - self._t0, 3),
            })
            log.info("scenario %s fired %s (step %d, t=%.2fs)",
                     self.name, step.action, i,
                     time.monotonic() - self._t0)
        self.completed = True
