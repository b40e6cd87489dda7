"""Crash-injected native oracle for the EDL010 durability lane.

Replays each modeled trace against the REAL ``edl-coordinator`` binary:
ops go over the wire, and a modeled crash point is realized by the
binary's env-gated hooks (``native/coordinator/coordinator.cc``):

- ``EDL_COORD_CRASH_AFTER_APPENDS=<n>`` — ``_exit(2)`` after the n-th
  committed append frame (the frame IS durable; the reply never flushes,
  which is exactly the ``pre_ack`` crash mode);
- ``EDL_COORD_CRASH_TORN=1`` — before dying, rewind the journal to
  mid-frame (commit marker gone, final data record halved): the on-disk
  shape of power dying inside the write instead of after it;
- ``EDL_COORD_COMPACT_EVERY=<n>`` + ``EDL_COORD_CRASH_IN_SNAPSHOT=<k>`` —
  force the compaction threshold down and die inside the k-th snapshot
  write before its rename (``during_compaction``: journal untouched, the
  triggering frame lost, unacked).

Arming needs the crash point at BOOT time (the env is read once, in the
coordinator's constructor), so the oracle reads it from the trace before
replay begins: ``begin_trace`` scans for the crash event and uses the
``crash_info`` the MODEL computed during exploration (``frames_before`` /
``records_before`` / ``snapshots_before``). Frame counts line up because
both sides group-commit one frame per op turn and both write a boot meta
frame first — the server's readiness ping flushes the native one before
any scripted op runs. A count mismatch is NOT masked: the binary then
dies at a different op than the model crashed at, and the replay reports
the divergence as a finding.

The post-crash restart boots with every hook cleared (the model's
recovery also drops ``compact_every`` — env does not survive a crash) and
must reconstruct exactly the committed journal prefix; any drift surfaces
as an acked-durability violation in ``_replay_trace``.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import weakref
from typing import Any, Dict, List, Optional

CRASH_OP = "crash"


class NativeCrashOracle:
    """Oracle adapter over a crash-armed ``edl-coordinator`` subprocess.

    Implements the durable-oracle protocol ``_replay_trace`` drives:
    ``begin_trace(trace)`` (boot, armed from the trace's crash event),
    ``client(worker)``, ``model_crash(crash_info) -> reply``, ``close()``.
    """

    RUN_ID = "modelcheck"

    def __init__(self, compact_every: Optional[int] = None):
        self._dir = tempfile.mkdtemp(prefix="edl-modelcheck-native-")
        self._state = os.path.join(self._dir, "state.jsonl")
        self._compact_every = compact_every
        self._server = None
        self._crash: Optional[Dict[str, Any]] = None
        self._finalizer = weakref.finalize(
            self, shutil.rmtree, self._dir, True)

    # -- trace lifecycle -------------------------------------------------------

    def begin_trace(self, trace: List[Any]) -> None:
        for ev in trace:
            if ev.op.op == CRASH_OP:
                self._crash = dict(ev.crash_info or {})
                break
        env: Dict[str, str] = {}
        if self._compact_every is not None:
            env["EDL_COORD_COMPACT_EVERY"] = str(self._compact_every)
        if self._crash and self._crash.get("mode") != "clean" \
                and int(self._crash.get("inflight_records", 0)) > 0:
            mode = self._crash["mode"]
            if mode == "during_compaction":
                env["EDL_COORD_COMPACT_EVERY"] = str(
                    int(self._crash["records_before"]))
                env["EDL_COORD_CRASH_IN_SNAPSHOT"] = str(
                    int(self._crash["snapshots_before"]) + 1)
            else:  # pre_ack / torn: die after the inflight op's append
                env["EDL_COORD_CRASH_AFTER_APPENDS"] = str(
                    int(self._crash["frames_before"]) + 1)
                if mode == "torn":
                    env["EDL_COORD_CRASH_TORN"] = "1"
        self._boot(env)

    def _boot(self, env: Dict[str, str]) -> None:
        from edl_tpu_torch.coordinator.server import CoordinatorServer

        # Near-infinite lease/TTL windows: wall time must not pass for the
        # model. auth_token="" disables auth regardless of the parent env.
        self._server = CoordinatorServer(
            task_lease_sec=1e9, heartbeat_ttl_sec=1e9,
            state_file=self._state, run_id=self.RUN_ID,
            auth_token="", extra_env=env)
        # start()'s readiness ping runs one event-loop turn, flushing the
        # boot meta frame as its own append — frame #1 on both sides.
        self._server.start(wait=30.0)

    def client(self, worker: str):
        return self._server.client(worker)

    # -- the crash step --------------------------------------------------------

    def model_crash(self, info: Dict[str, Any]) -> Dict[str, Any]:
        from edl_tpu_torch.coordinator.client import (
            CoordinatorClient,
            CoordinatorError,
        )

        mode = info.get("mode", "clean")
        armed = mode != "clean" and int(info.get("inflight_records", 0)) > 0
        if mode != "clean":
            # Deliver the inflight op. When armed, the server _exit(2)s
            # inside this call — ack-after-durability means the journal
            # write happens BEFORE the reply flushes, so the client sees a
            # dead connection, never the ack. An unarmed delivery (the op
            # deduplicated: zero records, every mode degrades to clean)
            # returns normally and the reply is discarded, matching the
            # model's lost-reply semantics.
            for sub in info.get("inflight", []):
                fields = dict(sub)
                op = fields.pop("op", "")
                w = fields.pop("worker", "")
                cl = CoordinatorClient(port=self._server.port, worker=w,
                                       token="", retry=None,
                                       connect_timeout=5.0)
                try:
                    cl.call(op, timeout=15.0, **fields)
                except (CoordinatorError, OSError):
                    pass
                finally:
                    cl.close()
        if armed:
            rc = self._server.wait()
            if rc != 2:
                # Surfaced as a reply divergence: the hook did not fire
                # where the model crashed (a frame-count mismatch) — the
                # epoch below will disagree too, but say why.
                self._server.stop()
                return {"ok": False,
                        "error": f"armed crash hook exited rc={rc}, "
                                 "expected _exit(2) at the modeled frame"}
            self._server.stop()  # reap bookkeeping; process already dead
        else:
            # Clean crash between turns: kill -9. Every acked frame is
            # already group-committed, so nothing is in flight.
            self._server.kill()
        # Restart with every crash hook cleared — the model's recovery
        # also drops compact_every (env does not survive the crash).
        self._server.extra_env = {}
        self._server.start(wait=30.0)
        cl = self._server.client("")
        try:
            st = cl.call("status")
        finally:
            cl.close()
        return {"ok": True, "crash": mode,
                "epoch": int(st.get("epoch", -1))}

    def close(self) -> None:
        if self._server is not None:
            self._server.stop()
            self._server = None
        self._finalizer()


def native_toolchain_available() -> bool:
    """True when the native coordinator can be built (a C++ toolchain is
    on PATH) — the modelcheck-native lane's clean-skip condition."""
    cxx = os.environ.get("CXX", "g++")
    return shutil.which(cxx) is not None
