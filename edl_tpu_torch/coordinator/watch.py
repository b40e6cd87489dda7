"""Push-based epoch discovery: the client side of the ``watch`` wire op.

A subscription rides a DEDICATED connection: `CoordinatorClient` pairs
replies to requests by ordering on one socket, so unsolicited notification
frames pushed by the coordinator cannot share it. The coordinator pushes
one frame per epoch bump (``{"ok":true,"notify":"epoch","epoch":N,...}``)
the moment the bump happens — a rescale reaches the worker in one RTT
instead of a heartbeat period.

Resume semantics: the subscribe request carries ``cursor`` (the last epoch
this worker observed); the coordinator replays every missed epoch in
``(cursor, current]`` before acking, so a SIGKILL + restart of either side
loses nothing. The client additionally dedups client-side — delivery is
at-least-once across reconnects, observation is exactly-once because only
epochs strictly above ``last_epoch`` are surfaced.

Degradation: any transport failure just flips ``connected`` off; callers
keep their pull path (heartbeat-piggybacked `observed_epoch`) as the
liveness fallback and `poll()` re-subscribes with bounded backoff.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Dict, List, Optional, Tuple

from edl_tpu_torch.coordinator.client import CoordinatorAuthError


class EpochWatch:
    """One epoch-change subscription with a resume cursor.

    Not thread-safe: owned by the worker loop that polls it. ``poll()``
    returns ``(epoch, arrival_monotonic)`` pairs so the caller can measure
    how stale the push signal was when it finally acted on it
    (`edl_worker_epoch_notify_latency_seconds`).
    """

    #: floor/ceiling for the re-subscribe backoff after a failure.
    _RETRY_MIN = 0.2
    _RETRY_MAX = 5.0

    def __init__(self, host: str = "127.0.0.1", port: int = 7164,
                 worker: str = "", token: Optional[str] = None,
                 connect_timeout: float = 5.0):
        self.host = host
        self.port = port
        self.worker = worker
        self.token = token if token is not None \
            else os.environ.get("EDL_COORD_TOKEN", "")
        self.connect_timeout = connect_timeout
        #: resume cursor: highest epoch ever surfaced to the caller.
        #: -1 means "no epoch seen yet" — the first subscribe replays
        #: everything from epoch 1 if the caller primes it with 0, or
        #: nothing if left at -1 (fresh worker joining mid-run).
        self.last_epoch: int = -1
        self.connected = False
        #: telemetry the workers surface in summaries.
        self.notifies_total = 0
        self.duplicates_dropped = 0
        self.resubscribes = 0
        self.preempts_total = 0
        self._sock: Optional[socket.socket] = None
        self._buf = b""
        self._pending: List[Tuple[int, float]] = []
        #: advance-notice revocations addressed to this worker. Delivery is
        #: at-least-once (live push + replay-on-resubscribe), so dedup on
        #: the server's issue seq; the deadline anchors to local monotonic
        #: arrival + notice_s — frames carry no wall clock.
        self._preempt_pending: List[Dict] = []
        self._preempt_seq_seen = 0
        self._retry_at = 0.0
        self._retry_delay = self._RETRY_MIN

    # -- lifecycle -------------------------------------------------------------

    def subscribe(self, timeout: float = 5.0) -> bool:
        """(Re)establish the subscription; replayed epochs land in the
        pending queue for the next ``poll()``. Returns connected-ness."""
        self._teardown()
        try:
            sock = socket.create_connection(
                (self.host, self.port),
                timeout=min(self.connect_timeout, timeout))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            req: Dict = {"op": "watch", "cursor": int(self.last_epoch)}
            if self.worker:
                req["worker"] = self.worker
            if self.token:
                req["token"] = self.token
            sock.settimeout(timeout)
            sock.sendall((json.dumps(req) + "\n").encode())
            self._sock = sock
            # Replayed notifications precede the ack frame; absorb them.
            deadline = time.monotonic() + timeout
            while True:
                frame = self._read_frame(max(0.1, deadline - time.monotonic()))
                if frame is None:
                    raise OSError("watch ack did not arrive")
                if frame.get("unauthorized"):
                    raise CoordinatorAuthError(
                        f"coordinator rejected watch: "
                        f"{frame.get('error', 'unauthorized')}")
                if frame.get("notify") == "epoch":
                    self._absorb(frame)
                    continue
                if frame.get("notify") == "preempt":
                    self._absorb_preempt(frame)
                    continue
                if frame.get("watch"):
                    break
                # Unknown frame (older coordinator): treat as unsupported.
                raise OSError(f"unexpected watch reply: {frame}")
        except CoordinatorAuthError:
            self._teardown()
            raise
        except (OSError, ValueError):
            self._teardown()
            self._retry_delay = min(self._retry_delay * 2, self._RETRY_MAX)
            self._retry_at = time.monotonic() + self._retry_delay
            return False
        self.connected = True
        self._retry_delay = self._RETRY_MIN
        return True

    def close(self) -> None:
        """Best-effort cancel + teardown."""
        if self._sock is not None and self.connected:
            try:
                self._sock.settimeout(1.0)
                self._sock.sendall((json.dumps(
                    {"op": "watch_cancel", "worker": self.worker,
                     "token": self.token}) + "\n").encode())
                # Drain until the cancel reply (notifies may race ahead).
                deadline = time.monotonic() + 1.0
                while time.monotonic() < deadline:
                    frame = self._read_frame(0.2)
                    if frame is None or "cancelled" in frame:
                        break
            except (OSError, ValueError):
                pass
        self._teardown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- polling ---------------------------------------------------------------

    def poll(self, timeout: float = 0.0) -> List[Tuple[int, float]]:
        """Surface newly observed epochs as ``(epoch, arrival_monotonic)``.

        Blocks up to ``timeout`` for the first frame (0 = just drain
        whatever already arrived). Transport failures flip ``connected``
        off and re-subscription is attempted with bounded backoff on
        subsequent polls — the caller's pull path covers the gap.
        """
        if not self.connected:
            if time.monotonic() >= self._retry_at:
                self.resubscribes += 1
                # Bounded: poll() sits on the worker's step-check path, so a
                # partitioned coordinator must cost at most ~1 s per backoff
                # period here — the pull cadence carries liveness meanwhile.
                self.subscribe(timeout=1.0)
            if not self.connected:
                return self._take_pending()
        deadline = time.monotonic() + max(0.0, timeout)
        first = True
        while True:
            wait = deadline - time.monotonic()
            if not first and wait <= 0:
                break
            frame = self._read_frame(max(0.0, wait) if first else 0.0)
            first = False
            if frame is None:
                break
            if frame.get("notify") == "epoch":
                self._absorb(frame)
            elif frame.get("notify") == "preempt":
                self._absorb_preempt(frame)
        return self._take_pending()

    def take_preempts(self) -> List[Dict]:
        """Drain revocation notices observed since the last call. Each dict
        carries worker/notice_s/reason/seq plus ``arrival`` (monotonic) and
        ``deadline`` (= arrival + notice_s) for budget math."""
        out, self._preempt_pending = self._preempt_pending, []
        return out

    # -- internals -------------------------------------------------------------

    def _absorb(self, frame: Dict) -> None:
        try:
            epoch = int(frame["epoch"])
        except (KeyError, TypeError, ValueError):
            return
        self.notifies_total += 1
        if epoch <= self.last_epoch:
            # at-least-once delivery across resubscribes — drop duplicates
            self.duplicates_dropped += 1
            return
        self.last_epoch = epoch
        self._pending.append((epoch, time.monotonic()))

    def _absorb_preempt(self, frame: Dict) -> None:
        try:
            seq = int(frame.get("seq", 0))
            notice_s = float(frame.get("notice_s", 0))
        except (TypeError, ValueError):
            return
        if seq <= self._preempt_seq_seen:
            self.duplicates_dropped += 1
            return
        self._preempt_seq_seen = seq
        self.preempts_total += 1
        now = time.monotonic()
        self._preempt_pending.append({
            "worker": frame.get("worker", ""), "notice_s": notice_s,
            "reason": frame.get("reason", "preempt"), "seq": seq,
            "arrival": now, "deadline": now + notice_s})

    def _take_pending(self) -> List[Tuple[int, float]]:
        out, self._pending = self._pending, []
        return out

    def _read_frame(self, timeout: float) -> Optional[Dict]:
        """One newline-JSON frame, or None on timeout / no data / error.
        Errors mark the subscription disconnected."""
        if self._sock is None:
            return None
        while b"\n" not in self._buf:
            try:
                self._sock.settimeout(timeout if timeout > 0 else 0.000001)
                chunk = self._sock.recv(65536)
            except socket.timeout:
                return None
            except OSError:
                self._mark_disconnected()
                return None
            if not chunk:
                self._mark_disconnected()
                return None
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        try:
            frame = json.loads(line)
        except ValueError:
            self._mark_disconnected()
            return None
        return frame if isinstance(frame, dict) else None

    def _mark_disconnected(self) -> None:
        self.connected = False
        self._retry_at = time.monotonic() + self._retry_delay
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = b""

    def _teardown(self) -> None:
        self.connected = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._buf = b""


class InProcessEpochWatch:
    """`EpochWatch`-shaped adapter over a call-surface client (the
    in-process twin). No dedicated connection exists, so frames queue
    server-side and each ``poll()`` drains them with ``watch`` take
    requests — same resume-cursor and client-side dedup semantics, which
    keeps worker code transport-agnostic."""

    def __init__(self, client):
        self._client = client
        self.last_epoch: int = -1
        self.connected = False
        self.notifies_total = 0
        self.duplicates_dropped = 0
        self.resubscribes = 0
        self.preempts_total = 0
        self._preempt_pending: List[Dict] = []
        self._preempt_seq_seen = 0

    def subscribe(self, timeout: float = 5.0) -> bool:
        try:
            reply = self._client.call("watch", cursor=int(self.last_epoch))
        except Exception:  # edl: noqa[EDL005] push is an optimization — any twin failure degrades to pull discovery, reported via connected=False
            self.connected = False
            return False
        self.connected = bool(reply.get("ok"))
        return self.connected

    def poll(self, timeout: float = 0.0) -> List[Tuple[int, float]]:
        if not self.connected:
            self.resubscribes += 1
            if not self.subscribe():
                return []
        out: List[Tuple[int, float]] = []
        while True:
            try:
                frame = self._client.call("watch", take=True)  # edl: noqa[EDL007] `take` is the in-process twin's drain verb; the wire transport uses a dedicated connection instead, so the native server never sees it
            except Exception:  # edl: noqa[EDL005] same degrade-to-pull contract as subscribe(): the caller's pull path owns liveness
                self.connected = False
                break
            if frame.get("notify") == "preempt":
                try:
                    seq = int(frame.get("seq", 0))
                    notice_s = float(frame.get("notice_s", 0))
                except (TypeError, ValueError):
                    continue
                if seq <= self._preempt_seq_seen:
                    self.duplicates_dropped += 1
                    continue
                self._preempt_seq_seen = seq
                self.preempts_total += 1
                now = time.monotonic()
                self._preempt_pending.append({
                    "worker": frame.get("worker", ""),
                    "notice_s": notice_s,
                    "reason": frame.get("reason", "preempt"), "seq": seq,
                    "arrival": now, "deadline": now + notice_s})
                continue
            if frame.get("notify") != "epoch":
                break
            self.notifies_total += 1
            try:
                epoch = int(frame["epoch"])
            except (KeyError, TypeError, ValueError):
                continue
            if epoch <= self.last_epoch:
                self.duplicates_dropped += 1
                continue
            self.last_epoch = epoch
            out.append((epoch, time.monotonic()))
        return out

    def take_preempts(self) -> List[Dict]:
        """Same contract as `EpochWatch.take_preempts`."""
        out, self._preempt_pending = self._preempt_pending, []
        return out

    def close(self) -> None:
        try:
            self._client.call("watch_cancel")
        except Exception:  # edl: noqa[EDL005] best-effort cancel on teardown — the server reaps the subscription either way
            pass
        self.connected = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_epoch_watch(client, mode: str = "auto"):
    """Build the right watch for a worker's transport, or None.

    ``client`` may be an OutboxClient wrapper — the raw transport under it
    decides: wire clients (host/port surface) get a dedicated-connection
    `EpochWatch`; in-process twins (call surface only) get the take-polling
    adapter. ``mode="pull"`` disables push discovery outright.
    """
    if mode == "pull":
        return None
    raw = getattr(client, "client", client)
    host = getattr(raw, "host", None)
    port = getattr(raw, "port", None)
    if isinstance(host, str) and isinstance(port, int):
        return EpochWatch(host=host, port=port,
                          worker=getattr(raw, "worker", "") or "",
                          token=getattr(raw, "token", None))
    if hasattr(raw, "call"):
        return InProcessEpochWatch(raw)
    return None
