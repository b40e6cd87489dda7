"""Process-group bring-up from the coordinator protocol: the port of
`edl_tpu.runtime.distributed`.

The JAX package hands a trainer's distributed identity to
``jax.distributed.initialize``; here the same facts feed
``torch.distributed.init_process_group``, with the backend named: ``"nccl"``
on the card, ``"gloo"`` when the caller asks for it (the CPU tests).

- **rank** — the coordinator-leased dense rank (cannot collide or be reused
  mid-epoch).
- **world size** — the control plane's rescale target in the KV
  (``edl/expected_world``), else the controller-stamped
  ``EDL_NUM_TRAINERS``.
- **address** — rank 0 publishes ``host:port`` (or a whole init-method URL)
  in the coordinator KV under an epoch-scoped key, so a peer never reads an
  address from an earlier epoch; peers block on that exact key.

Bring-up protocol (per process), as in the JAX package:

1. wait until live membership reaches the expected world size,
2. rendezvous: settle on a common (epoch, rank), re-registering while a
   stale member's lease still holds a rank >= world,
3. rank 0 publishes its address under the epoch-scoped key; peers poll it.

A process group's world size is fixed at init: a rescale exits the
process (`runtime.multihost.MultiHostWorker`), and the relaunched entry
forms the group at the new world through the coordinator, as above. The
group is the world's whatever the layout: the worker then builds its mesh
of any axes over it (`parallel.mesh.build_mesh`, the fixed axes times
``data``, or a planned layout), which makes the axes' subgroups.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import time
from dataclasses import dataclass
from typing import Optional

from edl_tpu_torch.coordinator import CoordinatorError

log = logging.getLogger("edl_tpu_torch.runtime.distributed")

#: KV key prefix rank 0 publishes the process group's address under; the
#: membership epoch is appended so peers never read a stale address. The
#: JAX package's ``JAX_COORD_KEY``, the same key letter for letter.
PG_ADDRESS_KEY = "edl/jax_coordinator_address"
#: KV key the control plane sets to the target world size on rescale.
EXPECTED_WORLD_KEY = "edl/expected_world"
#: offset from the EDL coordinator port for the process group's rendezvous
#: (the JAX package's ``JAX_COORD_PORT_OFFSET``)
PG_PORT_OFFSET = 1


@dataclass(frozen=True)
class DistributedIdentity:
    """What ``init_process_group`` needs, and where each field came from."""

    process_id: int
    num_processes: int
    coordinator_address: str

    @property
    def init_method(self) -> str:
        """The rendezvous URL: the published address as ``tcp://host:port``,
        or the URL rank 0 published whole (``file://...``)."""
        addr = self.coordinator_address
        return addr if "://" in addr else f"tcp://{addr}"

    def initialize_kwargs(self) -> dict:
        return {"init_method": self.init_method,
                "world_size": self.num_processes,
                "rank": self.process_id}


def local_host_ip() -> str:
    """This host's address for peers to dial rank 0 on: ``EDL_POD_IP`` when
    the pod spec sets it, else the host name's first IPv4 address from the
    local resolver, else loopback."""
    ip = os.environ.get("EDL_POD_IP")
    if ip:
        return ip
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def expected_world(ctx, client) -> int:
    """Target world size: the control plane's rescale target if published
    (`EXPECTED_WORLD_KEY`), else the pod-creation-time `EDL_NUM_TRAINERS`."""
    published = client.kv_get(EXPECTED_WORLD_KEY)
    if published:
        return max(1, int(published))
    return max(1, int(ctx.num_trainers))


def derive_identity(ctx, client, timeout: float = 300.0, port: Optional[int] = None,
                    host: Optional[str] = None, init_method: Optional[str] = None
                    ) -> DistributedIdentity:
    """Compute (rank, world size, address) from the env protocol
    (`LaunchContext`) and a coordinator client.

    Waits for full membership, settles (epoch, rank) through the rendezvous
    sync, then exchanges rank 0's address through an epoch-scoped KV key:
    ``host:port`` (``host`` default `local_host_ip`, ``port`` default the
    coordinator's port plus `PG_PORT_OFFSET`), or ``init_method`` whole
    when rank 0 is given one. A restarted worker whose predecessor's lease
    has not yet expired can draw rank >= world; it re-registers until the
    stale entry ages out and ranks re-pack."""
    world = expected_world(ctx, client)
    deadline = time.monotonic() + timeout
    info = client.register(takeover=True)
    last_drain_check = 0.0
    while True:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"distributed bring-up did not settle within {timeout}s: "
                f"members={len(client.members())}/{world} rank={info.get('rank')}")
        if len(client.members()) < world:
            # a late join against a finished job exits cleanly: the shard
            # queue is drained and the missing peers completed (rate-limited)
            now = time.monotonic()
            st = {}
            if now - last_drain_check >= 2.0:
                last_drain_check = now
                try:
                    st = client.status()
                except CoordinatorError:
                    st = {}  # a timed-out probe is "not drained"
            if (st and int(st.get("queued", 0)) == 0
                    and int(st.get("leased", 0)) == 0 and int(st.get("done", 0)) > 0):
                log.info("job already drained (done=%s) while waiting for world=%d "
                         "(members=%d); exiting with nothing to do",
                         st.get("done"), world, len(client.members()))
                try:
                    client.leave()
                finally:
                    raise SystemExit(0)
            time.sleep(0.2)
            info = client.register()
            continue
        rank, epoch = int(info["rank"]), int(info["epoch"])
        if rank >= world:
            time.sleep(0.5)
            info = client.register()
            continue
        reply = client.sync(epoch, timeout=min(30.0, max(1.0, deadline - time.monotonic())))
        if reply.get("ok") and int(reply.get("world", 0)) == world:
            break
        info = client.register()

    key = f"{PG_ADDRESS_KEY}/{epoch}"
    if rank == 0:
        if init_method is not None:
            address = init_method
        else:
            address = (f"{host or local_host_ip()}:"
                       f"{port if port is not None else ctx.port + PG_PORT_OFFSET}")
        client.kv_put(key, address)
        return DistributedIdentity(rank, world, address)
    while time.monotonic() < deadline:
        address = client.kv_get(key)
        if address:
            return DistributedIdentity(rank, world, address)
        time.sleep(0.2)
    raise TimeoutError(f"rank {rank}: rank 0 never published {key} within {timeout}s")


def distributed_init(ctx, client=None, backend: str = "nccl", timeout: float = 300.0,
                     port: Optional[int] = None, host: Optional[str] = None,
                     init_method: Optional[str] = None) -> Optional[DistributedIdentity]:
    """Form the default process group from the coordinator's identity;
    None without a coordinator client (a local run: use
    `parallel.mesh.local_mesh`).

    Unlike ``jax.distributed``, which one process does not need, a process
    group carries the mesh's collectives at any world size, so one is formed
    at world size 1 too. ``backend`` is ``"nccl"`` on the card (call
    ``torch.cuda.set_device`` first) or ``"gloo"``. Call once per process,
    from the trainer entrypoint, then build the mesh
    (`parallel.mesh.build_mesh`)."""
    if client is None:
        return None
    import torch.distributed as dist

    ident = derive_identity(ctx, client, timeout=timeout, port=port, host=host,
                            init_method=init_method)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout),
                            **ident.initialize_kwargs())
    log.info("process group up (%s): rank %d/%d via %s", backend, ident.process_id,
             ident.num_processes, ident.init_method)
    return ident


__all__ = ["DistributedIdentity", "EXPECTED_WORLD_KEY", "PG_ADDRESS_KEY",
           "PG_PORT_OFFSET", "derive_identity", "distributed_init", "expected_world",
           "local_host_ip"]
