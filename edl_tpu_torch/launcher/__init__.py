"""Pod-side launcher + discovery runtime.

TPU-native re-design of the reference pod runtime: the `paddle_k8s` bash role
dispatcher (`docker/paddle_k8s:238-263`) and the `k8s_tools.py` discovery
library (`docker/k8s_tools.py:166-181`) — with the poll-and-sleep barriers
replaced by coordinator RPCs and static env ranks replaced by leased ranks.
"""

from edl_tpu_torch.launcher.launch import (
    LaunchContext,
    check_failed_count,
    main,
    map_exit_code,
    start_coordinator,
    start_trainer,
)
from edl_tpu_torch.launcher.discovery import (
    coordinator_client,
    fetch_rank,
    fetch_world,
    wait_coordinator,
    wait_members,
)

__all__ = [
    "LaunchContext",
    "check_failed_count",
    "coordinator_client",
    "fetch_rank",
    "fetch_world",
    "main",
    "map_exit_code",
    "start_coordinator",
    "start_trainer",
    "wait_coordinator",
    "wait_members",
]
