"""Several processes, one replica axis: torch.distributed init and the
placement of each process's replica rows.

Between hosts the name-keyed gRPC tier stays the transport (each host's
key table assigns slots in arrival order, so two hosts' raw state is not
slot-aligned and cannot be merged row by row). What joining processes
is for is a global tier whose replica merge spans processes: every
process holds `r_local` replica rows of the [R, S] grid, and the merge
gathers the other processes' rows over the group (collective/ops.py).
Slot alignment across processes is the caller's contract, as it is for
replicas in one process.

`init_multihost` reads VENEUR_TPU_COORDINATOR, VENEUR_TPU_NUM_PROCESSES
and VENEUR_TPU_PROCESS_ID, as the JAX package does, and joins a
`torch.distributed` group over TCP at that address: gloo for CPU
tensors, NCCL for CUDA tensors. Like every entry point of the port it
runs on the card unless the caller asks for the CPU, so with no device
it joins over NCCL. Nothing on a single machine tells a program of a
cluster, so the process count and id must be given.
"""

from __future__ import annotations

import os
from typing import Optional

from veneur_tpu_torch.aggregation.state import resolve_device
from veneur_tpu_torch.parallel.sharded import Layout


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device=None):
    """Join this process into a torch.distributed group; returns the
    group, or None when neither arguments nor env name a coordinator.
    `device` picks the backend: gloo for "cpu", NCCL for the card (the
    default, which raises when there is no card)."""
    import torch.distributed as dist
    coordinator_address = coordinator_address or os.environ.get(
        "VENEUR_TPU_COORDINATOR", "")
    if not coordinator_address:
        return None
    if num_processes is None:
        num_processes = os.environ.get("VENEUR_TPU_NUM_PROCESSES", "")
    if process_id is None:
        process_id = os.environ.get("VENEUR_TPU_PROCESS_ID", "")
    if num_processes in ("", None) or process_id in ("", None):
        raise ValueError("init_multihost needs the process count and this "
                         "process's id (VENEUR_TPU_NUM_PROCESSES, "
                         "VENEUR_TPU_PROCESS_ID)")
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.group.WORLD


def owned_replicas(layout: Layout) -> range:
    """The global replica rows this process holds."""
    return range(layout.rank * layout.r_local,
                 (layout.rank + 1) * layout.r_local)
