"""Multi-process set-up and host-local data plumbing (counterpart of
`cvpr23_lfdm_tpu/parallel/distributed.py`).

One process (rank) per device. `init_distributed` joins this process to a
`torch.distributed` process group: from explicit arguments (the CLIs'
`--coordinator` / `--num-processes` / `--process-id`), or from the
environment `torchrun` sets (`RANK`, `WORLD_SIZE`, `MASTER_ADDR`), the
counterpart of JAX's auto-detection; with neither it does nothing and the
run is one process. Then, as in the JAX package:

* every process loads only its contiguous slice of each global batch
  (`host_shard` on the loaders),
* the trainers average their gradients over the `data` mesh
  (`parallel/mesh.py`),
* checkpoints and logs are written by the primary (rank 0) only
  (`is_primary`).

The backend follows the device: `nccl` for CUDA, `gloo` for the CPU. An
explicit `backend` overrides it (gloo carries CUDA tensors through the
host, which lets two ranks share one card; NCCL refuses that). Nothing
switches backend or device on its own.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from cvpr23_lfdm_torch.utils.device import resolve_device

TIMEOUT_S = 600  # a collective that waits longer raises instead of hanging the run
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
_rank_device: list = [None]  # the device `init_distributed` chose for this rank


def _device_of_rank(device) -> torch.device:
    """The caller's device; a CUDA device without an index is the rank's
    card: `cuda:{LOCAL_RANK}` under torchrun, else `cuda:0`."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None, device=None,
                     timeout_s: float = TIMEOUT_S) -> dict:
    """Join this process to the process group (a no-op for one process).

    With `coordinator_address` (`host:port`, rank 0 listens there) or
    `num_processes > 1`, all three of them are needed; with none of them
    but torchrun's environment set, the group is read from it. `device`
    (None: the CUDA card) picks the backend unless `backend` names one.

    Returns `{"process_index", "process_count", "device_count"}`; one
    device per process, so `device_count` is the process count."""
    explicit = bool(coordinator_address) or (num_processes or 0) > 1
    if explicit or all(k in os.environ for k in _TORCHRUN_ENV):
        if dist.is_initialized():
            raise RuntimeError("init_distributed: this process already joined a process group")
        if explicit:
            if not coordinator_address or num_processes is None or process_id is None:
                raise ValueError("multi-process run: needs the coordinator address, the number "
                                 "of processes and this process's id")
            if not 0 <= process_id < num_processes:
                raise ValueError(f"process id {process_id} outside [0, {num_processes})")
            kwargs = {"init_method": f"tcp://{coordinator_address}", "world_size": num_processes,
                      "rank": process_id}
        else:
            kwargs = {"init_method": "env://"}
        dev = _device_of_rank(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        _rank_device[0] = dev
    return {"process_index": process_index(), "process_count": process_count(),
            "device_count": process_count()}


def shutdown_distributed() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device[0] = None


def local_device() -> torch.device | None:
    """The device `init_distributed` chose for this rank (None: no group)."""
    return _rank_device[0] if dist.is_initialized() else None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the checkpoint and logging owner (rank 0), and when there is
    no process group."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (a no-op for one process)."""
    if process_count() > 1:
        dist.barrier()


def host_shard(global_batch_size: int) -> tuple[int, int, int]:
    """`(shard_index, shard_count, local_batch_size)` for this process.

    The loaders slice each GLOBAL batch contiguously by rank, so the ranks'
    slices in rank order are the one-process batch stream: resume and replay
    do not depend on the process count for a fixed global batch."""
    n, i = process_count(), process_index()
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return i, n, global_batch_size // n
