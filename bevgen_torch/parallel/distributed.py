"""Multi-process start-up and rank-aware helpers.

Port of `bevgen_tpu/parallel/distributed.py` onto `torch.distributed`:
`initialize` joins the process group (a no-op at one process),
`rank_zero` guards what only process 0 does (the reference's
`rank_zero_only`), and `host_shard_indices` gives each process its
contiguous share of a dataset.

The process count, rank and rendezvous come from the arguments, else from
the JAX package's variables (`BEVGEN_NUM_PROCESSES`, `BEVGEN_PROCESS_ID`,
`BEVGEN_COORDINATOR`), else from torchrun's (`WORLD_SIZE`, `RANK`,
`MASTER_ADDR`/`MASTER_PORT` through `env://`). A coordinator is
`host:port` (TCP) or a URL (`tcp://...`, `file://...`).
"""
from __future__ import annotations

import datetime
import functools
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

# a collective that waits longer than this raises in place of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def world_size_from_env() -> int:
    """The process count the launcher asked for (1 when none did)."""
    return int(os.environ.get("BEVGEN_NUM_PROCESSES",
                              os.environ.get("WORLD_SIZE", "1")))


def local_rank() -> int:
    """This process's index on its node (torchrun's LOCAL_RANK; 0 without)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def backend_for(device: Union[str, torch.device]) -> str:
    """nccl for CUDA tensors, gloo for CPU ones."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(coordinator: Optional[str]) -> str:
    coordinator = coordinator or os.environ.get("BEVGEN_COORDINATOR")
    if coordinator is None:
        return "env://"
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: Union[str, torch.device] = "cuda",
               timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the default process group. Returns True when this call created
    it; False at one process (nothing to join) or when a group exists.

    backend: `backend_for(device)` when None (nccl on cuda, gloo on cpu);
    it is never chosen by trying one and catching its failure. Every
    collective of the group raises after `timeout`."""
    if num_processes is None:
        num_processes = world_size_from_env()
    if num_processes <= 1 or dist.is_initialized():
        return False
    if process_id is None:
        process_id = int(os.environ.get("BEVGEN_PROCESS_ID",
                                        os.environ.get("RANK", "0")))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or backend_for(dev),
                            init_method=_init_method(coordinator),
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


def shutdown() -> None:
    """Leave the default process group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def rank_zero(fn):
    """Run only on process 0 (the reference's rank_zero_only)."""
    @functools.wraps(fn)
    def wrapped(*a, **k):
        if is_main_process():
            return fn(*a, **k)
        return None
    return wrapped


def host_shard_indices(n: int, index: Optional[int] = None,
                       count: Optional[int] = None) -> slice:
    """This process's contiguous share of an n-sample dataset: every process
    gets exactly n // count samples and the remainder is dropped, so no
    process sees an extra batch and waits alone in a collective at the end
    of an epoch. `index` and `count` default to this process's rank and
    the process count."""
    p = process_index() if index is None else index
    np_ = process_count() if count is None else count
    per = n // np_
    return slice(p * per, (p + 1) * per)
