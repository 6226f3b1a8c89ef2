"""Multi-process execution over torch.distributed (counterpart of
nefii_tpu/parallel/dist.py).

The JAX package runs one process that drives every chip of its host (and
one process a host across hosts); the port runs one process per card, as the
reference NeFII did with torch.distributed.launch + NCCL:

  * `initialize()` joins the process group from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or from the JAX
    package's flags (`--coordinator_address host:port` -> tcp://host:port,
    `--num_processes` -> the world size, `--process_id` -> the rank). NCCL
    on CUDA, after torch.cuda.set_device(LOCAL_RANK); gloo on the CPU. A
    world of 1 initialises nothing, so a single process is the plain port.
  * `warmup()` runs one collective while the processes are in step (JAX's
    warmup_collectives): a first collective that waits behind one rank's
    kernel build or checkpoint load then does not meet the rendezvous
    deadline alone.
  * `is_main()` guards filesystem writes (checkpoints, vis, logs) as the
    reference's rank-0 checks do; `barrier()` holds the other ranks.
  * `broadcast_str` sends rank 0's string (the run's timestamp: hosts'
    clocks may disagree) to every rank.
  * `gather_along` concatenates every rank's tensor along one dimension, in
    rank order, whatever its length on each rank (gather the sizes, pad,
    all_gather, cut): the counterpart of `to_host` on a sharded array.
  * `world_device(device)` is `cuda:LOCAL_RANK` in a multi-process run.
  * `build_once` builds the kernels (or the native runtime) on each host's
    local rank 0 while the host's other ranks wait.

Two ranks that share one card cannot form an NCCL pair (NCCL refuses two
ranks on one device); such a run (a one-card machine's check of the
multi-process path) passes backend="gloo", and gloo runs every collective
used here (all_reduce, all_gather, broadcast, barrier) on CUDA tensors:
gloo itself copies them through host memory and back, and the port adds no
staging of its own and no fallback.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, List, Optional

import torch
import torch.distributed as tdist

TIMEOUT = timedelta(minutes=10)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def requested_world(num_processes: Optional[int] = None) -> int:
    """The world size a launch asks for: --num_processes, else torchrun's
    WORLD_SIZE, else 1."""
    if num_processes is not None and num_processes > 0:
        return int(num_processes)
    return _env_int("WORLD_SIZE") or 1


def local_rank() -> int:
    """This process's place on its host: torchrun's LOCAL_RANK, else (JAX's
    flags) the rank modulo the host's cards, or the rank on a host without
    a card."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    if not tdist.is_initialized():
        return 0
    if torch.cuda.is_available() and torch.cuda.device_count():
        return tdist.get_rank() % torch.cuda.device_count()
    return tdist.get_rank()


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda",
               backend: Optional[str] = None, init_method: Optional[str] = None) -> None:
    """Join the process group (idempotent). With the JAX flags, rank
    `process_id` of `num_processes` meets the others at tcp://
    `coordinator_address`; without them, torchrun's environment (env://) is
    read. `backend` defaults to NCCL for a CUDA `device` and gloo for the
    CPU; `init_method` (for example file://...) overrides the address. A
    world of 1 initialises nothing."""
    if tdist.is_initialized():
        return
    world = requested_world(num_processes)
    if world <= 1:
        return
    rank = process_id if process_id is not None and process_id >= 0 else _env_int("RANK")
    if rank is None:
        raise ValueError("multi-process run without a rank: pass --process_id or launch "
                         "with torchrun")
    if init_method is None:
        if coordinator_address:
            init_method = f"tcp://{coordinator_address}"
        elif os.environ.get("MASTER_ADDR"):
            init_method = "env://"
        else:
            raise ValueError("multi-process run without a rendezvous: pass "
                             "--coordinator_address host:port or launch with torchrun")
    cuda = torch.device(device).type == "cuda"
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if cuda and backend == "nccl":
        lr = _env_int("LOCAL_RANK")
        torch.cuda.set_device(lr if lr is not None else rank % torch.cuda.device_count())
    tdist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                             timeout=TIMEOUT)
    warmup(device)


def warmup(device="cpu") -> None:
    """One all_reduce over the group while every rank is in step."""
    if process_count() > 1:
        t = torch.ones(1, device=world_device(device))
        tdist.all_reduce(t)
        if float(t) != process_count():
            raise RuntimeError(f"warm-up all_reduce gave {float(t)}, expected {process_count()}")


def shutdown() -> None:
    if tdist.is_initialized():
        tdist.destroy_process_group()


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def is_main() -> bool:
    """True on the process that owns filesystem writes (rank 0)."""
    return rank() == 0


def barrier() -> None:
    if process_count() > 1:
        tdist.barrier()


def world_device(device) -> torch.device:
    """`device`, with a bare "cuda" turned into this process's card
    (cuda:local_rank()) in a multi-process run."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and process_count() > 1:
        return torch.device("cuda", local_rank())
    return device


def build_once(build: Callable[[], object]) -> None:
    """Run `build` (the kernels' or the native runtime's build) on each
    host's local rank 0 while the other ranks wait at a barrier; they then
    load the finished library. The builds write a temporary file and rename
    it into place, so a rank that builds anyway never loads half a file."""
    if process_count() == 1:
        return
    try:
        if local_rank() == 0:
            build()
    finally:
        barrier()


def broadcast_str(s: str) -> str:
    """Rank 0's `s` on every rank."""
    if process_count() == 1:
        return s
    box: List[Optional[str]] = [s if is_main() else None]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place; -> t."""
    if process_count() > 1:
        tdist.all_reduce(t)
    return t


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's `t` (the same shape on each)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    tdist.all_gather(parts, t)
    return parts


def gather_along(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in rank order; the ranks'
    lengths along `dim` may differ (the other dimensions may not)."""
    if process_count() == 1:
        return t
    dim = dim % max(t.dim(), 1)
    n = torch.tensor([t.shape[dim]], dtype=torch.int64, device=t.device)
    sizes = [int(s) for s in _all_gather(n)]
    longest = max(sizes)
    if t.shape[dim] < longest:
        pad = list(t.shape)
        pad[dim] = longest - t.shape[dim]
        t = torch.cat([t, t.new_zeros(pad)], dim)
    parts = _all_gather(t)
    return torch.cat([p.narrow(dim, 0, k) for p, k in zip(parts, sizes)], dim)
