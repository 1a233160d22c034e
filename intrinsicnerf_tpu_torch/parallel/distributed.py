"""Process-group start-up and per-process data sharding helpers.

Port of ``intrinsicnerf_tpu/parallel/distributed.py``.  The JAX package
runs one process per host over a mesh of that host's devices; the port
runs one process per GPU with ``torch.distributed``, so a mesh of several
local devices and several hosts are the same case here.  A data-parallel
run is: ``initialize_distributed()`` once per process (a ``tcp://``
rendezvous from ``--coordinator/--num_processes/--process_id``, or
``torchrun``'s environment), each process loads only its own shard of the
training images (``local_train_ids``), the processes agree on the
semantic class set (``allgather_semantic_classes``), and the train step
averages its gradients over the group (``parallel/mesh.py``).

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import contextlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from intrinsicnerf_tpu_torch import resolve_device

TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def backend_for(device) -> str:
    """The collective backend of a process training on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def requested_world(num_processes: Optional[int] = None) -> int:
    """The process count a launch asks for: ``num_processes``, else
    ``torchrun``'s ``WORLD_SIZE``, else 1."""
    if num_processes is not None:
        return int(num_processes)
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> Tuple[int, int]:
    """Join the default process group; returns ``(rank, world)``.

    A no-op with ``(0, 1)`` when nothing asks for more than one process
    (no argument and no ``torchrun`` variable set), and ``(rank, world)``
    of the group when one is already initialised.  ``coordinator``
    (``tcp://HOST:PORT`` or ``HOST:PORT``) needs ``num_processes`` and
    ``process_id``; without it the four ``torchrun`` variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) must be
    set.  What is missing is named in the ``SystemExit``.  On ``cuda``
    the process takes ``cuda:LOCAL_RANK`` (else ``rank`` modulo the
    visible cards) and the NCCL communicator is made here, not at the
    first collective.  A failed rendezvous or NCCL start raises."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    asked = [k for k in TORCHRUN_ENV if k in env]
    if coordinator is None and num_processes is None and process_id is None and not asked:
        return 0, 1
    if coordinator is not None:
        missing = [f for f, v in (("--num_processes", num_processes),
                                  ("--process_id", process_id)) if v is None]
        if missing:
            raise SystemExit(f"--coordinator needs {' and '.join(missing)}")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        rank, world = int(process_id), int(num_processes)
    else:
        missing = [k for k in TORCHRUN_ENV if k not in env]
        if missing:
            raise SystemExit(
                "a data-parallel launch needs --coordinator tcp://HOST:PORT (with "
                "--num_processes and --process_id) or torchrun's environment; "
                f"missing: --coordinator, {', '.join(missing)}")
        init_method = "env://"
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        for flag, given, have in (("--num_processes", num_processes, world),
                                  ("--process_id", process_id, rank)):
            if given is not None and int(given) != have:
                raise SystemExit(f"{flag} {given} disagrees with torchrun's {have}")
    if not 0 <= rank < world:
        raise SystemExit(f"process id {rank} is outside 0..{world - 1}")
    kwargs = {}
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend_for(dev), init_method=init_method, rank=rank,
                            world_size=world, **kwargs)
    return rank, world


def data_parallel_asked(args) -> bool:
    """Whether a CLI's parsed ``args`` ask for data parallelism:
    ``--data_parallel`` or any of the process flags."""
    return bool(args.data_parallel or args.coordinator or args.num_processes is not None
                or args.process_id is not None)


def join_group(args):
    """The data-parallel group a CLI's parsed ``args`` ask for
    (``parallel.mesh.DataGroup``, the process group joined first on
    ``args.device``), or None when they ask for none."""
    from intrinsicnerf_tpu_torch.parallel.mesh import make_group

    if not data_parallel_asked(args):
        return None
    initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                           device=args.device)
    group = make_group(args.device)
    print(f"data-parallel: rank {group.rank} of {group.world} "
          f"({group.backend or 'one process, no process group'}) on {group.device}")
    return group


@contextlib.contextmanager
def process_group_scope():
    """A CLI's run: a default process group joined inside it is destroyed
    on the way out; one that existed before it is left as it was."""
    existed = dist.is_initialized()
    try:
        yield
    finally:
        if not existed and dist.is_initialized():
            dist.destroy_process_group()


def is_lead_process() -> bool:
    """True on the process that owns file IO (logs, renders, checkpoints),
    and always without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_world(rank: Optional[int], world: Optional[int]) -> Tuple[int, int]:
    if rank is not None and world is not None:
        return rank, world
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_image_slice(num_images: int, rank: Optional[int] = None,
                      world: Optional[int] = None) -> slice:
    """The contiguous image range process ``rank`` (default: this one)
    loads: ``[rank, rank + 1) * num_images / world``, the slice
    ``mesh.shard_pools`` keeps on that rank."""
    rank, world = _rank_world(rank, world)
    per = num_images // world
    if per * world != num_images:
        raise ValueError(f"image count {num_images} must divide process count {world} "
                         "(pad the id list with pad_ids_to_multiple first)")
    return slice(rank * per, (rank + 1) * per)


def pad_ids_to_multiple(ids: Sequence[int], n: int) -> List[int]:
    """Wrap-around pad a frame-id list so its length divides ``n`` (the
    host-side twin of ``mesh.pad_images_to_multiple``)."""
    ids = list(ids)
    r = (-len(ids)) % n
    out = ids[:]
    while r > 0:
        take = min(r, len(ids))
        out += ids[:take]
        r -= take
    return out


def local_train_ids(train_ids: Sequence[int], world: Optional[int] = None,
                    rank: Optional[int] = None) -> Tuple[List[int], int]:
    """The train-frame ids this process loads: the whole list padded to a
    multiple of the process count (one GPU per process), then sliced by
    rank.  Returns ``(local_ids, padded_total)``."""
    rank, world = _rank_world(rank, world)
    padded = pad_ids_to_multiple(train_ids, world)
    return padded[local_image_slice(len(padded), rank, world)], len(padded)


def _comm_device() -> torch.device:
    """Where a host helper's collective runs: the current card under NCCL,
    the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_semantic_classes(local_classes, max_id: int = 4096) -> np.ndarray:
    """The union of the semantic class ids present on all processes.

    Each process loads only its shard of the images, so the classes it
    sees differ from the others'; the dense ``[0, C)`` remap (and with it
    the semantic head's width) must come from one set everywhere.  A
    presence bitmap of ``max_id`` entries is reduced with MAX."""
    local_classes = np.asarray(local_classes, np.int64)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return np.unique(local_classes)
    if local_classes.size and int(local_classes.max()) >= max_id:
        raise ValueError(f"class id {int(local_classes.max())} >= max_id {max_id}")
    bitmap = torch.zeros(max_id, dtype=torch.int32)
    bitmap[torch.from_numpy(local_classes)] = 1
    bitmap = bitmap.to(_comm_device())
    dist.all_reduce(bitmap, op=dist.ReduceOp.MAX)
    return np.nonzero(bitmap.cpu().numpy())[0].astype(np.int64)


def allgather_pixels(arrays: List[np.ndarray]) -> List[np.ndarray]:
    """Each array concatenated over the processes in rank order (rows may
    differ per process: each block travels padded to the largest and is
    cut back).  The arrays themselves on a single process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return arrays
    world, dev = dist.get_world_size(), _comm_device()
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        rows = torch.tensor([a.shape[0]], dtype=torch.int64, device=dev)
        all_rows = [torch.zeros_like(rows) for _ in range(world)]
        dist.all_gather(all_rows, rows)
        counts = [int(r) for r in all_rows]
        block = torch.zeros((max(counts), *a.shape[1:]), dtype=torch.from_numpy(a).dtype,
                            device=dev)
        block[: a.shape[0]] = torch.from_numpy(a).to(dev)
        blocks = [torch.empty_like(block) for _ in range(world)]
        dist.all_gather(blocks, block)
        out.append(np.concatenate([b[:n].cpu().numpy() for b, n in zip(blocks, counts)]))
    return out


def make_global_pools(group, local_pools):
    """The pools a rank trains on, from the images it loaded.  With one
    process per device a rank's local pools already are its shard (the
    JAX package assembles one global array from the hosts' pieces here),
    so this only places them on the rank's device."""
    return type(local_pools)(*(None if x is None else x.to(group.device) for x in local_pools))
