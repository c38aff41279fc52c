"""Multi-process runs: process init, window sharding, ordered SAM merge.

Port of bowtie2_tpu/dist/multihost.py. Every process loads the index on
its own device and aligns the windows of the input it owns with the
normal single-process pipeline:

- `init_multihost` joins the process group (torch.distributed), from its
  arguments or the same BT2X_* variables as the JAX package;
- reads are sharded by contiguous window: process p takes windows w with
  w % P == p (`shard_windows`) and writes one shard file a window
  (`shard_path`);
- `merge_shards` concatenates the shard files in window order, which is
  input order: the bytes equal a one-process run (the reference's
  --reorder contract, outq.h:38).

No collective runs during alignment; the group exists for a caller's
barrier before the merge. The backend is gloo for CPU runs and NCCL for
cards, but NCCL refuses two ranks on one card: processes that share a
card take gloo (`backend="gloo"`), as the CPU tests and chip_smoke's
one-card check do.
"""

import glob
import itertools
import os
from typing import Iterable, Iterator, Optional

WINDOW = 65536   # reads per shard window (must match across processes)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   backend: Optional[str] = None) -> None:
    """Join the process group from the arguments or BT2X_COORDINATOR
    ("host:port"), BT2X_NUM_PROCESSES and BT2X_PROCESS_ID. backend: gloo
    or nccl; by default nccl when a card is present, else gloo."""
    import torch
    import torch.distributed as dist

    coordinator = coordinator or os.environ.get("BT2X_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("BT2X_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("BT2X_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError("init_multihost needs the coordinator, the number "
                         "of processes and this process's id (arguments "
                         "or BT2X_COORDINATOR, BT2X_NUM_PROCESSES, "
                         "BT2X_PROCESS_ID)")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shard_windows(reader: Iterable, process_id: int, num_processes: int,
                  window: int = WINDOW) -> Iterator[tuple]:
    """Yield (window_index, records) for the windows this process owns:
    every process parses the stream (cheap beside alignment) and aligns
    window w when w % num_processes == process_id."""
    it = iter(reader)
    for w in itertools.count():
        chunk = list(itertools.islice(it, window))
        if not chunk:
            return
        if w % num_processes == process_id:
            yield w, chunk
        if len(chunk) < window:
            return


def shard_path(prefix: str, window_index: int) -> str:
    return f"{prefix}.shard{window_index:08d}"


def merge_shards(prefix: str, out_path: str, header: bytes = b"",
                 cleanup: bool = True) -> int:
    """Concatenate the shard files in window order into one SAM; returns
    the number merged."""
    shards = sorted(glob.glob(prefix + ".shard*"))
    with open(out_path, "wb") as out:
        if header:
            out.write(header)
        for s in shards:
            with open(s, "rb") as f:
                out.write(f.read())
            if cleanup:
                os.remove(s)
    return len(shards)
