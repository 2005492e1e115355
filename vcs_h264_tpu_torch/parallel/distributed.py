"""The GOP axis across processes (counterpart of
`vcs_h264_tpu/parallel/distributed.py`).

Every GOP is independent (its P- and B-frames reference only its own
I-frame), so processes encode disjoint, contiguous GOP spans of one video
into a shared directory of per-GOP checkpoints, which doubles as the
gather medium and as the unit of recovery: after a barrier, rank 0 loads
every GOP from the directory and writes the container. No tensor crosses
between processes.

The processes meet at a `torch.distributed.TCPStore` that rank 0 hosts at
the coordinator's address; the process group is gloo over that store. The
encode runs no collective, and NCCL refuses two ranks on one GPU, which is
how a one-card machine runs two ranks. Each rank encodes on
`cuda:{rank % device_count}`.
"""

from __future__ import annotations

import os
import shutil
from datetime import timedelta
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_STORE_TIMEOUT = timedelta(seconds=600)

# The store of this process's group (None before `init_distributed`), as
# jax.distributed keeps its client: `process_barrier` waits on it.
_store: Optional[dist.Store] = None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the process group when a coordinator is configured, from the
    arguments or the VCS_COORDINATOR, VCS_NUM_PROCS and VCS_PROC_ID
    variables; returns (rank, world size), or (0, 1) without a coordinator.

    Rank 0 hosts the store at the coordinator's host:port; the other ranks
    connect to it, retrying until the store's timeout, so they may start
    first."""
    global _store
    coord = coordinator_address or os.environ.get("VCS_COORDINATOR")
    if not coord:
        return 0, 1
    world = num_processes or int(os.environ["VCS_NUM_PROCS"])
    rank = (process_id if process_id is not None
            else int(os.environ["VCS_PROC_ID"]))
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} outside a world of {world}")
    host, port = coord.rsplit(":", 1)
    _store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                           timeout=_STORE_TIMEOUT, wait_for_workers=False)
    dist.init_process_group("gloo", store=_store, rank=rank,
                            world_size=world, timeout=_STORE_TIMEOUT)
    return rank, world


def process_barrier(name: str, timeout_ms: int = 600_000) -> None:
    """All-process barrier on the store (control plane, no collective).

    The encode needs it only for file visibility: every rank's checkpoints
    written before rank 0 assembles. Each rank sets `name/rank` and waits
    for every rank's key; then rank 0, which hosts the store, waits until
    every rank has seen them all (`name/done/rank`), so that the store
    outlives every wait. A no-op in a world of one."""
    if _store is None or not dist.is_initialized() \
            or dist.get_world_size() <= 1:
        return
    rank, world = dist.get_rank(), dist.get_world_size()
    timeout = timedelta(milliseconds=timeout_ms)
    _store.set(f"{name}/{rank}", "1")
    _store.wait([f"{name}/{r}" for r in range(world)], timeout)
    _store.set(f"{name}/done/{rank}", "1")
    if rank == 0:
        _store.wait([f"{name}/done/{r}" for r in range(world)], timeout)


def assign_gops(num_gops: int, num_processes: int,
                process_id: int) -> List[int]:
    """Contiguous block assignment of GOP indices to a process, so each
    reads one contiguous span of the source video."""
    base = num_gops // num_processes
    extra = num_gops % num_processes
    start = process_id * base + min(process_id, extra)
    count = base + (1 if process_id < extra else 0)
    return list(range(start, start + count))


def frame_range_for_gops(gop_indices: Sequence[int], gop_len: int,
                         num_frames: int) -> Tuple[int, int]:
    """[first_frame, last_frame) covering a contiguous GOP assignment."""
    if not gop_indices:
        return 0, 0
    lo = min(gop_indices) * gop_len
    hi = min((max(gop_indices) + 1) * gop_len, num_frames)
    return lo, hi


def merge_checkpoint_dirs(dirs: Sequence[str], out_dir: str) -> int:
    """Merge per-process checkpoint directories: hard-link (or copy) every
    gop_* file into one directory, keeping a file already there; returns
    the number of GOP files seen."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for d in dirs:
        for name in sorted(os.listdir(d)):
            if not name.startswith("gop_"):
                continue
            dst = os.path.join(out_dir, name)
            if not os.path.exists(dst):
                try:
                    os.link(os.path.join(d, name), dst)
                except OSError:
                    shutil.copy2(os.path.join(d, name), dst)
            n += 1
    return n


def rank_device(device, rank: int) -> torch.device:
    """The device a rank encodes on: a CUDA device without an index becomes
    cuda:{rank % device_count}; anything else is kept."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def encode_distributed(frames, fps: float, cfg, *, checkpoint_dir: str,
                       rank: int, world: int, gop_batch: int = 8,
                       device="cuda"):
    """Encode this rank's `assign_gops` span of `frames` (the whole video,
    BGR uint8 [H, W, 3]) into `checkpoint_dir` under the GOPs' indices in
    the whole video, meet every rank at `process_barrier`, and on rank 0
    assemble the stream: an encode of all the frames that only loads, as
    every GOP is checkpointed by then. Returns the `EncodedVideo` on rank 0
    and None on the others. Prints the rank's span."""
    from vcs_h264_tpu_torch.models.encoder import Encoder

    n_gops = -(-len(frames) // cfg.gop_len)
    idxs = assign_gops(n_gops, world, rank)
    lo, hi = frame_range_for_gops(idxs, cfg.gop_len, len(frames))
    enc = Encoder(cfg, gop_batch, device=rank_device(device, rank))
    if lo < hi:
        enc.encode_frames(frames[lo:hi], fps=fps,
                          checkpoint_dir=checkpoint_dir,
                          gop_index_offset=idxs[0])
        print(f"[proc {rank}/{world}] encoded GOPs {idxs[0]}..{idxs[-1]} -> "
              f"{checkpoint_dir}", flush=True)
    process_barrier("vcs_encode_done")
    if rank != 0:
        return None
    return enc.encode_frames(frames, fps=fps, checkpoint_dir=checkpoint_dir)
