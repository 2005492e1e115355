"""Device mesh and layouts (counterpart of `vcs_h264_tpu/parallel/mesh.py`).

Axes:
  gop  — data parallelism over the GOP batch
  tile — row tiles of each frame, with a halo exchange
         (`parallel/spatial.py`)

The JAX mesh is single-controller: one process drives the devices of its
host through `shard_map`. So is this one. A `Mesh` is a `gop x tile` grid
of `torch.device`s that one process drives in turn; a shard is a contiguous
tensor on its device, and rows that cross to another device are copied
there (peer to peer between two GPUs). A grid may name one device more than
once: the CPU tests run a mesh of `[torch.device("cpu")] * n`, a machine
with one card one of `cuda:0` repeated.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A `gop x tile` grid of devices, row by row; hashable, so the sharded
    encoder and decoder factories cache on it."""
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return {"gop": len(self.devices), "tile": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device a gather lands on."""
        return self.devices[0][0]


def make_mesh(gop: int = 1, tile: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first gop * tile of `devices` (default: every CUDA
    device of this process, so it raises where there is none)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = gop * tile
    if n > len(devices):
        raise ValueError(f"mesh {gop}x{tile} needs {n} devices, "
                         f"have {len(devices)}")
    return Mesh(tuple(tuple(devices[g * tile:(g + 1) * tile])
                      for g in range(gop)))


class Layout(NamedTuple):
    """Where an array lies on a mesh: its leading (batch) axis split over
    the gop rows and, where `rows` names an axis, that axis split over the
    tiles of each gop row; with `rows` None every tile of a gop row holds
    the row's whole batch slice."""
    rows: Optional[int] = None


def gop_sharding(mesh: Mesh) -> Layout:
    """Batch-of-GOPs arrays: the leading batch axis over 'gop'."""
    return Layout()


def frame_batch_sharding(mesh: Mesh) -> Layout:
    """Planar [B, ..., H, W]: batch over 'gop', rows (axis -2) over
    'tile'."""
    return Layout(rows=-2)


def split_rows(x: torch.Tensor, devices: Sequence[torch.device],
               axis: int = -2) -> List[torch.Tensor]:
    """x cut into len(devices) equal parts along `axis`, part t contiguous
    on devices[t]."""
    n = len(devices)
    if x.shape[axis] % n:
        raise ValueError(f"{x.shape[axis]} rows do not split into {n} "
                         "tiles")
    th = x.shape[axis] // n
    return [x.narrow(axis, t * th, th).to(d).contiguous()
            for t, d in enumerate(devices)]


def shard(x: torch.Tensor, mesh: Mesh,
          layout: Layout) -> List[List[torch.Tensor]]:
    """x -> shards[g][t], each a contiguous tensor on mesh.devices[g][t]."""
    n_gop = mesh.shape["gop"]
    if x.shape[0] % n_gop:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the "
                         f"mesh's {n_gop} gop rows")
    bl = x.shape[0] // n_gop
    out = []
    for g, row in enumerate(mesh.devices):
        xb = x[g * bl:(g + 1) * bl]
        if layout.rows is None:
            out.append([xb.to(d).contiguous() for d in row])
        else:
            out.append(split_rows(xb, row, layout.rows))
    return out


def gather(shards: Sequence[Sequence[torch.Tensor]], mesh: Mesh,
           layout: Layout) -> torch.Tensor:
    """The inverse of `shard`, on the mesh's first device."""
    dev = mesh.first
    rows = [torch.cat([s.to(dev) for s in row], dim=layout.rows)
            if layout.rows is not None else row[0].to(dev)
            for row in shards]
    return torch.cat(rows, dim=0)
