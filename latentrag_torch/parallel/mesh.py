"""The 1-D device mesh and row-sharded arrays.

The port of the JAX package's ``parallel/mesh.py``. A ``Mesh`` is this
process's shard devices in order, one ``"data"`` axis, and the process
group's rank and world size (world 1 without a process group); its size
is the local devices times the world size, and global shard ``g`` lives on
process ``g // len(devices)`` at local position ``g % len(devices)``, the
order ``jax.devices()`` gives a multi-process mesh. An entry of
``devices`` may repeat: the shards that share a device are virtual shards,
searched one after the other there, so a single card (or the CPU) runs the
mesh's whole program with every shard's kernels, padding, merge and
persistence.

``shard_rows`` pads the rows to a multiple of the mesh size with zero
rows at the end, as the JAX function does (at most P - 1 of them, all on
the last shards), and returns this process's shards, each on its device,
as a ``ShardedRows``: callers keep the true row count, and the searches
mask the pad rows, which would otherwise win a top-k.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

DATA_AXIS = "data"


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: this process's ``devices`` (entries may repeat) times
    the ``world`` processes of the process group."""

    devices: tuple
    axis: str = DATA_AXIS
    rank: int = 0
    world: int = 1

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        return len(self.devices) * self.world

    def global_index(self, j: int) -> int:
        """The global shard index of local shard ``j``."""
        return self.rank * len(self.devices) + j

    def distinct_devices(self) -> list:
        """This process's devices, each once, in mesh order."""
        seen: list = []
        for d in self.devices:
            if d not in seen:
                seen.append(d)
        return seen


def make_mesh(n_devices: int | None = None, *,
              devices: Sequence | None = None,
              axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over ``devices`` (strings or ``torch.device``; entries
    may repeat), or by default over every visible CUDA card, the first
    ``n_devices`` of them when given, as the JAX function takes the first
    of ``jax.devices()``. Asking for more cards than are visible raises.
    Under a process group the mesh spans every process (``global_mesh``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu', ...] for a mesh "
                "on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"requested {n_devices} devices, have {len(devices)}")
            devices = devices[:n_devices]
    elif n_devices is not None:
        raise ValueError("pass n_devices or devices, not both")
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    for d in devs:
        if d.type == "cuda" and d.index is None:
            raise ValueError(f"name the card of {d} (cuda:0, cuda:1, ...)")
    rank, world = _world()
    return Mesh(devices=devs, axis=axis, rank=rank, world=world)


@dataclass
class ShardedRows:
    """This process's row shards of one global [P * rows_per_shard, ...]
    array: ``shards[j]`` is global shard ``mesh.global_index(j)`` on
    ``mesh.devices[j]``."""

    shards: list
    mesh: Mesh

    @property
    def rows_per_shard(self) -> int:
        return int(self.shards[0].shape[0])

    @property
    def shape(self) -> tuple:
        """The padded global shape."""
        return (self.rows_per_shard * self.mesh.size,) + tuple(
            self.shards[0].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def offset(self, j: int) -> int:
        """The global row of local shard ``j``'s first row."""
        return self.mesh.global_index(j) * self.rows_per_shard

    def row(self, i: int) -> torch.Tensor:
        """Global row ``i`` on the mesh's first device; across processes
        its owner broadcasts it."""
        g, off = divmod(int(i), self.rows_per_shard)
        owner, j = divmod(g, self.mesh.local_size)
        dev0 = self.mesh.devices[0]
        if self.mesh.world == 1:
            return self.shards[j][off].to(dev0)
        import torch.distributed as dist

        from .distributed import collective_device

        cdev = collective_device(self.mesh)
        if owner == self.mesh.rank:
            buf = self.shards[j][off].to(cdev).contiguous()
        else:
            buf = torch.empty(self.shape[1:], dtype=self.dtype, device=cdev)
        dist.broadcast(buf, src=owner)
        return buf.to(dev0)


def shard_rows(x, mesh: Mesh, axis: str = DATA_AXIS) -> ShardedRows:
    """Pad ``x`` (a tensor on any device, or numpy) to a multiple of the
    mesh size with zero rows at the end and return this process's shards,
    each on its device. Every process passes the same whole ``x``, as every
    JAX process passes the same host array."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    n = int(x.shape[0])
    p = mesh.size
    rows = -(-n // p) if n else 0
    shards = []
    for j, dev in enumerate(mesh.devices):
        lo = mesh.global_index(j) * rows
        part = x[min(lo, n): min(lo + rows, n)]
        if part.shape[0] < rows:  # the pad rows, at the end of the array
            pad = torch.zeros((rows - part.shape[0],) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            part = torch.cat([part, pad])
        shards.append(part.to(dev).contiguous())
    return ShardedRows(shards, mesh)


def gather_rows(sharded: ShardedRows, n: int | None = None,
                device=None) -> torch.Tensor:
    """The global array's first ``n`` rows (default: all, pads included)
    on ``device`` (default: the mesh's first device); across processes the
    shards are all-gathered first."""
    mesh = sharded.mesh
    dev = torch.device(device) if device is not None else mesh.devices[0]
    local = torch.cat([s.to(dev) for s in sharded.shards])
    if mesh.world > 1:
        from .distributed import all_gather_cat

        local = all_gather_cat(local, mesh).to(dev)
    return local if n is None else local[:n]
