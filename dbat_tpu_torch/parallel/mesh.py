"""A 1-D mesh of shards (counterpart of dbat_tpu/parallel/mesh.py).

The JAX package hands its sharded code a `jax.sharding.Mesh` and lets
`shard_map`/GSPMD move the data; every cross-shard reduction is a
`jax.lax.psum`.  Here a mesh is an ordered list of devices, one per
shard, and the sharded code is a Python loop over the shards this
process owns, each shard's work on its own device.  Every psum becomes
`Mesh.sum_shards`:

  * in one process, each shard's partial is moved to the reducing
    device and the partials are added from zero in global shard order;
  * across processes, the partials are first all-gathered
    (torch.distributed), then added in the same global shard order.

So one process with k shards and k processes with one shard each do the
same additions in the same order, and an f32 result on the card repeats
bit for bit.  There is no `all_reduce`: its order is the backend's.

A device may repeat: `make_mesh(["cuda:0"] * 8)` is 8 shards on one
card, `make_mesh(["cpu"] * 8)` 8 shards on the host.

Usage:
    mesh = make_mesh(["cuda:0"] * 8)
    result = bundle(project, mesh=mesh)
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def as_device(device) -> torch.device:
    """torch.device with an explicit index for CUDA ("cuda" -> the
    current card); raises for CUDA without a card (resolve_device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_bounds(n: int, n_shards: int) -> np.ndarray:
    """(n_shards+1,) offsets cutting a leading axis of n rows into
    n_shards contiguous slices, as torch.tensor_split cuts it."""
    q, r = divmod(int(n), int(n_shards))
    sizes = np.full(n_shards, q, np.int64)
    sizes[:r] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


class Mesh:
    """An ordered list of shard devices with one axis.

    devices: one torch.device per shard, in global shard order.
    owned: the shards this process runs (all of them in one process; a
    contiguous run of equal length per process otherwise).
    group: the torch.distributed process group, None in one process.
    device: the reducing device, where shard sums and replicated
    results land (the first owned shard's)."""

    def __init__(self, devices, axis: str = "obs", owned=None, group=None):
        self.devices = tuple(devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.n_shards = len(self.devices)
        self.axis_names = (axis,)
        self.shape = {axis: self.n_shards}
        self.owned = tuple(range(self.n_shards)) if owned is None \
            else tuple(owned)
        self.group = group
        self.device = self.devices[self.owned[0]]

    def resolve(self, device=None) -> torch.device:
        """The reducing device, where ops built on this mesh live; raises
        when `device` names another device."""
        if device is not None and as_device(device) != self.device:
            raise ValueError(f"device {device} is not the mesh's reducing "
                             f"device {self.device}")
        return self.device

    def replicated(self, arr):
        """arr on every owned shard's device (one tensor per owned shard;
        shards on one device share it)."""
        return [arr.to(self.devices[k]) for k in self.owned]

    def _world(self) -> int:
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    def gather_shards(self, parts):
        """Every shard's tensor, in global shard order, on the reducing
        device.  parts: one tensor per owned shard, all of one shape."""
        local = [p.to(self.device) for p in parts]
        if self.group is None:
            return local
        import torch.distributed as dist

        mine = torch.stack(local)
        everyone = [torch.empty_like(mine) for _ in range(self._world())]
        dist.all_gather(everyone, mine, group=self.group)
        return [t for block in everyone for t in block.unbind(0)]

    def gather_rows(self, parts, n: int):
        """The (n, ...) tensor whose leading axis the shards hold in
        shard_bounds slices, whole on the reducing device.  parts: the
        owned shards' slices (padded to the longest slice for the
        all-gather across processes, then trimmed)."""
        b = shard_bounds(n, self.n_shards)
        width = int(np.diff(b).max())
        padded = [torch.cat([p, p.new_zeros((width - p.shape[0],)
                                            + p.shape[1:])]) for p in parts]
        return torch.cat([t[: b[k + 1] - b[k]] for k, t in
                          enumerate(self.gather_shards(padded))])

    def sum_shards(self, parts):
        """The sum over every shard of its partial, added from zero in
        global shard order on the reducing device (the psum of the JAX
        package, in a fixed order)."""
        everyone = self.gather_shards(parts)
        out = torch.zeros_like(everyone[0])
        for p in everyone:
            out = out + p
        return out


def make_mesh(devices=None, axis: str = "obs") -> Mesh:
    """A mesh over `devices` (names or torch.devices; repeats allowed),
    default every visible CUDA card; raises without one."""
    if devices is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")  # raises: no card
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return Mesh([as_device(d) for d in devices], axis=axis)


def shard_leading(mesh: Mesh, arr, axis: str = "obs"):
    """The owned shards' slices of arr's leading axis (shard_bounds),
    each on its shard's device."""
    b = shard_bounds(arr.shape[0], mesh.n_shards)
    return [arr[b[k]:b[k + 1]].to(mesh.devices[k]) for k in mesh.owned]


def replicated(mesh: Mesh, arr):
    """mesh.replicated(arr) under the JAX package's name."""
    return mesh.replicated(arr)
