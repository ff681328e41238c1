"""Device meshes and the one collective the sharded solvers need.

Torch twin of ``velocity_tpu/parallel/mesh.py``. JAX shards a function over
a mesh with ``shard_map`` and reduces with ``psum``; PyTorch has neither on
one card. Here a mesh is a grid of shard slots, each with the torch device
it runs on, and every sharded function is written against a small
interface per axis (``mesh.axis(name)``):

- ``size``: the number of shards along the axis;
- ``indices``: the shards this process runs;
- ``all_reduce_sum(parts)``: one tuple of tensors per shard in ``indices``,
  in that order; returns the tuple summed over every shard of the axis;
- ``gather(parts, dim)``: one tensor per shard in ``indices``; returns the
  axis's whole tensor, the shards' slices in order along ``dim``.

Two back ends implement it. ``InProcess`` runs every shard of the axis in
this process, one after another, and adds the partials in shard order; an
explicit device list may repeat a device, which is how two shards share one
card. ``Distributed`` lays the axis over the ranks of a
``torch.distributed`` process group (one shard per rank, the rank its
index; gloo on the CPU, NCCL on GPUs) and reduces with ``all_reduce``; only
``parallel/launch.py`` builds it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


class InProcess:
    """An axis whose shards all run in this process, in index order."""

    def __init__(self, size: int):
        self.size = size
        self.indices = range(size)

    def all_reduce_sum(self, parts):
        """The sum over shards of ``parts`` (one tuple per shard), added in
        shard order on the first shard's device."""
        total = tuple(parts[0])
        for part in parts[1:]:
            total = tuple(a + b.to(a.device) for a, b in zip(total, part))
        return total

    def gather(self, parts, dim: int):
        """The shards' tensors (one per shard, equal slices along ``dim``)
        concatenated in shard order on the first shard's device."""
        return torch.cat([p.to(parts[0].device) for p in parts], dim=dim)


class Distributed:
    """An axis laid over the ranks of a ``torch.distributed`` group: this
    process runs the one shard whose index is its rank."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        self.indices = [dist.get_rank(group)]

    def all_reduce_sum(self, parts):
        """The sum over ranks of this rank's tuple (``parts`` holds one):
        one ``all_reduce`` of the tuple packed into a flat buffer."""
        import torch.distributed as dist

        (local,) = parts
        flat = torch.cat([t.reshape(-1) for t in local])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out, k = [], 0
        for t in local:
            out.append(flat[k : k + t.numel()].reshape(t.shape))
            k += t.numel()
        return tuple(out)

    def gather(self, parts, dim: int):
        """The whole tensor on every rank from this rank's slice along
        ``dim`` (``parts`` holds one): written into zeros of the global
        size and summed over the ranks (adding zeros is exact)."""
        (local,) = parts
        per = local.shape[dim]
        shape = list(local.shape)
        shape[dim] = per * self.size
        full = local.new_zeros(shape)
        full.narrow(dim, self.indices[0] * per, per).copy_(local)
        return self.all_reduce_sum([(full,)])[0]


@dataclass(frozen=True)
class Mesh:
    """Shard slots on named axes. ``devices[i0, i1, ...]`` is the device of
    the slot at those indices; ``process_axis``, where set, is the one axis
    laid over the ranks of ``group`` (the others run in process)."""

    devices: np.ndarray  # object array of torch.device, shape = the axis sizes
    axis_names: tuple
    process_axis: str | None = None
    group: object = None

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis(self, name: str):
        """The collective interface of axis ``name``."""
        if name == self.process_axis:
            return Distributed(self.group)
        return InProcess(self.shape[name])

    def device(self, **index) -> torch.device:
        """The device of the slot at ``index`` (axis name -> shard index;
        0 on the axes not named)."""
        return self.devices[tuple(index.get(name, 0) for name in self.axis_names)]


def device_counts() -> int:
    """The CUDA devices of this process, or 1 (the CPU) where there are none."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _default_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(axis_sizes: dict[str, int] | None = None, devices=None) -> Mesh:
    """An in-process mesh. ``axis_sizes`` maps axis name -> size; -1 = "the
    rest". Default: one 'point' axis over all devices.

    ``devices`` (a list, or an array whose order is flattened): the slots'
    devices, in row-major order; it may repeat one device. Default: the
    devices ``device_counts`` counts.
    """
    devices = [torch.device(d) for d in np.asarray(
        devices if devices is not None else _default_devices(), dtype=object).reshape(-1)]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = {"point": n}
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    unknown = [i for i, s in enumerate(sizes) if s == -1]
    known = int(np.prod([s for s in sizes if s != -1])) if sizes else 1
    if unknown:
        if len(unknown) > 1:
            raise ValueError("at most one -1 axis")
        sizes[unknown[0]] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices, have {n}")
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(sizes), tuple(names))

