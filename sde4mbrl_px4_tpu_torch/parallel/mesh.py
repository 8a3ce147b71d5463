"""The (dp, mc) mesh over the ranks of a process group (L6).

PyTorch counterpart of ``sde4mbrl_px4_tpu/parallel/mesh.py`` (``:27-66``).
The JAX package's mesh is a grid of devices that XLA shards arrays over;
here a mesh is a grid of RANKS of the default ``torch.distributed`` process
group (``parallel/distributed.py``), each rank one process on one device:

- axis ``"dp"``: independent scenarios. A rank solves its own rows of the
  batch (:meth:`Mesh.rows`), with no collective inside a solve;
- axis ``"mc"``: the Monte-Carlo particles of one solve. A rank evaluates
  its share of the particles and the ranks of an mc group sum their
  partial means in rank order every evaluation
  (``parallel/batched.py::make_particle_sharded_mpc``).

Rank r sits at ``divmod(r, mc)`` of the grid, as ``np.reshape`` puts the
JAX package's devices. Its device is ``cuda:(r % device_count)`` on the
card (two ranks of a pair share the one card), or ``cpu`` when the caller
asks for the CPU (``devices="cpu"``). Without a process group the mesh is
(1, 1) over this process: a rank of one, today's single-process behaviour.

:func:`scenario_sharding` and :func:`replicated` are descriptors, "this
rank's rows of a leading axis" and "all rows" (:meth:`Sharding.local`); no
array is placed by them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "Sharding", "best_mesh_shape", "make_mesh", "replicated",
           "scenario_sharding", "world"]


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the default process group, ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def best_mesh_shape(n_devices: int, n_scenarios: int, num_particles: int) -> Tuple[int, int]:
    """Split devices between the dp and mc axes (a numpy copy of the
    original's ``:27-41``): fill dp first (scenario throughput), give mc
    only what dp cannot use, and only when the particles split evenly."""
    dp = int(np.gcd(n_devices, n_scenarios)) if n_scenarios > 0 else 1
    mc = n_devices // dp
    while mc > 1 and (num_particles % mc != 0):
        mc //= 2
    dp = n_devices // mc if mc >= 1 else n_devices
    if dp * mc != n_devices:
        dp, mc = n_devices, 1
    return dp, mc


class Mesh:
    """A (dp, mc) grid of the group's ranks; this process is ``rank``.

    ``shape`` maps each axis name to its size, as the JAX mesh's does
    (``mesh.shape["dp"]``); ``devices`` is the (dp, mc) grid of the ranks'
    device names."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], rank: int):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        self.rank = int(rank)
        self.size = int(devices.size)
        self.dp, self.mc = (int(n) for n in devices.shape)
        self.dp_index, self.mc_index = divmod(self.rank, self.mc)
        self.device = torch.device(devices.flat[self.rank])
        self._groups: Optional[Dict[str, Any]] = None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at ({self.dp_index}, {self.mc_index}) "
                f"on {self.device})")

    def rows(self, n: int) -> slice:
        """This rank's rows of a leading axis of ``n`` split over dp (the
        ranks of an mc group share them); ``n`` must divide by dp."""
        if n % self.dp:
            raise ValueError(f"a batch of {n} must divide over the dp axis ({self.dp})")
        b = n // self.dp
        return slice(self.dp_index * b, (self.dp_index + 1) * b)

    def axis_members(self, axis: str) -> list:
        """The ranks of this rank's group along ``axis``, in rank order."""
        if axis == self.axis_names[0]:
            return [d * self.mc + self.mc_index for d in range(self.dp)]
        if axis == self.axis_names[1]:
            return [self.dp_index * self.mc + m for m in range(self.mc)]
        raise ValueError(f"no axis {axis!r} in {self.axis_names}")

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (None: the
        default group, when the line is the whole world). The first call
        builds every line's group and must come on every rank at the same
        point of the program, as ``torch.distributed.new_group`` asks."""
        if len(self.axis_members(axis)) == self.size:
            return None
        if self._groups is None:
            import torch.distributed as dist

            groups = {}
            for name, lines in ((self.axis_names[0], [[d * self.mc + m for d in range(self.dp)]
                                                      for m in range(self.mc)]),
                                (self.axis_names[1], [[d * self.mc + m for m in range(self.mc)]
                                                      for d in range(self.dp)])):
                for line in lines:
                    g = dist.new_group(line) if 1 < len(line) < self.size else None
                    if self.rank in line:
                        groups[name] = g
            self._groups = groups
        return self._groups[axis]


def _rank_devices(devices: Union[None, str, Sequence], n: int) -> list:
    """One device name per rank: ``cuda:(r % count)`` by default (the card;
    without one this raises, as ``device.resolve_device`` does), ``"cpu"``
    (or any single device name) for every rank, or a list of n names."""
    from sde4mbrl_px4_tpu_torch.device import resolve_device

    if devices is None:
        resolve_device(None)
        count = torch.cuda.device_count()
        return [f"cuda:{r % count}" for r in range(n)]
    if isinstance(devices, (str, torch.device)):
        devices = [str(devices)] * n
    devices = [str(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a world of {n} ranks")
    return devices


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("dp", "mc"),
              devices: Union[None, str, Sequence] = None) -> Mesh:
    """A 2-D (scenario, particle) mesh over the ranks of the default
    process group (one rank without one). ``shape`` defaults to (world, 1)
    and must multiply to the world size (the original raises the same,
    ``:52-53``). ``devices``: module docstring; this rank's device is
    checked here (a rank asked for the card without CUDA raises)."""
    from sde4mbrl_px4_tpu_torch.device import resolve_device

    rank, n = world()
    if shape is None:
        shape = (n, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    names = _rank_devices(devices, n)
    resolve_device(names[rank])
    grid = np.empty(n, dtype=object)
    grid[:] = names
    return Mesh(grid.reshape(tuple(int(s) for s in shape)), axis_names, rank)


class Sharding(NamedTuple):
    """How a leading axis lies over a mesh: ``spec`` names the mesh axis of
    each array axis (None: whole), as the JAX package's ``PartitionSpec``."""

    mesh: Mesh
    spec: tuple

    def local(self, x):
        """This rank's part of ``x`` (rows over dp where ``spec[0]`` is
        ``"dp"``, else all of it)."""
        if self.spec and self.spec[0] == self.mesh.axis_names[0]:
            return x[self.mesh.rows(int(x.shape[0]))]
        return x


def scenario_sharding(mesh: Mesh, rank: int = 1) -> Sharding:
    """A leading scenario axis over dp; the other ``rank - 1`` axes whole."""
    return Sharding(mesh, (mesh.axis_names[0],) + (None,) * (rank - 1))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())
