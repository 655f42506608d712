"""Mesh builders for the launchers, ported from ``repro.launch.mesh``
(functions, never module-level constants: importing this module touches
no device and joins no group)."""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Tuple, Union

from repro_torch.core.mesh import ProcessGroupMesh, SimMesh


def process_state() -> Tuple[Dict[str, str], bool, bool]:
    """(the environment, whether CUDA is initialised, whether a process
    group is joined): what a shape-only run (``launch.dryrun``) must leave
    in its process as it found it (:func:`touched`)."""
    import torch
    import torch.distributed as dist

    return dict(os.environ), torch.cuda.is_initialized(), dist.is_available() and dist.is_initialized()


def touched(before: Tuple[Dict[str, str], bool, bool]) -> List[str]:
    """What the process changed since :func:`process_state` was
    ``before``: each environment variable set, changed or removed, CUDA
    initialised, a process group joined."""
    env, cuda, group = before
    now, cuda_now, group_now = process_state()
    out = [f"environment variable {k}" for k in sorted(set(env) | set(now)) if env.get(k) != now.get(k)]
    return out + (["CUDA initialised"] if cuda_now and not cuda else []) + \
        (["a process group joined"] if group_now and not group else [])


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axes and sizes without ranks (the reference's tests'
    ``FakeMesh``): what the spec functions (``launch.specs``,
    ``core.sharding``) read of a mesh."""

    dims: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def _distributed() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_production_mesh(multi_pod: bool = False, *, device=None) -> Union[ProcessGroupMesh, MeshShape]:
    """The target deployment meshes: ``(16, 16)`` ``('data', 'model')``,
    or with a leading ``pod`` axis for cross-pod data parallelism ``(2,
    16, 16)`` ``('pod', 'data', 'model')``. Under ``torch.distributed`` the
    world's ranks joined as that grid (a ``ProcessGroupMesh`` on
    ``device``; it raises when the world size differs); otherwise its
    shape alone (:class:`MeshShape`), for the spec functions."""
    dims = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not _distributed():
        return MeshShape(dims, names)
    import torch.distributed as dist

    if dist.get_world_size() != math.prod(dims):
        raise ValueError(f"the production mesh {dims} needs {math.prod(dims)} ranks, the world has "
                         f"{dist.get_world_size()}")
    return ProcessGroupMesh(device=device, grid=dims, axis_names=names)


def make_local_mesh(model_parallel: int = 1, device=None) -> Union[SimMesh, ProcessGroupMesh]:
    """A ``(data, model)`` mesh. Under ``torch.distributed``: the world's
    ranks as a ``(world // mp, mp)`` grid (a ``ProcessGroupMesh`` on
    ``device``, default this rank's card) -- the reference's ``(n // mp,
    mp)`` over every process's devices, one rank a process here. In one
    process: ``(1, model_parallel)`` ranks, all on ``device`` (default
    ``cuda``), a ``SimMesh`` whose ranks share the one device and run in
    lock step. The reference's ``mp = min(model_parallel, n)`` over the
    one device a process of the port drives would give ``(1, 1)``; the
    port keeps the asked ``model`` axis instead (ROADMAP queue C), so
    ``--model-parallel`` trains tensor-parallel on one card."""
    if not _distributed():
        return SimMesh((1, model_parallel), axis_names=("data", "model"), device=device)
    import torch.distributed as dist

    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide the world's {world} ranks")
    return ProcessGroupMesh(device=device, grid=(world // model_parallel, model_parallel),
                            axis_names=("data", "model"))
