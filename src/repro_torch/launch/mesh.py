"""Device meshes (port of ``repro.launch.mesh``) as
``torch.distributed.device_mesh.DeviceMesh``es.

Both are FUNCTIONS, never module-level constants: importing this module
touches no process-group state, as the reference's never touches jax
device state.  A DeviceMesh spans the ranks of a process group that is
already running (``torch.distributed.init_process_group``), so the caller
starts one of the mesh's size first: the dry run starts a ``fake`` group
of 256 or 512 ranks (``repro_torch.launch.dryrun``), tests a ``gloo`` group
of a few CPU processes, and ``chip_smoke.py`` a 1-rank NCCL group.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model) — the pod
axis carries data parallelism only (replicated parameters, the gradient
all-reduce over the slow inter-pod links; see ``optim.compression``).
The shapes and axis names are the reference's, so the dry run's records
line up with the reference's cell for cell.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _device_type() -> str:
    """The running group's device type: "cuda" under NCCL, else "cpu"."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The reference's production mesh over a running group of 256 (512
    with ``multi_pod``) ranks."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return init_device_mesh(device_type or _device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(shape: Optional[Sequence[int]] = None,
                   axes: Optional[Sequence[str]] = None) -> DeviceMesh:
    """A mesh over every rank of the running group: by default 1-D with
    the axis "data"."""
    if shape is None:
        shape, axes = (dist.get_world_size(),), ("data",)
    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axes))
