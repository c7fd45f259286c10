"""Production mesh construction.

Ports ``repro/launch/mesh.py``: the production mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of 16 x 16 over ("data",
"model"), or 2 x 16 x 16 over ("pod", "data", "model") for two pods, built
on the process group that is current. Nothing here runs at import.

The reference's dry run forces a 512-device host platform before JAX
starts (its ``XLA_FLAGS`` line). The counterpart here is ``fake_world``: a
``fake`` process group of N ranks opened in this one process, which plays
rank 0. Its collectives are recorded by whoever watches the dispatcher and
never executed; their outputs are not results.
"""
from __future__ import annotations

import contextlib

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_shape(multi_pod: bool = False) -> tuple[tuple[int, ...],
                                                   tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(multi_pod: bool = False, *,
                         device_type: str = "cuda") -> DeviceMesh:
    """The production mesh, 16 x 16 per pod, 2 pods multi-pod, on the
    current process group (whose world size must be its size)."""
    shape, axes = mesh_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))


def data_axis_size(mesh: DeviceMesh) -> int:
    size = axis_size(mesh, "data")
    if "pod" in mesh.mesh_dim_names:
        size *= axis_size(mesh, "pod")
    return size


def model_axis_size(mesh: DeviceMesh) -> int:
    return axis_size(mesh, "model")


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``fake`` process group of ``world_size`` ranks in this process, as
    rank 0, destroyed on exit. Refuses to open over a group already open."""
    # the one import of the fake backend (it registers "fake" with c10d)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
