"""Production meshes over a fake process group.

Counterpart of ``repro.launch.mesh``. The reference lays its 256- or
512-chip meshes over XLA's host placeholder devices; here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over a *fake* process group
(``init_process_group("fake", ...)``, torch's test group whose
collectives return at once): this process is rank 0 of N, and every
tensor placed on the mesh holds rank 0's shard. The group exists only
inside :func:`fake_mesh` and is destroyed on the way out, so a real group
(gloo, NCCL) can be made in the same process afterwards; importing this
module touches no distributed state.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axis_names: Sequence[str]
              ) -> Iterator[DeviceMesh]:
    """A mesh of ``shape`` named ``axis_names`` over a fake group of
    prod(shape) ranks, this process rank 0. Refuses to run inside another
    default group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; a fake "
                           "mesh needs its own default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axis_names))
    finally:
        dist.destroy_process_group()


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """16x16 = 256-chip pod, or 2x16x16 = 512-chip two-pod mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """Context manager yielding the production mesh over a fake group."""
    return fake_mesh(*production_shape(multi_pod))


def data_axes(mesh) -> tuple:
    """Mesh axes that shard the batch dimension."""
    if "pod" in mesh.mesh_dim_names:
        return ("pod", "data")
    return ("data",)


def n_chips(mesh) -> int:
    return mesh.size()
