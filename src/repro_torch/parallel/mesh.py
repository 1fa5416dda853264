"""The device mesh.

Port of ``repro.launch.mesh``, below the models so that they, the
optimizer and the checkpoints can take a mesh.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group the caller initialised, its dims named as the reference names its
axes: ``("data", "model")``, or ``("pod", "data", "model")`` across pods.
There is no ambient mesh: every function that needs one takes it as an
argument.  The backend is the process group's (NCCL across cards, gloo in
the CPU tests); nothing here picks one.

A production mesh of 256 or 512 devices is larger than any process group
the port runs, and the partition specs need only its shape, so
:func:`make_production_mesh` gives a :class:`MeshDescription`: the shape and
the axis names.  Every spec function takes a ``DeviceMesh`` or a
description (:func:`axis_sizes`), and reads its pod and data axes off it
(:func:`is_multi_pod`, :func:`data_axes`).  A description with a
``coordinate`` stands for one device of the mesh: the collectives of
:mod:`~repro_torch.parallel.collectives` take it with ``meta`` tensors and
give ``meta`` results of the gathered or scattered shape (the dry run per
device, ``launch/dryrun.py --mesh production``).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple


class MeshDescription(NamedTuple):
    """A mesh's shape and axis names, with no process behind it (the
    attributes a ``DeviceMesh`` has under the same names), and optionally
    the coordinate of the one device it stands for."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]
    coordinate: Optional[Tuple[int, ...]] = None

    def get_local_rank(self, name: str) -> int:
        """The described device's index along axis ``name``
        (``DeviceMesh.get_local_rank``); raises without a coordinate."""
        if self.coordinate is None:
            raise ValueError("a MeshDescription without a coordinate stands for no device")
        return self.coordinate[self.mesh_dim_names.index(name)]

    def at(self, **index: int) -> "MeshDescription":
        """This description standing for the device at ``index`` ({axis:
        index}; axes not named at 0)."""
        unknown = set(index) - set(self.mesh_dim_names)
        if unknown:
            raise ValueError(f"no axes {sorted(unknown)} in {self.mesh_dim_names}")
        coord = tuple(int(index.get(a, 0)) for a in self.mesh_dim_names)
        if any(not 0 <= c < n for c, n in zip(coord, self.shape)):
            raise ValueError(f"coordinate {coord} outside the mesh {self.shape}")
        return self._replace(coordinate=coord)


def make_production_mesh(*, multi_pod: bool = False) -> MeshDescription:
    """The reference's production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return MeshDescription((2, 16, 16), ("pod", "data", "model"))
    return MeshDescription((16, 16), ("data", "model"))


def is_description(mesh) -> bool:
    return isinstance(mesh, MeshDescription)


def make_host_mesh(shape=(1, 1), axes=("data", "model"), device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the initialised process group,
    which must have ``prod(shape)`` ranks; rank ``r`` sits at the row-major
    coordinate of ``r``.  Raises where no process group is initialised, or
    where its size is not the mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised torch.distributed process group")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshDescription`."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, tuple(mesh.shape)))


def is_multi_pod(mesh) -> bool:
    return "pod" in axis_sizes(mesh)


def data_axes(mesh) -> tuple:
    """The mesh's data axes, every axis but "model" in mesh order:
    ("data",), or ("pod", "data") across pods (the reference's
    ``data_axes(multi_pod)``, read off the mesh)."""
    return tuple(a for a in axis_sizes(mesh) if a != "model")
