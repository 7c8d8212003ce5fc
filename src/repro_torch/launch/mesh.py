"""Device meshes of the port (``repro.launch.mesh``).

The dry run (``launch/dryrun.py``) lays the production mesh, 16 x 16
``(data, model)`` or 2 x 16 x 16 ``(pod, data, model)``, over a FAKE
process group: ``torch.distributed``'s ``"fake"`` backend, whose
collectives return tensors of the right shape and move nothing, so one
process stands in for every rank.  Each mesh is made by a FUNCTION,
never a module constant, so that importing this module starts no
process group.

:class:`MeshShape` is a mesh's axis names and sizes alone: the rule
tables of ``launch/sharding.py`` read only those, so the tests build
them without a process group.  A ``DeviceMesh`` has the same two
properties.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, NamedTuple, Tuple

import torch


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a :class:`MeshShape` or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def production_shape(multi_pod: bool = False) -> MeshShape:
    """Single pod: 16 x 16 = 256 cards ``(data, model)``; multi-pod:
    2 x 16 x 16 = 512 ``(pod, data, model)``."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def fake_device_type() -> str:
    """The device of the dry run's stand-in tensors: ``cuda`` where this
    torch can run CUDA, else ``cpu``.  (A CPU-only torch cannot hold a
    CUDA fake through autograd: its device guard aborts the process.)
    Sizes, FLOPs and bytes do not depend on it."""
    return "cuda" if torch.cuda.is_available() else "cpu"


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A fake process group of ``size`` ranks, this process rank 0, for
    the duration of the block.  Refuses to replace a real group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is initialized; the "
                               "dry run needs its own fake one")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh_from_shape(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    process group, whose size must be ``prod(shape)`` (inside
    :func:`fake_world` for the dry run)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} needs a process group of {n} "
                           "ranks (fake_world)")
    return init_device_mesh(fake_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (:func:`production_shape`) as a
    ``DeviceMesh``; call inside ``fake_world(256)`` (``512`` with
    ``multi_pod``)."""
    ms = production_shape(multi_pod)
    return make_mesh_from_shape(ms.shape, ms.axis_names)


def single_device_mesh(axes: Tuple[str, ...] = ("data", "model")):
    """A mesh of one device on every axis; call inside
    ``fake_world(1)``."""
    return make_mesh_from_shape((1,) * len(axes), axes)


def serving_mesh(spec: str) -> MeshShape:
    """Parse a ``DxM`` serving-mesh flag ("1x4", "2x2") into the
    ``(data, model)`` shape of the serving engine's mesh, and check that
    this host has D*M cards.  Serving on it is ROADMAP A10: the engine's
    mesh path builds its ``DeviceMesh`` over NCCL from this shape."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"mesh spec must be DxM (e.g. 1x4, 2x2), got {spec!r}") from None
    n = d * m
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"mesh {spec} needs {n} cards but torch sees "
                           f"{have}")
    return MeshShape(("data", "model"), (d, m))
