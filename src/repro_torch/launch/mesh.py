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
import os
from typing import Iterator, NamedTuple, Tuple

import torch

from repro_torch.core.tp import axis_sizes  # noqa: F401  (re-exported)


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


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


def parse_mesh(spec: str) -> Tuple[int, int]:
    """``(D, M)`` of a ``DxM`` serving-mesh flag ("1x4", "2x2")."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(
            f"mesh spec must be DxM (e.g. 1x4, 2x2), got {spec!r}") from None
    return d, m


def serving_mesh(spec: str, device_type: str = "cuda",
                 share_card: bool = False):
    """The serving engine's ``(data, model)`` ``DeviceMesh`` of a ``DxM``
    flag ("1x4", "2x2") over the initialised process group, whose size
    must be D*M.  On ``cuda`` each rank takes a card of its own, so the
    host must show D*M cards, unless ``share_card`` (ranks that share one
    card over gloo: a check of the mesh path on a one-card host)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    d, m = parse_mesh(spec)
    n = d * m
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"mesh {spec} needs a process group of {n} ranks "
                           f"(init_serving_world under torchrun "
                           f"--nproc-per-node {n}); it has {have}")
    if device_type == "cuda" and not share_card:
        have = torch.cuda.device_count()
        if have < n:
            raise RuntimeError(f"mesh {spec} needs {n} cards but torch sees "
                               f"{have}")
    return init_device_mesh(device_type, (d, m),
                            mesh_dim_names=("data", "model"))


def init_serving_world() -> Tuple[int, int, int]:
    """Under ``torchrun``: the NCCL process group of ``WORLD_SIZE`` ranks,
    this process on ``cuda:LOCAL_RANK``.  Returns (rank, world size,
    local rank).  (The CPU tests make their own gloo group.)"""
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", rank=rank, world_size=world,
                            device_id=torch.device("cuda", local))
    return rank, world, local
