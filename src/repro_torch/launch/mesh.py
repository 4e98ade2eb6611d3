"""Production mesh topology and the meshes built from it (the JAX
package's ``launch/mesh.py``).

A *mesh* here is either a ``torch.distributed`` ``DeviceMesh`` with
named dimensions or any object with ``.axis_names`` and a ``.shape``
mapping of axis name to size (``fleet.extract.MeshSpec``, which sizes
per-device shards from the topology alone).  :func:`axis_sizes` reads
both.

``make_production_mesh`` builds the 16 x 16 (or 2 x 16 x 16) mesh; the
dry run builds it over the ``"fake"`` process group of
:func:`fake_world`, whose collectives do nothing, so one process stands
for 256 or 512 ranks.  ``make_debug_mesh`` factors the ranks alive.
"""
from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> tuple[tuple[str, int], ...]:
    """(axis, size) pairs of the production mesh: 16x16 = 256 ranks per
    pod, 2 pods = 512 ranks multi-pod."""
    if multi_pod:
        return (("pod", 2), ("data", 16), ("model", 16))
    return (("data", 16), ("model", 16))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a duck-typed mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def dp_axes(mesh) -> tuple[str, ...]:
    """Axes that carry data parallelism."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def _fake_store():
    """PyTorch's store for the ``"fake"`` backend (importing it registers
    the backend); raises with the reason where this PyTorch lacks it."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                      # pragma: no cover
        raise RuntimeError(
            "the dry run needs PyTorch's \"fake\" process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"PyTorch ({torch.__version__}) does not provide: {e}") from e
    if "fake" not in dist.Backend.backend_list:   # pragma: no cover
        raise RuntimeError("importing fake_pg did not register the "
                           "\"fake\" process-group backend")
    return FakeStore()


@contextlib.contextmanager
def fake_world(world_size: int):
    """A ``"fake"`` default process group of ``world_size`` ranks, this
    process rank 0, for the body of the ``with``: meshes over it can be
    built and DTensor issues its collectives into it, which move
    nothing.  Raises if a process group is already initialised."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def init_local_process_group(device_type: str) -> None:
    """Initialise the default process group if it is not: from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``)
    where it is set, else as the only rank (an in-memory store).  NCCL
    for ``cuda``, gloo for the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The production ``DeviceMesh``: (data 16, model 16), or (pod 2,
    data 16, model 16) multi-pod, named as the reference's.  The default
    process group must hold exactly that many ranks (the dry run opens
    one with :func:`fake_world`)."""
    from torch.distributed.device_mesh import init_device_mesh
    axes = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, tuple(s for _, s in axes),
                            mesh_dim_names=tuple(a for a, _ in axes))


def make_debug_mesh(devices: int | None = None, device_type: str = "cuda"):
    """A (data, model) ``DeviceMesh`` over the ranks alive (or the first
    ``devices`` of them), with the reference's factoring: the model
    axis is 4, 2 or 1, the largest that divides the count.  Initialises
    a process group where none is (one rank: a (1, 1) mesh)."""
    from torch.distributed.device_mesh import init_device_mesh
    init_local_process_group(device_type)
    n = devices or dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
