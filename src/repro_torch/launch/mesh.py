"""Mesh construction: the training meshes and the serving placement.

Functions, not module-level state, so importing never touches CUDA or a
process group.

Training: a ``DeviceMesh`` over the ranks of the default process group,
one rank per GPU.  Single pod: 16x16 = 256 ranks ('data','model').
Multi-pod: 2 pods x 256 = 512 ranks ('pod','data','model'); the pod axis
carries only data-parallel traffic.  ``make_mesh_from_devices`` is the
elastic re-mesh over the surviving ranks.

Serving: the devices are ``torch.device``s.  Several replicas may share
one device — on one GPU every replica does — and each then runs on its
own CUDA stream (``launch.serve.OverlayServer.stream``).
"""

from __future__ import annotations

import math

import torch


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over the default process group,
    which must hold exactly 256 ranks (512 with ``multi_pod``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_mesh_shape(multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = math.prod(shape)
    if world != need:
        raise ValueError(
            f"the production mesh {dict(zip(names, shape))} needs a world "
            f"of {need} ranks (one per GPU); this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_from_devices_shape(n: int, model_parallel: int = 16):
    """(data, model) of the largest mesh over ``n`` survivors: the model
    axis halves until it divides ``n``."""
    model = model_parallel
    while model > 1 and n % model:
        model //= 2
    return n // model, model


def make_mesh_from_devices(ranks, model_parallel: int = 16,
                           device_type: str = "cuda"):
    """Elastic re-mesh: the largest (data, model) ``DeviceMesh`` over the
    live ``ranks`` of the default process group (the first data x model
    of them, row-major).  Every rank of the group must call it — a mesh's
    process groups are made collectively — and it returns the mesh on
    the ranks the mesh holds, None on the others."""
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(ranks)
    data, model = mesh_from_devices_shape(len(ranks), model_parallel)
    grid = torch.tensor(ranks[: data * model]).reshape(data, model)
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))
    return mesh if mesh.get_coordinate() is not None else None


#: the sharing key of the CPU, whose ``torch.device`` has no index
CPU_KEY = -1


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of the machine, in index order; raises where
    there is none (the serving fleet runs on the GPU unless the caller
    names its devices)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device: the serving fleet runs on the GPU unless the "
            "caller passes devices=[torch.device('cpu'), ...]")
    return [torch.device("cuda", i) for i in range(n)]


def device_key(d: torch.device) -> int:
    """The device's index, or ``CPU_KEY`` for the CPU: what replicas are
    grouped by when they share a device."""
    return CPU_KEY if d.index is None else d.index


def make_serving_mesh(n_replicas: int | None = None, devices=None):
    """One device per overlay-serving replica (the sharded context banks).

    Serving replicas are INDEPENDENT single-device workers — each hosts
    its own ContextBank working set and executes its own rounds — so the
    'mesh' is just a placement list.  ``devices=None`` means every CUDA
    device.  When ``n_replicas`` exceeds the device count the assignment
    wraps (several replicas share a device): correctness is unchanged —
    residency routing and the directory work per replica, not per device
    — which is what lets 2/4 replicas run on one GPU, or on the CPU in
    the tests.
    """
    if devices is None:
        devices = cuda_devices()
    if n_replicas is None:
        n_replicas = len(devices)
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    return [devices[i % len(devices)] for i in range(n_replicas)]


def device_sharing(devices) -> dict[int, int]:
    """How many serving replicas share each physical device.

    ``{device key: replica count}`` for a ``make_serving_mesh`` placement
    list (``device_key``: the CUDA index, ``CPU_KEY`` for the CPU).
    Counts > 1 mean replicas share one device: correctness is unchanged,
    but cross-replica overlap is then the device's own concurrency of
    streams (kernels of different streams may run side by side on one
    GPU; copies from pageable host memory serialise on the host), not
    separate hardware.
    """
    sharing: dict[int, int] = {}
    for d in devices:
        k = device_key(d)
        sharing[k] = sharing.get(k, 0) + 1
    return sharing


def least_shared_device(pool, in_use):
    """The pool device hosting the fewest current serving replicas.

    ``pool`` is the candidate device list (usually ``cuda_devices()``),
    ``in_use`` the fleet's current placement list (one entry per live
    replica, duplicates meaning replicas share that device).  This is the
    elastic-autoscaling placement rule: a new replica lands where it
    oversubscribes the hardware least.  Ties break on the device key for
    determinism.
    """
    if not pool:
        raise ValueError("least_shared_device: empty device pool")
    sharing = device_sharing(in_use)
    return min(pool, key=lambda d: (sharing.get(device_key(d), 0),
                                    device_key(d)))
