"""Serving placement: which device each overlay-serving replica runs on.

Functions, not module-level state, so importing never touches CUDA.  The
devices are ``torch.device``s.  Several replicas may share one device —
on one GPU every replica does — and each then runs on its own CUDA
stream (``launch.serve.OverlayServer.stream``).
"""

from __future__ import annotations

import torch

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
