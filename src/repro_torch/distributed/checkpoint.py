"""Checkpoint/restore with an integrity manifest + async writes, in the
reference's on-disk format (``distributed/checkpoint.py``).

Layout:  <dir>/step_<N>/
            manifest.json       step, extra, and per leaf shape, dtype, crc32
            <leaf-name>.npy     one file per tree leaf

A leaf is named after its path as ``jax.tree_util.keystr`` spells it
(``tree_leaves_with_path``), runs of other characters than
``[a-zA-Z0-9_.-]`` made ``_``; bfloat16 is stored as its uint16 bits.
The format is the reference's, so a checkpoint written by either package
restores in the other, bit for bit: a second weight carrier beside
``params_from_numpy``.

  * writes go to a temp dir + atomic rename, so a failure mid-save never
    corrupts the latest-good checkpoint;
  * async: ``save_async`` snapshots to host memory, then writes on a
    worker thread, so at most one write is in flight;
  * on a mesh, a DTensor leaf is gathered whole on the calling (main)
    thread — a collective every rank of its mesh joins, never on the
    writer thread — and rank 0 of the default process group writes;
  * restore verifies crc32 per leaf and can place each leaf onto a mesh
    (``shardings``: the elastic-restart path, checkpoint written on mesh
    A, restored onto mesh B).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.distributed.elastic import place
from repro_torch.models.blocks import (tree_leaves_with_path, tree_map,
                                       tree_map_with_path)
from repro_torch.models.layers import full_value

_SAFE = re.compile(r"[^a-zA-Z0-9_.-]+")

#: dtypes numpy's npy format can't express — stored as same-width uints
_EXOTIC = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
           "float8_e5m2": np.uint8}
#: the integer type, by width, whose bits torch views as such a dtype
_BITS = {2: (torch.int16, np.int16), 1: (torch.uint8, np.uint8)}


def _leaf_name(path: str) -> str:
    return _SAFE.sub("_", path).strip("_") or "root"


def _flatten(tree):
    leaves = tree_leaves_with_path(tree)
    names = [_leaf_name(p) for p, _ in leaves]
    assert len(set(names)) == len(names), "leaf name collision"
    return names, [v for _, v in leaves]


def _writer() -> bool:
    """Whether this process writes checkpoints: rank 0, or the only one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array stored for it, and its logical dtype."""
    t = full_value(leaf).detach().cpu()
    logical = str(t.dtype).removeprefix("torch.")
    if logical in _EXOTIC:    # npy can't round-trip bf16/f8 portably
        bits = t.view(_BITS[t.element_size()][0]).numpy()
        return bits.view(_EXOTIC[logical]), logical
    return t.numpy(), logical


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Synchronous checkpoint write. Returns the checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    names, leaves = _flatten(tree)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for name, leaf in zip(names, leaves):
        arr, logical = _host(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {
            "shape": list(arr.shape), "dtype": logical,
            "crc32": zlib.crc32(arr.tobytes()),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncCheckpointer:
    """Double-buffered async writer: snapshot on call, write on a thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None

    def save_async(self, step: int, tree, extra=None):
        self.wait()   # at most one write in flight
        # a copy on the host: the caller may update the tree in place.
        # Gathering a DTensor is a collective: every rank of its mesh
        # gathers here, on its own thread, and rank 0 alone writes
        host_tree = tree_map(
            lambda x: full_value(x).detach().to("cpu", copy=True), tree)
        if not _writer():
            return

        def work():
            save(self.ckpt_dir, step, host_tree, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def restore(ckpt_dir: str, tree_like, step: int | None = None,
            shardings=None, verify: bool = True, *, mesh=None,
            device=None):
    """Restore into the structure of ``tree_like`` (a tree of tensors,
    the meta device's included: only shapes are read).  Each leaf keeps
    the stored dtype and goes to ``device`` (None: the device of its
    ``tree_like`` leaf, the CPU for a meta leaf).

    ``shardings``: optional tree of ``sharding.Spec`` (or None leaves) on
    the TARGET ``mesh``: a leaf that has a spec comes back as a DTensor on
    that mesh, this rank holding its block only — the elastic-restart
    path.  Every rank of that mesh reads the files.
    Returns (tree, step, extra)."""
    if shardings is not None and mesh is None:
        raise ValueError("restore(shardings=...) needs the target mesh")
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    _flatten(tree_like)          # the name-collision check
    shd_of = dict(tree_leaves_with_path(shardings)) if shardings else {}

    def load(p, like):
        name = _leaf_name(p)
        meta = manifest["leaves"][name]
        arr = np.load(os.path.join(path, name + ".npy"))
        if verify and zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"checksum mismatch for leaf {name}")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        if meta["dtype"] in _EXOTIC:    # no ml_dtypes: view the bits
            t = torch.from_numpy(arr.view(_BITS[arr.itemsize][1]))
            t = t.view(getattr(torch, meta["dtype"]))
        else:
            t = torch.from_numpy(arr)
        spec = shd_of.get(p)
        if spec is not None:    # this rank's block, on the mesh's device
            return place(t, spec, mesh)
        dev = device if device is not None else getattr(like, "device", None)
        if dev is None or torch.device(dev).type == "meta":
            dev = "cpu"
        return t.to(dev)

    return tree_map_with_path(load, tree_like), step, \
        manifest.get("extra", {})
