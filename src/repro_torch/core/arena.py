"""Pooled host staging buffers for the round pipeline (zero-copy assemble).

Every dispatch round needs one ``[G_pad, RF_DEPTH, tile]`` host tile stack
plus a ``[G_pad]`` context-id vector.  Allocating those fresh per round is
the single biggest host cost on the serving hot path: a large ``np.zeros``
(page-fault memset), the per-group ``np.concatenate`` intermediates, and a
``reshape(...).transpose(...)`` copy — four full-buffer passes around a
device launch that is itself one kernel (the "overlay tax" of
JIT-assembled overlays, arXiv:1603.01187).

``RoundArena`` removes the allocation half of that tax.  Blocks are pooled
in free lists bucketed by ``(g_pad, rf_depth, tile, dtype)`` — the same
power-of-two ``g_pad`` bucketing ``Overlay.plan`` uses, so a steady workload
cycles through a handful of buckets and the pool converges to
``max_inflight + 1`` blocks per bucket.  A checked-out block is guaranteed
all-zero in every row a scatter could have dirtied before: each block
tracks a ``dirty_rows`` high-water mark (the max register-file row any
round ever wrote) and checkout scrubs only ``x[:, :dirty_rows, :]`` —
typically a handful of input rows, not the full ``RF_DEPTH`` image.

Lifecycle (mirrors the plan-pin protocol in ``core.overlay``)::

    block = arena.checkout(g_pad, tile, dtype)   # assemble (scatter into it)
    ...                                          # device copies it on launch
    arena.recycle(block)                         # plan.release(), post-collect

``torch.from_numpy(block.x).to(device)`` from pageable host memory returns
only after the host buffer has been read, so the host block is safe to
recycle as soon as ``assemble`` has placed it; the engine recycles at
``plan.release(bank)``, which it already calls exactly once per round
after delivery.  (A pinned, ``non_blocking`` transfer would need an event
before the recycle; the port does not use one.)  The sync
``Overlay.dispatch`` oracle never uses an arena (its collect is lazy, so
there is no single safe recycle point) — arenas are an engine-path
optimisation, opted into via ``Overlay(arena=...)``.

Thread safety: checkout/recycle take a small lock (the pump thread and a
caller thread may race); the scatter into a checked-out block is lock-free
because a block is owned by exactly one round between checkout and recycle.
"""

from __future__ import annotations

import threading

import numpy as np

from repro_torch.core.isa import RF_DEPTH

#: free-list depth per shape bucket; beyond this, recycled blocks are
#: dropped (a burst of odd shapes must not pin host memory forever)
DEFAULT_MAX_FREE_PER_BUCKET = 8


class ArenaBlock:
    """One pooled ``([g_pad, rf_depth, tile] x, [g_pad] ids)`` staging pair.

    ``dirty_rows`` is the block's register-file-row high-water mark: rows
    ``>= dirty_rows`` of ``x`` are guaranteed zero.  A scatter that writes
    rows ``[0, n)`` must raise it to at least ``n`` (``Overlay.assemble``
    does); checkout scrubs ``[0, dirty_rows)`` back to zero so a recycled
    block is bit-identical to a fresh ``np.zeros``.
    """

    __slots__ = ("x", "ids", "bucket", "dirty_rows")

    def __init__(self, x: np.ndarray, ids: np.ndarray, bucket: tuple):
        self.x = x
        self.ids = ids
        self.bucket = bucket
        self.dirty_rows = 0

    @property
    def nbytes(self) -> int:
        return self.x.nbytes + self.ids.nbytes


class RoundArena:
    """Shape-bucketed pool of reusable host staging blocks."""

    def __init__(self, max_free_per_bucket: int = DEFAULT_MAX_FREE_PER_BUCKET):
        self.max_free_per_bucket = max_free_per_bucket
        self._free: dict[tuple, list[ArenaBlock]] = {}
        self._lock = threading.Lock()
        # counters (read via stats(); arena leaks show up as outstanding
        # never returning to zero instead of as silent RSS growth)
        self.allocations = 0      # fresh np.zeros blocks ever created
        self.checkouts = 0        # blocks handed to rounds
        self.recycles = 0         # blocks returned to a free list
        self.discards = 0         # returned blocks dropped (bucket full)
        self.outstanding = 0      # checked out and not yet recycled
        self.peak_outstanding = 0
        self.pooled_bytes = 0     # bytes currently parked in free lists

    # ------------------------------------------------------------ lifecycle
    def checkout(self, g_pad: int, tile: int, dtype,
                 rf_depth: int = RF_DEPTH) -> ArenaBlock:
        """Hand out an all-zero ``[g_pad, rf_depth, tile]`` block."""
        key = (int(g_pad), int(rf_depth), int(tile), np.dtype(dtype).str)
        with self._lock:
            free = self._free.get(key)
            block = free.pop() if free else None
            if block is not None:
                self.pooled_bytes -= block.nbytes
            self.checkouts += 1
            self.outstanding += 1
            self.peak_outstanding = max(self.peak_outstanding,
                                        self.outstanding)
            if block is None:
                self.allocations += 1
        if block is None:
            block = ArenaBlock(
                x=np.zeros((g_pad, rf_depth, tile), np.dtype(dtype)),
                ids=np.zeros(g_pad, np.int32), bucket=key)
        elif block.dirty_rows:
            # scrub only the rows any past round wrote; rows above the
            # high-water mark are provably still zero
            block.x[:, :block.dirty_rows, :] = 0
            block.dirty_rows = 0
        return block

    def recycle(self, block: ArenaBlock | None) -> None:
        """Return a block to its bucket's free list (idempotent on None)."""
        if block is None:
            return
        with self._lock:
            self.outstanding -= 1
            free = self._free.setdefault(block.bucket, [])
            if len(free) < self.max_free_per_bucket:
                free.append(block)
                self.recycles += 1
                self.pooled_bytes += block.nbytes
            else:
                self.discards += 1

    # ------------------------------------------------------------ telemetry
    def stats(self) -> dict:
        with self._lock:
            return {
                "buckets": len(self._free),
                "free_blocks": sum(len(v) for v in self._free.values()),
                "allocations": self.allocations,
                "checkouts": self.checkouts,
                "recycles": self.recycles,
                "discards": self.discards,
                "outstanding": self.outstanding,
                "peak_outstanding": self.peak_outstanding,
                "pooled_bytes": self.pooled_bytes,
            }
