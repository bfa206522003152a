"""The overlay object: compile-once executor + fast context switching.

Public API::

    ov = Overlay(s_max=16)                      # 'configure the FPGA' once
    ctx = ov.load(compile_program(dfg))         # context switch (no recompile)
    ys = ov(ctx, xs)                            # stream a batch through

``Overlay.load`` is the paper's 0.27 µs daisy-chain analogue: only int32
instruction words + constant tables move; the executor kernel is untouched.

There is one executor and no backend switch: ``execute`` and ``__call__``
go through ``kernels.tmfu.ops``, whose wrappers launch the hand-written
CUDA kernel for a CUDA tensor and take the plain executor (``core.vm``)
only for a tensor that lies on the CPU.

Multi-tenant dispatch is a STAGED PIPELINE so a serving engine can overlap
the host-side work of one round with the device execution of another::

    plan     = ov.plan(bank, requests)     # residency + tile layout (host)
    batch    = ov.assemble(plan)           # one [G,RF,tile] host buffer
    ys       = ov.execute(bank, batch)     # async device launch, NO block
    outs     = ov.collect(plan, ys)        # slice per request (views)

``Overlay.dispatch`` is exactly ``collect(execute(assemble(plan)))`` — the
synchronous composition is the bit-for-bit oracle for the async engine in
``launch.serve.OverlayServer``, which interleaves the stages of successive
rounds.  ``plan(..., pin=True)`` pins every referenced context in the bank
until ``plan.release(bank)``, so a later round's planning can never evict
a context out from under an in-flight launch (see ``core.bank``).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import vm
from repro_torch.core.arena import ArenaBlock, RoundArena
from repro_torch.core.bank import (DEFAULT_MAX_OUTPUTS, BankError, ContextBank,
                             context_key)
from repro_torch.core.dfg import DFG
from repro_torch.core.isa import RF_DEPTH, Program, encode
from repro_torch.core.schedule import Schedule, schedule
from repro_torch.core.vm import (Context, host_dtype, make_context, pad_inputs,
                                 resolve_device, to_host)
from repro_torch.kernels.tmfu import ops as tmfu_ops

#: default per-tile batch width for bank dispatch (one CUDA block of lanes)
DISPATCH_TILE = 128


@dataclasses.dataclass
class CompiledKernel:
    dfg: DFG
    sched: Schedule
    program: Program


@dataclasses.dataclass
class _GroupSpec:
    """Tile layout of one kernel group inside a dispatch round."""

    key: tuple                # context identity (bank.context_key)
    idxs: list                # request indices, submission order
    kernel: CompiledKernel
    slot: int                 # bank slot the group's tiles select
    lens: list                # per-request batch lengths
    total: int                # sum(lens)
    n_tiles: int              # ceil(total / tile)
    start: int                # first row of this group in the tile stack


@dataclasses.dataclass
class DispatchPlan:
    """Host-side layout of one mixed-kernel round (output of ``plan``).

    Carries everything ``assemble``/``collect`` need to build the tile
    stack and slice results back out, plus the request list itself so the
    stages cannot be fed mismatched arguments.  When built with
    ``pin=True`` the referenced contexts are pinned in the bank; call
    ``release(bank)`` exactly once after ``collect`` (or on abandon).
    """

    tile: int
    requests: list            # the [(CompiledKernel, xs)] pairs, verbatim
    groups: list              # [_GroupSpec]
    g_total: int              # live tile rows
    g_pad: int                # pow2-padded tile rows (staging-block bucket)
    pinned: bool = False
    arena: RoundArena | None = None   # pool the staging block came from
    block: ArenaBlock | None = None   # host block owned until release()

    @property
    def n_kernels(self) -> int:
        return len(self.groups)

    def release(self, bank: ContextBank) -> None:
        """Drop this plan's eviction pins and recycle its arena block.

        Called exactly once per round after delivery (``collect``); a
        no-op for unpinned, arena-less plans.  The host staging block is
        safe to reuse here because ``assemble``'s device placement COPIES
        it (and has returned) — the launch never aliases host memory.
        """
        if self.pinned:
            self.pinned = False
            for g in self.groups:
                bank.unpin(g.kernel)
        if self.arena is not None:
            self.arena.recycle(self.block)
            self.arena = None
            self.block = None


def _gather_live(ys, n_tiles: int, n_out: int) -> np.ndarray:
    """Device-side live-rows slice + transpose for ``collect(host=True)``.

    Drops the padding tiles and the dead ``max_outputs`` rows BEFORE the
    host transfer, and moves the output axis outermost so each group's
    per-output flatten on the host is a contiguous view, not a copy: one
    strided device copy, one transfer of live bytes only.
    """
    return to_host(ys[:n_tiles, :n_out, :].movedim(1, 0).contiguous())


def _host_backed(arr) -> bool:
    """True when ``arr``'s buffer lives in host memory (numpy, or a CPU
    tensor) — i.e. its numpy view is zero-copy and a separate gather
    would only add a pass over the data."""
    return isinstance(arr, np.ndarray) or arr.device.type == "cpu"


def compile_program(dfg: DFG) -> CompiledKernel:
    """Full mapping flow: DFG -> schedule -> encoded context image."""
    sched = schedule(dfg)
    program = encode(sched)
    # record the RF slots of the primary outputs in the final stage stream
    final = sched.stages[-1]
    slot_of = {ins.dest: i for i, ins in enumerate(final.instrs)}
    program._output_slots = np.asarray(
        [slot_of[o] for o in dfg.outputs], dtype=np.int32)
    return CompiledKernel(dfg=dfg, sched=sched, program=program)


class Overlay:
    """A fixed executor for a family of kernels (<= s_max stages)."""

    def __init__(self, s_max: int = vm.S_MAX, dtype=torch.float32,
                 device=None, arena: RoundArena | None = None,
                 donate: bool = False):
        self.s_max = s_max
        self.dtype = dtype
        #: host-side element type of the staging buffers.  numpy has no
        #: bfloat16: a bfloat16 overlay stages float32 on the host and
        #: casts on the device (twice the transfer bytes, no host pass).
        self._np_dtype = host_dtype(dtype)
        #: device this overlay's contexts and launches live on; None =
        #: the CUDA device (raises without one; the CPU is asked for by
        #: name).  A serving replica gives its overlay and its ContextBank
        #: the same device so rounds execute where the working set is.
        self.device = resolve_device(device)
        #: host staging pool for ``assemble``; None = allocate per round.
        #: The caller owns the recycle protocol: every assembled plan must
        #: eventually see ``plan.release(bank)`` (the serving engines do).
        self.arena = arena
        #: donate the round's device tile stack to the executor, which
        #: then writes the result over it in place instead of into a
        #: second [G, RF, tile] allocation.  Contract: the caller must
        #: not read the batch after ``execute`` consumes it (the engines
        #: never do).
        self.donate = donate
        #: reusable packing scratch for ``assemble`` (grown on demand);
        #: per-overlay, so concurrent engines never share it.
        self._scratch: np.ndarray | None = None

    # --------------------------------------------------------------- context
    def load(self, kernel: CompiledKernel) -> Context:
        """Context switch: build the instruction image on this overlay's
        device."""
        return make_context(kernel.program, self.s_max, self.dtype,
                            self.device)

    # --------------------------------------------------------------- execute
    def __call__(self, ctx: Context, xs: list) -> list[torch.Tensor]:
        x = pad_inputs([torch.as_tensor(v).to(self.dtype) for v in xs],
                       device=self.device)
        ys = tmfu_ops.tmfu_pipeline(ctx, x)
        return [ys[i] for i in range(ctx.n_outputs)]

    # ---------------------------------------------------------- multi-tenant
    def load_many(self, kernels, capacity: int | None = None,
                  max_outputs: int = DEFAULT_MAX_OUTPUTS) -> ContextBank:
        """Load a family of kernels into a fresh ContextBank.

        The bank's stacked tensors feed ``tmfu_pipeline_multi`` so every
        resident kernel is reachable by slot id from ONE kernel launch.
        """
        ks = list(kernels)
        bank = ContextBank(capacity or max(len(ks), 1), s_max=self.s_max,
                           dtype=self.dtype, max_outputs=max_outputs,
                           device=self.device)
        for k in ks:
            bank.load(k)
        return bank

    def plan(self, bank: ContextBank, requests, tile: int = DISPATCH_TILE,
             pin: bool = False) -> DispatchPlan:
        """Stage 1/4 — residency + tile layout for a mixed-kernel round.

        ``requests`` is a list of ``(CompiledKernel, xs)`` pairs (``xs`` a
        list of 1-D input arrays, all the same length within a request).
        Requests are grouped by context CONTENT (not name: two distinct
        programs sharing a name must never be served from one slot), every
        group's kernel is made bank-resident (this is the prefetch point —
        the device context writes overlap whatever is already executing),
        and each group gets a run of fixed-width tile rows.  The round may
        reference at most ``bank.capacity`` distinct kernels; larger
        working sets are split into rounds by ``launch.serve``.

        With ``pin=True`` each referenced context is refcount-pinned until
        ``DispatchPlan.release(bank)`` — required whenever another round
        may load contexts between this plan and its ``execute``.
        """
        groups: OrderedDict[tuple, list[int]] = OrderedDict()
        for i, (k, _) in enumerate(requests):
            groups.setdefault(context_key(k.program), []).append(i)
        if len(groups) > bank.capacity:
            raise BankError(
                f"batch references {len(groups)} kernels > bank capacity "
                f"{bank.capacity}; split into rounds (see OverlayServer)")

        specs: list[_GroupSpec] = []
        g_total = 0
        try:
            for key, idxs in groups.items():
                kern = requests[idxs[0]][0]
                slot = bank.pin(kern) if pin else bank.load(kern)
                lens = [int(np.shape(requests[i][1][0])[0]) for i in idxs]
                total = sum(lens)
                n_tiles = -(-total // tile)
                specs.append(_GroupSpec(key=key, idxs=idxs, kernel=kern,
                                        slot=slot, lens=lens, total=total,
                                        n_tiles=n_tiles, start=g_total))
                g_total += n_tiles
        except BankError:
            # unwind pins already taken by this (never-returned) plan — a
            # caller can't release() a plan it never got
            if pin:
                for g in specs:
                    bank.unpin(g.kernel)
            raise
        g_pad = 1 << (g_total - 1).bit_length() if g_total else 0
        return DispatchPlan(tile=tile, requests=list(requests), groups=specs,
                            g_total=g_total, g_pad=g_pad, pinned=pin)

    def assemble(self, plan: DispatchPlan):
        """Stage 2/4 — build the round's host tile stack (single pass).

        Packs every request into ONE ``[G_pad, RF_DEPTH, tile]`` host
        buffer (a single device transfer — the hot serving path must not
        pay per-group/per-tile dispatches) plus the per-tile context-id
        vector.  The tile count is padded to the next power of two with
        replicas of tile 0 so repeated mixed workloads land in a handful
        of staging-block buckets (the arena pools by ``g_pad``).

        Each group's rows are concatenated ONCE into a pooled overlay
        scratch (``np.concatenate(..., out=)`` — no intermediate
        allocation) and stored with a single strided scatter into the
        group's tile run — the legacy per-group ``np.zeros`` + concat
        copy + ``reshape().transpose()`` triple pass survives only as
        ``assemble_reference``, the paired-benchmark baseline.  With
        ``self.arena`` set the destination is a recycled pool block
        (scrubbed to its dirty high-water mark, so contents are
        bit-identical to a fresh zeros) that ``plan.release(bank)``
        returns to the pool.

        Pure host work (numpy) plus the device placement: in the async
        engine this stage runs for round N+1 while round N executes on
        device.  The placement is a copy out of pageable host memory, so
        it returns only after the host block has been read and the block
        may be recycled while the device copy is still queued.  (Pinned
        staging with ``non_blocking=True`` would need an event before the
        recycle; not done here.)  Returns ``(id_arr, x_stack)`` on
        ``self.device``, or ``None`` when the round is all zero-length
        requests (nothing to launch).
        """
        if plan.g_total == 0:
            return None
        np_dtype = self._np_dtype
        tile = plan.tile
        if self.arena is not None:
            if plan.block is not None:       # re-assembled plan: no leak
                plan.arena.recycle(plan.block)
            block = self.arena.checkout(plan.g_pad, tile, np_dtype)
            plan.arena, plan.block = self.arena, block
            x_np, ids_np = block.x, block.ids
        else:
            block = None
            x_np = np.zeros((plan.g_pad, RF_DEPTH, tile), np_dtype)
            ids_np = np.zeros(plan.g_pad, np.int32)
        max_cols = max((g.n_tiles for g in plan.groups), default=0) * tile
        scratch = self._scratch
        if (scratch is None or scratch.dtype != np_dtype
                or scratch.shape[1] < max_cols):
            scratch = self._scratch = np.empty((RF_DEPTH, max_cols), np_dtype)
        dirty = 0
        for g in plan.groups:
            if g.n_tiles == 0:
                continue
            n_in = len(g.kernel.dfg.inputs)
            dirty = max(dirty, n_in)
            nt = g.n_tiles
            buf = scratch[:n_in, :nt * tile]    # [n_in, nt*tile] pooled
            for j in range(n_in):
                np.concatenate([np.asarray(plan.requests[i][1][j], np_dtype)
                                for i in g.idxs], out=buf[j, :g.total])
            if g.total < nt * tile:
                buf[:, g.total:] = 0            # zero tail of the last tile
            # single strided store: row j of the scratch lands in RF row j
            # of every tile in the group's run
            x_np[g.start:g.start + nt, :n_in, :] = \
                buf.reshape(n_in, nt, tile).transpose(1, 0, 2)
            ids_np[g.start:g.start + g.n_tiles] = g.slot
        # padding tiles replicate tile 0; only its dirty rows can be
        # nonzero, so copying those rows is bit-identical to a full copy
        if plan.g_total < plan.g_pad:
            x_np[plan.g_total:, :dirty] = x_np[0, :dirty]
        ids_np[plan.g_total:] = ids_np[0]
        if block is not None:
            block.dirty_rows = max(block.dirty_rows, dirty)
        return self._place(ids_np, torch.int32), self._place(x_np, self.dtype)

    def _place(self, arr: np.ndarray, dtype) -> torch.Tensor:
        """A device COPY of a host staging array (never an alias of it —
        on the CPU ``torch.from_numpy`` alone would share the block that
        ``release`` is about to recycle)."""
        return torch.from_numpy(arr).to(self.device, copy=True).to(dtype)

    def assemble_reference(self, plan: DispatchPlan):
        """The seed's copy-heavy assemble, kept verbatim as the paired
        baseline for ``benchmarks/hot_path.py`` and the bit-parity tests
        (``assemble`` must reproduce this buffer exactly)."""
        if plan.g_total == 0:
            return None
        np_dtype = self._np_dtype
        tile = plan.tile
        x_np = np.zeros((plan.g_pad, RF_DEPTH, tile), np_dtype)
        ids_np = np.zeros(plan.g_pad, np.int32)
        for g in plan.groups:
            if g.n_tiles == 0:
                continue
            n_in = len(g.kernel.dfg.inputs)
            buf = np.zeros((n_in, g.n_tiles * tile), np_dtype)
            for j in range(n_in):
                buf[j, :g.total] = np.concatenate(
                    [np.asarray(plan.requests[i][1][j], np_dtype)
                     for i in g.idxs])
            x_np[g.start:g.start + g.n_tiles, :n_in, :] = \
                buf.reshape(n_in, g.n_tiles, tile).transpose(1, 0, 2)
            ids_np[g.start:g.start + g.n_tiles] = g.slot
        x_np[plan.g_total:] = x_np[0]
        ids_np[plan.g_total:] = ids_np[0]
        return self._place(ids_np, torch.int32), self._place(x_np, self.dtype)

    def execute(self, bank: ContextBank, batch):
        """Stage 3/4 — launch the round on device; does NOT block.

        Makes one ``tmfu_pipeline_multi`` call against the bank's
        stacked instruction tensors.  The bank writes its slots in place,
        but every such write is queued on the stream behind this launch
        and never targets a pinned slot, so an in-flight launch is never
        disturbed.  The CUDA launch is asynchronous: the returned
        ``[G_pad, max_outputs, tile]`` tensor is complete only once the
        stream reaches it; the engine's delivery point waits on an event.
        Slot validity between ``plan`` and this call is the caller's
        contract — hold plan pins if any other round may touch the bank
        in between.
        """
        if batch is None:
            return None
        id_arr, x_stack = batch
        # co-locate the round with the bank: the kernel reads the bank's
        # tensors by pointer, so the tiles must lie on the same device.
        # ``assemble`` already places on ``self.device``, so the move here
        # only fires for batches built elsewhere.
        if id_arr.device != bank.device or x_stack.device != bank.device:
            id_arr, x_stack = id_arr.to(bank.device), x_stack.to(bank.device)
        return tmfu_ops.tmfu_pipeline_multi(bank, id_arr, x_stack,
                                            donate=self.donate)

    def collect(self, plan: DispatchPlan, ys, host: bool = False):
        """Stage 4/4 — slice the round's result stack back per request.

        Two delivery modes:

        * ``host=False`` (the ``dispatch`` default): the slices are
          device ops queued behind the (possibly still executing) launch —
          nothing blocks, results stay tensors on the device (one
          ``movedim().reshape()`` copy per group, then views).
        * ``host=True`` (the streaming engine's delivery path): ``ys``
          must already be ready (the engine just blocked on it); only
          the LIVE ``g_total`` tiles and live output rows reach a
          contiguous host buffer, in ONE bulk gather; every per-group
          flatten and per-request slice after that is a numpy VIEW —
          the padding tiles and dead ``max_outputs`` rows are never
          copied.  On the GPU the slice+transpose runs device-side
          (``_gather_live`` — one strided copy) so the one host transfer
          carries live bytes only; for a host-backed result (a CPU
          tensor) the numpy view is already zero-copy, so the gather is
          one strided copy per group of the live view.  A bfloat16
          result reaches the host widened to float32 (numpy has no
          bfloat16).

        Returns one output list per request, in request order; both modes
        yield bit-identical values.  ``collect_reference`` keeps the
        seed's full-stack readback as the paired-benchmark baseline.
        """
        if ys is None:
            return self._empty_results(plan, host)
        if host:
            if _host_backed(ys):
                arr = None
                view = ys if isinstance(ys, np.ndarray) else to_host(ys)
            else:
                n_live = max((len(g.kernel.dfg.outputs)
                              for g in plan.groups), default=1)
                arr = _gather_live(ys, plan.g_total, max(n_live, 1))
        results: list = [None] * len(plan.requests)
        for g in plan.groups:
            n_out = len(g.kernel.dfg.outputs)
            if host:
                if arr is None:
                    # one strided gather per group: exactly this group's
                    # live output rows, output axis out front so each row
                    # flattens to a contiguous view
                    buf = view[g.start:g.start + g.n_tiles, :n_out, :] \
                        .transpose(1, 0, 2).copy()
                    flats = [buf[j].reshape(-1) for j in range(n_out)]
                else:
                    # [n_live, nt, tile] device-gathered stack: per-group
                    # flattens are contiguous views of the one transfer
                    flats = [arr[j, g.start:g.start + g.n_tiles].reshape(-1)
                             for j in range(n_out)]
            else:
                block = ys[g.start:g.start + g.n_tiles]  # [nt, max_out, tile]
                flat = block.movedim(1, 0).reshape(ys.shape[1], -1)
                flats = [flat[j] for j in range(n_out)]
            off = 0
            for i, n in zip(g.idxs, g.lens):
                results[i] = [flats[j][off:off + n] for j in range(n_out)]
                off += n
        return results

    def _empty_results(self, plan: DispatchPlan, host: bool):
        """Per-request zero-length outputs of a round that launched nothing."""
        def empty():
            if host:
                return np.zeros((0,), self._np_dtype)
            return torch.zeros((0,), dtype=self.dtype, device=self.device)
        return [[empty() for _ in k.dfg.outputs] for k, _ in plan.requests]

    def collect_reference(self, plan: DispatchPlan, ys, host: bool = False):
        """The seed's collect: full padded-stack readback + one
        ``ascontiguousarray`` copy per live output row.  Paired-benchmark
        baseline; bit-identical to ``collect`` in both modes."""
        if ys is None:
            return self._empty_results(plan, host)
        if host:
            ys = to_host(ys)
        results: list = [None] * len(plan.requests)
        for g in plan.groups:
            n_out = len(g.kernel.dfg.outputs)
            block = ys[g.start:g.start + g.n_tiles]    # [nt, max_out, tile]
            if host:
                flats = [np.ascontiguousarray(block[:, j, :]).reshape(-1)
                         for j in range(n_out)]
            else:
                flat = block.movedim(1, 0).reshape(ys.shape[1], -1)
                flats = [flat[j] for j in range(n_out)]
            off = 0
            for i, n in zip(g.idxs, g.lens):
                results[i] = [flats[j][off:off + n] for j in range(n_out)]
                off += n
        return results

    def dispatch(self, bank: ContextBank, requests, tile: int = DISPATCH_TILE):
        """Serve a mixed-kernel batch through the bank in one launch family.

        The synchronous composition of the four pipeline stages —
        ``collect(execute(assemble(plan(...))))`` — and therefore the
        bit-for-bit oracle for the streaming engine, which runs the same
        stages interleaved across rounds.  Returns one output list per
        request, in request order.
        """
        if not requests:
            return []
        p = self.plan(bank, requests, tile=tile)
        ys = self.execute(bank, self.assemble(p))
        # the collect below never blocks, so there is no engine-style
        # delivery point to recycle at; the device placement in assemble
        # already copied the staging block, so hand it back now (release
        # on an unpinned plan only recycles)
        p.release(bank)
        return self.collect(p, ys)
