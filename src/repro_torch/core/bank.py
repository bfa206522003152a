"""Multi-tenant context bank: N resident kernel contexts, one executor.

The paper's area argument restated at serving scale (Sections III/V): a
single time-multiplexed FU pipeline hosts *many* kernels because a kernel
is just a context — a stream of 40-bit instruction words — and switching
costs 0.27 us, not a reconfiguration.  Here the bank stacks N encoded
contexts on device as [N, S_MAX, IM_DEPTH] tensors; ``tmfu_pipeline_multi``
(and the plain ``vm_exec_multi``) select a context by int32 id, so a
mixed-kernel request batch runs through ONE kernel launch and the context
switch is literally an index.

Residency is managed LRU: loading a kernel into a full bank evicts the
least-recently-used resident and reuses its slot id.  A load writes the
slot's rows IN PLACE (see ``load`` for why that is safe) — nothing is
rebuilt, only the instruction data moves, mirroring the daisy-chain
context load.

Pipeline-safety hooks for the async serving engine
(``launch.serve.OverlayServer``):

* ``pin`` / ``unpin`` — refcounted eviction guards.  The engine pins every
  context referenced by an in-flight round between ``Overlay.plan`` (slot
  assignment) and ``Overlay.collect`` (result delivery), so planning round
  N+1 can never reassign a slot that round N's device launch is about to
  read.  Eviction skips pinned slots; a load that finds no evictable slot
  raises ``BankError`` instead of corrupting an in-flight round.
* ``prefetch`` — batch warm-up: make a working set resident ahead of
  traffic (e.g. a known-hot tenant before opening the queue).  Inside the
  engine the same effect falls out of ``Overlay.plan`` itself: plan's
  loads for round N+1 are made while round N still executes; the slot
  writes queue on the stream behind the running launch.
* ``evictable_capacity`` — how many slots a new round may claim (free +
  resident-but-unpinned, optionally excluding keys the caller will pin);
  the engine retires in-flight rounds until the next round's new contexts
  fit.

Two pieces at this layer serve multi-device fleets (one bank per device):

* a ``device`` — the bank's stacked instruction tensors live on the device
  it was constructed with (``None`` means the CUDA device), and every
  context write lands there;
* residency GENERATIONS — ``generation`` bumps on every slot-content
  change (load or eviction) and each resident key remembers the generation
  at which it landed.  A :class:`BankDirectory` snapshot of (replica,
  slot, generation) can therefore be validated later with ``peek``: a
  mismatched generation means the directory entry is stale (the context
  was evicted, possibly reloaded) and the router must fall back instead of
  trusting the cached slot.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.dfg import Op
from repro_torch.core.isa import IM_DEPTH, Program
from repro_torch.core.vm import (S_MAX, host_context, host_dtype,
                                 resolve_device, tensor_dtype)
from repro_torch.telemetry import span

#: default number of resident contexts (two cascaded 8-kernel groups)
DEFAULT_CAPACITY = 8
#: default output-slot padding width shared by every resident kernel
DEFAULT_MAX_OUTPUTS = 8


class BankError(ValueError):
    pass


def context_key(kernel) -> tuple[str, str]:
    """Content identity of a kernel's encoded context.

    Residency and dispatch grouping key on this — (name, digest of the
    encoded instruction words + constant tables) — so two different
    programs that happen to share a name can never alias each other in the
    bank.  Cached on the Program object (encoding is immutable post-build).
    """
    program: Program = getattr(kernel, "program", kernel)
    key = getattr(program, "_context_key", None)
    if key is None:
        h = hashlib.sha1()
        for img in program.images:
            h.update(np.asarray(img.words, np.uint32).tobytes())
            h.update(np.asarray(img.consts, np.float32).tobytes())
            h.update(bytes([img.n_loads]))
        h.update(np.asarray(getattr(program, "_output_slots", []),
                            np.int32).tobytes())
        key = (program.name, h.hexdigest())
        program._context_key = key
    return key


class ContextBank:
    """Fixed-capacity, LRU-managed store of device-resident contexts.

    All instruction state lives in four stacked arrays whose leading axis
    is the slot id; ``tree()`` hands them to ``tmfu_pipeline_multi`` /
    ``vm_exec_multi`` unchanged.  ``out_idx`` rows are padded to
    ``max_outputs`` (pad rows repeat slot 0 — harmless, callers slice to
    the kernel's real ``n_outputs``).
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 s_max: int = S_MAX, dtype=torch.float32,
                 max_outputs: int = DEFAULT_MAX_OUTPUTS,
                 device=None):
        if capacity < 1:
            raise BankError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.s_max = s_max
        self.dtype = dtype
        self.max_outputs = max_outputs
        host_dtype(dtype)        # raises on a type the overlay does not run
        #: device the stacked tensors live on; None = the CUDA device
        #: (raises without one — a CPU bank is asked for by name).
        self.device = resolve_device(device)
        # identity padding for empty slots: BYP slot i <- rf[i], like
        # make_context's padding, so an unloaded slot is a pure pass-through
        ident = np.tile(np.arange(IM_DEPTH, dtype=np.int32),
                        (capacity, s_max, 1))
        self.op = self._place(np.full((capacity, s_max, IM_DEPTH),
                                      int(Op.BYP), np.int32))
        self.src_a = self._place(ident)
        self.src_b = self._place(ident.copy())
        self.imm = self._place(np.zeros((capacity, s_max, IM_DEPTH),
                                        host_dtype(dtype))).to(dtype)
        self.out_idx = self._place(np.zeros((capacity, max_outputs),
                                            np.int32))
        #: residency map: context_key -> slot, MRU last
        self._lru: OrderedDict[tuple[str, str], int] = OrderedDict()
        self._free = list(range(capacity))
        self._meta: dict[int, dict] = {}  # slot -> {name, n_inputs, n_outputs}
        #: host-side cache of encoded contexts, so an eviction reload is a
        #: pure device write (no re-run of the Python encode loop); bounded
        #: LRU (4x capacity) so a churning tenant population cannot pin the
        #: device arrays of every kernel ever seen
        self._ctx_cache: OrderedDict[tuple[str, str], object] = OrderedDict()
        self._ctx_cache_cap = 4 * capacity
        #: eviction guards: context_key -> pin refcount (see ``pin``)
        self._pins: dict[tuple[str, str], int] = {}
        #: residency generation: bumped on every slot-content change (load
        #: into a slot or eviction), so external residency caches
        #: (BankDirectory) can detect staleness without subscribing to
        #: eviction events
        self.generation = 0
        #: context_key -> generation at which that key became resident
        self._key_gen: dict[tuple[str, str], int] = {}
        self.n_loads = 0
        self.n_evictions = 0
        self.n_hits = 0
        #: optional RoundArena serving this bank's rounds (attached by the
        #: engine); surfaced in stats() so a leaking arena bucket shows up
        #: in telemetry instead of just RSS
        self._arena = None

    def attach_arena(self, arena) -> None:
        """Expose a RoundArena's occupancy/recycle counters via stats()."""
        self._arena = arena

    def _place(self, x: np.ndarray) -> torch.Tensor:
        """A fresh tensor on this bank's device holding ``x``."""
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                            copy=True)

    # ------------------------------------------------------------- residency
    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, kernel) -> bool:
        """Membership by kernel/Program (exact content) or by name (str)."""
        if isinstance(kernel, str):
            return any(k[0] == kernel for k in self._lru)
        return context_key(kernel) in self._lru

    @property
    def resident(self) -> tuple[str, ...]:
        """Resident kernel names, LRU first."""
        return tuple(name for name, _ in self._lru)

    def slot_of(self, kernel) -> int | None:
        """Slot id of a resident kernel (touches LRU), else None."""
        key = context_key(kernel)
        slot = self._lru.get(key)
        if slot is not None:
            self._lru.move_to_end(key)
            self.n_hits += 1
        return slot

    def meta(self, slot: int) -> dict:
        return self._meta[slot]

    def peek(self, kernel) -> tuple[int, int] | None:
        """Residency probe WITHOUT an LRU touch: ``(slot, generation)``.

        Returns None when the kernel is not resident.  Routers use this to
        validate a :class:`BankDirectory` entry — a probe is not a *use*,
        so it must not refresh the key's LRU position (the eventual
        ``load`` at plan time is the use).
        """
        key = context_key(getattr(kernel, "program", kernel))
        slot = self._lru.get(key)
        if slot is None:
            return None
        return slot, self._key_gen[key]

    # -------------------------------------------------------------- pinning
    def pin(self, kernel) -> int:
        """Make ``kernel`` resident and guard it against eviction.

        Pins are refcounted: every ``pin`` must be balanced by an ``unpin``.
        The async engine pins a round's contexts at plan time and unpins at
        collect time, so a context can never be evicted (its slot reused by
        another tenant) while a launch referencing that slot is in flight.
        Returns the slot id.
        """
        slot = self.load(kernel)
        key = context_key(getattr(kernel, "program", kernel))
        self._pins[key] = self._pins.get(key, 0) + 1
        return slot

    def unpin(self, kernel) -> None:
        """Release one pin on ``kernel`` (refcounted; see ``pin``)."""
        key = context_key(getattr(kernel, "program", kernel))
        n = self._pins.get(key, 0)
        if n <= 0:
            raise BankError(f"unpin without matching pin: {key[0]}")
        if n == 1:
            del self._pins[key]
        else:
            self._pins[key] = n - 1

    def is_pinned(self, kernel) -> bool:
        key = context_key(getattr(kernel, "program", kernel))
        return self._pins.get(key, 0) > 0

    @property
    def n_pinned(self) -> int:
        """Number of distinct pinned resident contexts."""
        return len(self._pins)

    def evictable_capacity(self, excluding=()) -> int:
        """Slots a newcomer working set may claim: free + unpinned residents.

        ``excluding`` (context keys) removes residents the caller intends
        to keep — e.g. the serving engine excludes the next round's own
        resident kernels, since those will be pinned rather than evicted.
        The engine checks this before planning a round and retires
        in-flight rounds (dropping their pins) until the round's new
        contexts fit.
        """
        ex = set(excluding)
        return len(self._free) + sum(1 for k in self._lru
                                     if self._pins.get(k, 0) == 0
                                     and k not in ex)

    def prefetch(self, kernels) -> list[int]:
        """Warm-up hook: make a working set resident ahead of traffic.

        Functionally ``load`` per kernel (LRU rules apply — the set may
        evict colder residents, never pinned ones); returns the slot ids.
        Useful before opening a queue to a known-hot tenant, or from any
        caller that wants context writes queued while earlier launches
        still execute.
        """
        return [self.load(k) for k in kernels]

    # ----------------------------------------------------------------- load
    def load(self, kernel) -> int:
        """Make a kernel resident and return its slot id.

        ``kernel`` is an ``overlay.CompiledKernel`` (or a bare ``Program``).
        Residency is keyed on context CONTENT (see ``context_key``), so a
        same-named but different program is a distinct tenant, never an
        alias.  A resident kernel is an LRU touch; otherwise the context
        image is written into a free slot, evicting the LRU resident when
        the bank is full (its slot id is reused by the newcomer).
        """
        program: Program = getattr(kernel, "program", kernel)
        key = context_key(program)
        name = program.name
        slot = self._lru.get(key)
        if slot is not None:
            self._lru.move_to_end(key)
            self.n_hits += 1
            return slot
        ctx = self._ctx_cache.get(key)
        if ctx is None:
            # the encode is deterministic over the immutable program, so
            # memoize the built Context ON the program (like
            # context_key): a second bank loading the same kernel — an
            # elastic scale-up warming a fresh replica, a migration, a
            # steal prefetch — pays a device write, not a re-run of the
            # Python encode loop.  The memo holds HOST (numpy) arrays:
            # it lives as long as the Program (the caller's object, GC'd
            # with it), so it must not pin device memory — the bounded
            # _ctx_cache rationale above stays true, device residency is
            # still capped by bank capacity.  The Context is read-only
            # to every bank (slot writes copy out of it), so sharing is
            # safe.
            memo = getattr(program, "_ctx_memo", None)
            if memo is None:
                memo = program._ctx_memo = {}
            mkey = (self.s_max, str(self.dtype))
            ctx = memo.get(mkey)
            if ctx is None:
                ctx = memo[mkey] = host_context(program, self.s_max,
                                                self.dtype)
            self._ctx_cache[key] = ctx
            while len(self._ctx_cache) > self._ctx_cache_cap:
                self._ctx_cache.popitem(last=False)
        else:
            self._ctx_cache.move_to_end(key)
        if ctx.n_outputs > self.max_outputs:
            raise BankError(
                f"{name}: {ctx.n_outputs} outputs > bank max_outputs="
                f"{self.max_outputs}")
        if self._free:
            slot = self._free.pop(0)
        else:
            # evict the least-recently-used UNPINNED resident; pinned slots
            # belong to in-flight rounds and must keep their contents
            victim = next((k for k in self._lru
                           if self._pins.get(k, 0) == 0), None)
            if victim is None:
                raise BankError(
                    f"{name}: bank full and all {self.capacity} resident "
                    f"contexts are pinned; retire in-flight rounds (unpin) "
                    f"before loading new tenants")
            slot = self._lru.pop(victim)
            del self._meta[slot]
            del self._key_gen[victim]
            self.n_evictions += 1
        # The slot's rows are overwritten IN PLACE (no new [N, S, IM]
        # tensors per load).  That is safe for launches already made:
        # a slot that an in-flight round reads is pinned, so it is never
        # the one written here, and the write is queued on the stream
        # behind every earlier launch, so even an unpinned round that was
        # launched before this load has finished reading.  The copy out of
        # pageable host memory returns only after the host image was read.
        with span("bank.load"):
            self.op[slot].copy_(torch.from_numpy(ctx.op))
            self.src_a[slot].copy_(torch.from_numpy(ctx.src_a))
            self.src_b[slot].copy_(torch.from_numpy(ctx.src_b))
            self.imm[slot].copy_(torch.from_numpy(ctx.imm))  # casts to dtype
            out_pad = np.zeros(self.max_outputs, np.int32)
            out_pad[:ctx.n_outputs] = ctx.out_idx
            self.out_idx[slot].copy_(torch.from_numpy(out_pad))
        self._meta[slot] = {"name": name, "n_inputs": ctx.n_inputs,
                            "n_outputs": ctx.n_outputs,
                            "context_bytes": ctx.context_bytes}
        self._lru[key] = slot
        # one bump covers the slot's content change (and the eviction that
        # freed it, if any): every stale BankDirectory entry — the victim's
        # and any older snapshot of this key — now fails its generation check
        self.generation += 1
        self._key_gen[key] = self.generation
        self.n_loads += 1
        return slot

    # ------------------------------------------------------------- lifecycle
    def retire(self) -> None:
        """Decommission this bank: drop every residency and bump the
        generation.

        The elastic fleet calls this while draining a replica, AFTER its
        in-flight rounds have retired (pins released) and its queued work
        has been evacuated.  Clearing the residency map makes every
        ``peek`` miss, and the generation bump is belt-and-braces: any
        external residency snapshot (a :class:`BankDirectory` entry that
        escaped the drain's unpublish, a caller-cached ``(slot,
        generation)`` pair) can never validate against this bank again —
        stale lookups fall back to the router's miss path instead of
        dispatching into a decommissioned replica.

        Raises :class:`BankError` if pinned contexts remain: a pin means
        an in-flight round still references these slots, and retiring
        under it would be exactly the slot-reuse corruption pins exist to
        prevent.
        """
        if self._pins:
            names = sorted(k[0] for k in self._pins)
            raise BankError(
                f"retire with {len(self._pins)} pinned contexts "
                f"({', '.join(names)}); retire in-flight rounds first")
        self._lru.clear()
        self._meta.clear()
        self._key_gen.clear()
        self._free = list(range(self.capacity))
        self.generation += 1

    # ------------------------------------------------------------- executor
    def tree(self):
        """The stacked instruction tensors, in vm_exec_multi leaf order."""
        return (self.op, self.src_a, self.src_b, self.imm)

    def stats(self) -> dict:
        # occupancy / pinned_fraction are the bank-saturation signals the
        # serving gateway's edge-shed heuristics read: a bank whose slots
        # are mostly pinned is backed up behind in-flight rounds, so
        # pushing more depth at it buys latency, not throughput
        return {"capacity": self.capacity, "resident": len(self),
                "free": len(self._free), "loads": self.n_loads,
                "evictions": self.n_evictions, "hits": self.n_hits,
                "pinned": self.n_pinned, "generation": self.generation,
                "ctx_cache": len(self._ctx_cache),
                "occupancy": len(self) / self.capacity,
                "pinned_fraction": self.n_pinned / self.capacity,
                "arena": (self._arena.stats()
                          if self._arena is not None else None)}


def bank_from_numpy(state: dict, device=None) -> ContextBank:
    """Rebuild a bank, in the same state, from numpy arrays and plain values.

    ``state`` describes a ``ContextBank`` of any implementation of this
    overlay: the stacked arrays ``op``, ``src_a``, ``src_b``, ``imm``,
    ``out_idx``; ``capacity``, ``s_max``, ``max_outputs``; ``lru`` — the
    ``(key, slot)`` pairs of the residency map, least recently used first;
    ``meta`` (slot -> dict); ``generation``; ``key_gen`` (key -> generation).
    Optional: ``dtype`` (a torch dtype, for a bfloat16 bank whose ``imm``
    comes as float32), ``n_loads``, ``n_evictions``, ``n_hits``.  The free
    list is the unused slots in ascending order, as every bank keeps it;
    the host-side cache of encoded contexts is not part of the state and
    refills on use.  The twin gives the same outputs for the same
    ``ctx_ids`` and tiles, and the same slot for the next ``load``.
    """
    imm = np.array(state["imm"])             # writable copies throughout
    dtype = state.get("dtype") or tensor_dtype(imm.dtype)
    bank = ContextBank(int(state["capacity"]), s_max=int(state["s_max"]),
                       dtype=dtype, max_outputs=int(state["max_outputs"]),
                       device=device)
    for name in ("op", "src_a", "src_b", "out_idx"):
        arr = np.array(state[name], dtype=np.int32)
        have = getattr(bank, name)
        if arr.shape != tuple(have.shape):
            raise BankError(f"{name}: shape {arr.shape} does not fit a bank "
                            f"of shape {tuple(have.shape)}")
        have.copy_(torch.from_numpy(arr))
    if imm.shape != tuple(bank.imm.shape):
        raise BankError(f"imm: shape {imm.shape} does not fit a bank of "
                        f"shape {tuple(bank.imm.shape)}")
    bank.imm.copy_(torch.from_numpy(imm))
    bank._lru = OrderedDict((tuple(k), int(s)) for k, s in state["lru"])
    used = set(bank._lru.values())
    bank._free = [s for s in range(bank.capacity) if s not in used]
    bank._meta = {int(s): dict(m) for s, m in state["meta"].items()}
    bank.generation = int(state["generation"])
    bank._key_gen = {tuple(k): int(g) for k, g in state["key_gen"].items()}
    bank.n_loads = int(state.get("n_loads", 0))
    bank.n_evictions = int(state.get("n_evictions", 0))
    bank.n_hits = int(state.get("n_hits", 0))
    return bank


# ================================================================ directory
@dataclasses.dataclass
class DirectoryEntry:
    """One published residency: kernel key -> (replica, slot, generation)."""

    replica: int
    slot: int
    generation: int


class BankDirectory:
    """Residency cache for a fleet of per-replica ContextBanks.

    The sharded serving router keys every request by context content
    (``context_key``) and asks the directory which replica already hosts
    that context.  The directory is a CACHE, not the source of truth — the
    banks are.  Every ``locate`` validates its entry against the owning
    bank with ``ContextBank.peek``: the entry is fresh only when the key
    is still resident there at the SAME generation it was published at.
    An eviction (or evict-and-reload) on the replica bumps the bank's
    generation, so the stale entry fails validation, is dropped, and the
    router takes the miss/fallback path instead of dispatching against a
    slot that now holds another tenant's context.

    ``publish`` after a load/prefetch records the fresh residency;
    ``drop`` forgets a key (e.g. when a migration retires the old owner);
    ``republish_current`` is the work-stealing/migration hook — it moves
    a key's published home to a new replica (which must already hold the
    context) and counts the move, so routing follows stolen work.
    """

    def __init__(self):
        self._map: dict[tuple[str, str], DirectoryEntry] = {}
        self.n_fresh = 0
        self.n_stale = 0
        self.n_unknown = 0
        self.n_republished = 0
        self.n_unpublished = 0

    def __len__(self) -> int:
        return len(self._map)

    def publish(self, kernel, replica: int, slot: int,
                generation: int) -> None:
        key = context_key(getattr(kernel, "program", kernel))
        self._map[key] = DirectoryEntry(replica=replica, slot=slot,
                                        generation=generation)

    def publish_current(self, kernel, replica: int, bank: ContextBank) -> None:
        """Publish the key's CURRENT residency in ``bank`` (must be
        resident — call right after a ``load``/``prefetch``)."""
        res = bank.peek(kernel)
        if res is None:
            raise BankError("publish_current: kernel is not resident")
        self.publish(kernel, replica, res[0], res[1])

    def republish_current(self, kernel, replica: int,
                          bank: ContextBank) -> None:
        """Move a key's published home to ``replica`` (steal/migration):
        ``publish_current`` plus a republish count.  The context must
        already be resident in ``bank`` — callers prefetch BEFORE moving
        work, so a failed prefetch never strands the directory entry."""
        self.publish_current(kernel, replica, bank)
        self.n_republished += 1

    def drop(self, kernel) -> None:
        self._map.pop(context_key(getattr(kernel, "program", kernel)), None)

    def remove_replica(self, replica: int) -> int:
        """Unpublish every entry homed on ``replica`` and shift higher
        replica ids down by one; returns how many entries were dropped.

        The elastic fleet compacts replica indices when it decommissions
        a replica (``ShardedOverlayServer.drain_replica``): entries on
        the dying replica are unpublished (their contexts are gone — a
        lookup must take the miss path), and every surviving entry's
        replica id is renumbered to keep pointing at the SAME bank in the
        compacted list.  Generation validation still backstops the whole
        move: an entry that somehow escapes this (published concurrently,
        or by a caller holding a stale fleet view) fails its ``peek``
        check against whatever bank now sits at that index and is dropped
        at ``locate`` time.
        """
        dropped = [k for k, e in self._map.items() if e.replica == replica]
        for k in dropped:
            del self._map[k]
        for e in self._map.values():
            if e.replica > replica:
                e.replica -= 1
        self.n_unpublished += len(dropped)
        return len(dropped)

    def locate(self, kernel, banks) -> int | None:
        """Validated lookup: the owning replica id, or None on miss/stale.

        ``banks`` maps replica id -> ContextBank (list or dict).  A stale
        entry (generation mismatch, evicted key, or out-of-range replica)
        is dropped and counted; the caller must treat None as a residency
        miss and fall back to its placement policy.
        """
        key = context_key(getattr(kernel, "program", kernel))
        ent = self._map.get(key)
        if ent is None:
            self.n_unknown += 1
            return None
        try:
            bank = banks[ent.replica]
        except (IndexError, KeyError):
            bank = None
        res = bank.peek(kernel) if bank is not None else None
        if res is None or res != (ent.slot, ent.generation):
            del self._map[key]
            self.n_stale += 1
            return None
        self.n_fresh += 1
        return ent.replica

    def stats(self) -> dict:
        return {"entries": len(self._map), "fresh": self.n_fresh,
                "stale": self.n_stale, "unknown": self.n_unknown,
                "republished": self.n_republished,
                "unpublished": self.n_unpublished}
