"""Training as a tenant: co-scheduled train + serve under one fleet.

``TrainingTenant`` slices a training run (``launch.train.run_training``
over ``runtime.steps.make_train_step``) into bounded MICRO-ROUNDS and
submits each through the serving engine — ``OverlayServer`` or
``ShardedOverlayServer`` — as a bulk-tier work flow
(``server.submit_work``).  The engine's round policy is wrapped in
:class:`repro_torch.sched.preempt.PreemptibleTier`, so:

* a training micro-round only occupies a round slot the latency tier
  left idle (bulk rounds form only when NO latency flow is queued);
* a latency arrival mid-micro-round preempts training BETWEEN
  micro-steps, never mid-step: the ``should_yield`` hook is polled at
  every step boundary, and every boundary is a complete checkpoint —
  params, optimizer moments, error-feedback ``ef``, and the
  data-pipeline cursor advance atomically per step (the
  ``run_training`` yield-point contract), so preempt/resume is
  exactly-once by construction;
* ``tenant_quanta`` on the inner DRR bounds training's share among
  bulk flows, and the tier structure means serving can starve training
  to zero throughput but training can NEVER starve serving.

The differential guarantee: a co-scheduled run is BIT-IDENTICAL —
params, opt_state, loss trace — to a standalone ``run_training`` loop on
the same seed, under every round policy and under fleet grow/drain churn.

On a CUDA device the engine runs a micro-round inside a replica's own
stream (``OverlayServer._launch_round`` enters it), and on a fleet any
replica may run it.  The tenant therefore owns ONE stream and enters it
for every training step: its steps are ordered among themselves whichever
replica runs them, and the caching allocator never hands a block of the
run's to another stream while it is in use.  Given state is ordered
after the work that made it (``wait_stream``) and marked as used on the
tenant's stream (``record_stream``).  Every step ends in ``float(loss)``,
which waits for the tenant's stream: the state committed at a yield
point is complete on the device.

Quickstart::

    server = OverlayServer(bank_capacity=8)          # on the CUDA device
    tenant = TrainingTenant(server, cfg, oc, dc, steps=100,
                            yield_every=4)
    while not tenant.done:
        tenant.tick()          # claim last round / submit the next
        server.flush()         # latency traffic rides the same drain
    final_params = tenant.params
"""

from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.launch.train import run_training
from repro_torch.models.blocks import tree_leaves
from repro_torch.sched.preempt import BULK_PREFIX
from repro_torch.telemetry import InMemorySink, MultiSink

__all__ = ["TrainingTenant"]

#: default tenant name — the ``bulk:`` prefix alone marks it bulk-tier
DEFAULT_TRAIN_TENANT = BULK_PREFIX + "train"


class TrainingTenant:
    """Drive a training run through a serving engine as a bulk tenant.

    Parameters
    ----------
    server : OverlayServer | ShardedOverlayServer
        The engine to co-schedule under.  Its round policy is wrapped
        in ``PreemptibleTier`` (idempotent) via ``make_preemptible``.
    cfg, oc, dc :
        Model / optimizer / data configs, exactly as ``run_training``
        takes them.
    steps : int
        Total training steps for the run.
    tenant : str
        Flow name; must be bulk-tier (default ``"bulk:train"``).
    yield_every : int
        Max micro-steps per micro-round — the preemption granularity.
        ``should_yield`` is polled between steps, so a micro-round
        occupies the engine for at most ``yield_every`` steps and
        usually fewer under latency pressure.
    cost_tiles : int
        Admission/DRR cost charged per micro-round (work requests hold
        no tiles; this is the scheduling weight).
    should_yield : callable | None
        Zero-arg predicate polled between micro-steps; True preempts
        the micro-round.  Defaults to "any latency-tier tenant has
        queued tiles" (``server.queued_by_tenant``).
    telemetry :
        Own sink for the ``train.*`` counters; defaults to a fresh
        ``InMemorySink`` fanned out to the server's sink through
        ``MultiSink``, so fleet-level stores see training counters too.

    The run lives on the device of the given params, else on the
    server's (a fleet's first replica's).
    """

    def __init__(self, server, cfg, oc, dc, *, steps: int,
                 tenant: str = DEFAULT_TRAIN_TENANT, yield_every: int = 4,
                 cost_tiles: int = 1, compress_grads: bool = False,
                 mixed: bool = False, corpus=None, params=None,
                 opt_state=None, start_step: int = 0, should_yield=None,
                 step_fn=None, telemetry=None, clock=time.monotonic):
        if steps <= start_step:
            raise ValueError(f"steps ({steps}) must exceed "
                             f"start_step ({start_step})")
        if yield_every < 1:
            raise ValueError(f"yield_every must be >= 1, got {yield_every}")
        self.server = server
        self.tenant = tenant
        self.steps = int(steps)
        self.yield_every = int(yield_every)
        self.cost_tiles = max(1, int(cost_tiles))
        self.clock = clock
        self._should_yield = (should_yield if should_yield is not None
                              else self._latency_backlogged)
        own = telemetry if telemetry is not None else InMemorySink()
        server_sink = getattr(server, "telemetry", None)
        self.telemetry = (MultiSink(own, server_sink)
                          if server_sink is not None else own)
        # installs (or extends) the PreemptibleTier over the engine's
        # round policy — every replica on a sharded fleet, and every
        # replica added later (the fleet remembers the bulk spec)
        server.make_preemptible(bulk_tenants={tenant})
        self.corpus = corpus if corpus is not None else SyntheticCorpus(dc)
        device = (tree_leaves(params)[0].device if params is not None
                  else getattr(server, "device", None)
                  or server.replicas[0].device)
        self.stream = self._own_stream(torch.device(device),
                                       (params, opt_state))
        # yield_every=1 → one record per step: every step boundary is a
        # yield point the tenant can commit and preempt at
        self._gen = run_training(
            cfg, oc, dc, steps=self.steps, yield_every=1,
            corpus=self.corpus, params=params, opt_state=opt_state,
            start_step=start_step, compress_grads=compress_grads,
            mixed=mixed, step_fn=step_fn, device=device)
        #: committed state — updated at every yield point, never mid-step
        self.params = params
        self.opt_state = opt_state
        self.cursor = self.corpus.cursor(start_step)
        self.losses: list[float] = []
        self.step_trace: list[int] = []
        self.last_loss: float | None = None
        self._ticket: int | None = None
        self._exhausted = False
        self._resume_pending = False
        self._last_preempted = False
        self._last_summary: dict | None = None

    @staticmethod
    def _own_stream(device, given):
        """The run's stream on a CUDA device (None elsewhere), ordered
        after the caller's work and holding the given state's blocks."""
        if device.type != "cuda":
            return None
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        for t in tree_leaves(given):
            if t.is_cuda:
                t.record_stream(stream)
        return stream

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    # ------------------------------------------------------------- predicates
    def _latency_backlogged(self) -> bool:
        """Default preemption signal: any NON-bulk tenant has queued
        work on the engine.  Bulk flows (including this tenant) never
        trigger a yield — bulk does not preempt bulk."""
        q = self.server.queued_by_tenant()
        return any(tiles > 0 and t != self.tenant
                   and not str(t).startswith(BULK_PREFIX)
                   for t, tiles in q.items())

    @property
    def done(self) -> bool:
        """True once every step is committed AND its result claimed."""
        return self._exhausted and self._ticket is None

    @property
    def outstanding(self) -> bool:
        """A micro-round is submitted and not yet claimed."""
        return self._ticket is not None

    # ------------------------------------------------------------ micro-round
    def _micro_round(self) -> dict:
        """The work callable one engine round runs: up to ``yield_every``
        training steps, committing state at EVERY step boundary and
        polling ``should_yield`` between steps.  Returns a light
        summary (floats only — safe to park in a fleet orphan store)."""
        t0 = self.clock()
        steps: list[int] = []
        losses: list[float] = []
        preempted = False
        for _ in range(self.yield_every):
            try:
                with self._on_stream():
                    rec = next(self._gen)
            except StopIteration:
                self._exhausted = True
                break
            # the commit: every field advances together or not at all
            self.params = rec["params"]
            self.opt_state = rec["opt_state"]
            self.cursor = rec["cursor"]
            self.last_loss = rec["loss"]
            self.losses.append(rec["loss"])
            self.step_trace.append(rec["step"])
            steps.append(rec["step"])
            losses.append(rec["loss"])
            self.telemetry.inc("train.steps")
            if rec["step"] + 1 >= self.steps:
                self._exhausted = True
                break
            if self._should_yield():
                preempted = True
                self.telemetry.inc("train.preemptions")
                break
        self.telemetry.inc("train.micro_rounds")
        self.telemetry.inc("train.yield_wall_s", self.clock() - t0)
        self._last_preempted = preempted
        return {"steps": steps, "losses": losses, "preempted": preempted}

    # ------------------------------------------------------------------ drive
    def tick(self):
        """One scheduling beat: claim the last micro-round's result if
        delivered, then (if idle and not finished) submit the next
        micro-round.  Never blocks; call between engine drains.  Returns
        the most recently CLAIMED summary, or None before the first."""
        if self._ticket is not None:
            try:
                out = self.server.try_result(self._ticket)
            except KeyError:
                # a flush()/as_completed() caller claimed the summary
                # already — fine: every state commit lives on the tenant
                # itself, the ticket's payload is informational
                out = {"preempted": self._last_preempted}
            if out is None:
                return self._last_summary
            self._ticket = None
            self._last_summary = out
            if out.get("preempted"):
                self._resume_pending = True
            self._last_preempted = False
        if not self._exhausted and self._ticket is None:
            if self._resume_pending:
                self.telemetry.inc("train.resumes")
                self._resume_pending = False
            self._ticket = self.server.submit_work(
                self._micro_round, tenant=self.tenant,
                cost=self.cost_tiles, label="train")
        return self._last_summary

    def run(self, *, max_rounds: int | None = None) -> dict:
        """Convenience synchronous drive: tick + flush until ``done``.

        With latency traffic enqueued by someone else between flushes,
        the tier serves it first; alone, this trains flat-out.  Returns
        ``stats()``."""
        rounds = 0
        while not self.done:
            self.tick()
            if self._ticket is not None:
                self.server.flush()
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        return self.stats()

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        """Schema-checked (``check_stats("train", ...)``) counter view."""
        c = self.telemetry.counter
        return {
            "tenant": self.tenant,
            "steps": int(c("train.steps")),
            "total_steps": self.steps,
            "micro_rounds": int(c("train.micro_rounds")),
            "preemptions": int(c("train.preemptions")),
            "resumes": int(c("train.resumes")),
            "yield_wall_s": float(c("train.yield_wall_s")),
            "last_loss": self.last_loss,
            "done": self.done,
            "outstanding": self.outstanding,
        }
