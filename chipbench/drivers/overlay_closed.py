"""Closed-loop overlay traffic: each tenant keeps a fixed number of
requests outstanding and submits its next one as soon as one comes back.

The client is one thread over the engine's own streaming API
(``OverlayServer.as_completed``, which picks up submits made while it
iterates): round formation then follows the traffic alone.  Behind an
``AutoPump`` the same loop's rounds race the client's resubmits, and
runs of one seed spread 255-645 requests/s (see PERF.md).

Traffic keys: ``tenants`` (tenant i runs kernel i mod the number of
kernels), ``outstanding_per_tenant``, ``lanes`` a request,
``input_sets_per_kernel`` (the pool each request draws its inputs from,
by the seed), ``warmup_s`` (the same loop, run before the window).

End-to-end: ``requests_per_s``, the requests delivered inside the window
over its length.  Every request delivered from the window's start on is
compared with the reference, lane for lane.
"""

from __future__ import annotations

import sys

import numpy as np

from chipbench.drivers import overlay_common as C
from chipbench.lib import trace
from chipbench.lib.record import seed_int
from chipbench.lib.spec import load_module


class ClosedLoop:
    def __init__(self, srv, kernels, pools, tenants, per_tenant, lanes, rng):
        self.srv = srv
        self.kernels, self.pools, self.tenants = kernels, pools, tenants
        self.per_tenant, self.lanes, self.rng = per_tenant, lanes, rng
        self.outstanding: dict = {}
        self.delivered: list = []       # (kernel, set, lanes, outs, t)
        self.keep = False
        for ti in range(len(tenants)):
            for _ in range(per_tenant):
                self._submit(ti)
        self.results = srv.as_completed()

    def _submit(self, ti: int) -> None:
        name, k = self.tenants[ti]
        s = int(self.rng.integers(len(self.pools[k])))
        with trace.span("bench.submit"):
            t = self.srv.submit(self.kernels[k], self.pools[k][s],
                                tenant=name)
        self.outstanding[t] = (ti, k, s)

    def run_until(self, t_end: float, resubmit: bool = True) -> None:
        """Take results until ``t_end`` (or until none is left), each
        tenant's next request submitted as one of its own comes back."""
        while self.outstanding and C.now() < t_end:
            with trace.span("bench.as_completed"):
                ticket, outs = next(self.results)
            t = C.now()
            ti, k, s = self.outstanding.pop(ticket)
            if self.keep:
                self.delivered.append((k, s, self.lanes, outs, t))
            if resubmit:
                self._submit(ti)


def run(cell, rec) -> None:
    import torch
    cfg, tr = cell.config, cell.traffic
    ref = load_module(cell.reference_path)
    kernels = C.build_kernels(cfg)
    pools = C.input_pools(cfg, rec.seed, tr["input_sets_per_kernel"],
                          tr["lanes"])
    tenants = [(f"bulk{i}", i % len(kernels)) for i in range(tr["tenants"])]
    srv = C.make_server(cfg, rec.device)
    loop = ClosedLoop(srv, kernels, pools, tenants,
                      tr["outstanding_per_tenant"], tr["lanes"],
                      np.random.default_rng(seed_int(rec.seed, 2)))
    out: dict = {}
    loop.run_until(C.now() + tr["warmup_s"])
    rec.setup_done()
    before = srv.stats()
    loop.keep = True
    with trace.profiled(rec.traced, out):
        t0 = C.now()
        t_end = t0 + rec.window_s(tr)
        loop.run_until(t_end)
        after = srv.stats()
    loop.run_until(C.now() + C.LATE_S, resubmit=False)
    if rec.device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(rec.device)
    in_window = [d for d in loop.delivered if d[4] <= t_end]
    rec.e2e["requests_per_s"] = len(in_window) / (t_end - t0)
    rec.attempted = len(loop.delivered) + len(loop.outstanding)
    rec.failed = len(loop.outstanding)
    rec.counters.update(C.window_counters(before, after))
    rec.counters["tmfu_bytes"] = sum(
        C.request_bytes(cfg, k, n) for k, _, n, _, _ in in_window) \
        + C.context_bytes(cfg, [d[0] for d in in_window])
    rec.trace = out.get("trace")
    print(f"chipbench: {len(in_window)} requests in {t_end - t0:.3f} s, "
          f"{len(loop.delivered)} compared; window counters {rec.counters}",
          file=sys.stderr)
    rec.check("max_ulp", C.compare(ref, cfg, pools, [d[:4] for d in
                                                      loop.delivered]), 0)
