"""The port's copies of ``sched/`` and ``telemetry/``: the recorded
deficit-round-robin trace replays to the same rounds and the same output
bytes through the port's engine, and the copied policies and sinks behave
as the reference's on the same calls."""

import hashlib
import json
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import sched as jsched
from repro import telemetry as jtel
from repro_torch import sched as tsched
from repro_torch import telemetry as ttel
from repro_torch.core.overlay import compile_program
from repro_torch.core.paper_bench import BENCH_NAMES, benchmark
from repro_torch.launch.serve import OverlayServer

torch.set_num_threads(1)

GOLDEN = json.loads((Path(__file__).resolve().parent / "golden"
                     / "drr_rounds.json").read_text())


def test_golden_drr_trace_replays_through_the_port():
    """Same trace as tools/record_golden_rounds.py: identical rounds (ticket
    composition, formation order) and identical float32 output bytes."""
    kernels = {n: compile_program(benchmark(n))
               for n in tuple(BENCH_NAMES) + ("gradient",)}
    rng = np.random.RandomState(GOLDEN["seed"])
    names = sorted(kernels)
    srv = OverlayServer(device="cpu", **GOLDEN["server"])
    rounds = []
    form = srv._form_round

    def spy():
        reqs = form()
        if reqs is not None:
            rounds.append([r.ticket for r in reqs])
        return reqs

    srv._form_round = spy
    for i in range(GOLDEN["requests"]):
        k = kernels[names[int(rng.randint(len(names)))]]
        batch = int(GOLDEN["batches"][int(rng.randint(len(GOLDEN["batches"])))])
        xs = [rng.uniform(-2, 2, (batch,)).astype(np.float32)
              for _ in k.dfg.inputs]
        srv.submit(k, xs, tenant=f"tenant{i % GOLDEN['tenants']}")
    results = srv.flush()
    assert rounds == GOLDEN["rounds"]
    digests = {}
    for t, outs in results.items():
        h = hashlib.sha1()
        for y in outs:
            h.update(np.ascontiguousarray(np.asarray(y, np.float32)).tobytes())
        digests[str(t)] = h.hexdigest()
    assert digests == GOLDEN["digests"]


def test_exports_are_the_ported_subset():
    assert set(tsched.__all__) <= set(jsched.__all__)
    assert set(ttel.__all__) == set(jtel.__all__)
    assert set(tsched.ROUND_POLICIES) == set(jsched.ROUND_POLICIES)
    for name in ("BANK_STATS_KEYS", "ENGINE_STATS_KEYS"):
        assert getattr(ttel, name) == getattr(jtel, name)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_token_bucket_same_decisions():
    cj, ct = _Clock(), _Clock()
    bj = jsched.TokenBucket(rate=2.0, burst=4.0, clock=cj)
    bt = tsched.TokenBucket(rate=2.0, burst=4.0, clock=ct)
    for cost, dt in ((4.0, 0.0), (1.0, 0.0), (1.0, 0.5), (3.0, 0.25),
                     (0.5, 1.0), (4.0, 3.0)):
        cj.t += dt
        ct.t += dt
        assert bt.try_acquire(cost) == bj.try_acquire(cost)
        assert bt.retry_after(cost) == pytest.approx(bj.retry_after(cost))
    with pytest.raises(ValueError):
        tsched.TokenBucket(rate=0.0)


@pytest.mark.parametrize("policy", sorted(jsched.ROUND_POLICIES))
def test_round_policies_form_the_same_rounds(policy):
    def run(mod):
        pol = mod.make_round_policy(policy, quantum_tiles=3.0)
        flows, rr, t = {}, deque(), 0
        for i in range(30):
            tenant = f"t{i % 4}"
            req = mod.OverlayRequest(ticket=i, kernel=None, xs=[],
                                     tenant=tenant, key=("k", str(i % 5)),
                                     cost=1 + i % 3)
            if tenant not in flows:
                flows[tenant] = mod.Flow(queue=deque())
                rr.append(tenant)
            flows[tenant].queue.append(req)
        rounds = []
        while any(f.queue for f in flows.values()):
            for tenant in [x for x in rr if not flows[x].queue]:
                del flows[tenant]
                rr.remove(tenant)
            reqs = pol.form_round(flows, rr, 2)
            if reqs is None:
                break
            rounds.append([r.ticket for r in reqs])
            t += 1
            pol.observe(sum(r.cost for r in reqs), 0.001 * t)
        return rounds

    got, want = run(tsched), run(jsched)
    assert got == want and sum(map(len, got)) == 30


def test_sinks_same_counters_and_jsonl(tmp_path):
    outs = []
    for mod, name in ((jtel, "j.jsonl"), (ttel, "t.jsonl")):
        clock = _Clock()
        sink = mod.JsonlSink(str(tmp_path / name), clock=clock)
        fan = mod.MultiSink(mod.InMemorySink(clock=clock), sink)
        fan.inc("engine.rounds")
        fan.inc("engine.plan_s", 0.25)
        fan.peak("engine.depth", 3)
        fan.peak("engine.depth", 2)
        fan.event("deliver", tenant="a", cost=2, round=0, latency_s=0.5)
        fan.log_step(0, tiles=4, requests=2, wall_s=0.1)
        fan.flush()
        sink.close()
        lines = [json.loads(l) for l in
                 (tmp_path / name).read_text().splitlines()]
        outs.append((fan.counters(), fan.counter("engine.depth"), lines,
                     list(mod.read_jsonl(str(tmp_path / name)))))
    assert outs[0] == outs[1]
    with pytest.raises(Exception):
        ttel.check_stats("engine", {"capacity": 1})
