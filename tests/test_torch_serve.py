"""The slice as a whole: one trace through the port's ``OverlayServer`` and
through the JAX package's.  ``flush``, ``as_completed`` and ``flush_sync``
deliver the same tickets with bit-identical float32 outputs, the same
rounds and the same bank traffic.  No tolerance in this file except the
DFG-oracle check, which keeps the demo's own ``rtol = atol = 1e-5``
(the oracle evaluates the expression tree, not the scheduled program).
"""

import numpy as np
import pytest
import torch

from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.launch import serve as jserve
from repro.telemetry import check_stats as j_check_stats
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.core import vm as tvm
from repro_torch.launch import serve as tserve
from repro_torch.sched import AdmissionError, DynamicTilePolicy
from repro_torch.telemetry import ENGINE_STATS_KEYS, check_stats
from torch_port_support import assert_same_bits

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)
N_REQUESTS, N_TENANTS, BANK = 40, 3, 4
BATCHES = (64, 128, 200)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def kernels():
    return {n: (joverlay.compile_program(jbench.benchmark(n)),
                toverlay.compile_program(tbench.benchmark(n)))
            for n in NAMES}


@pytest.fixture(scope="module")
def trace(kernels):
    """~40 requests over nine kernels and three tenants: ``(name, xs,
    tenant)``; the inputs come from numpy and go to both servers."""
    rng = np.random.RandomState(0)
    out = []
    for i in range(N_REQUESTS):
        name = NAMES[(i * 4) % len(NAMES)]
        k = kernels[name][1]
        xs = [rng.uniform(-2, 2, (BATCHES[i % 3],)).astype(np.float32)
              for _ in k.dfg.inputs]
        out.append((name, xs, f"tenant{i % N_TENANTS}"))
    return out


def _servers(**kw):
    return (jserve.OverlayServer(bank_capacity=BANK, clock=FakeClock(), **kw),
            tserve.OverlayServer(bank_capacity=BANK, clock=FakeClock(),
                                 device="cpu", **kw))


def _submit_all(srv, trace, kernels, which):
    return [srv.submit(kernels[n][which], xs, tenant=t) for n, xs, t in trace]


def _np(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


def _assert_same_delivery(t_res, j_res):
    assert sorted(t_res) == sorted(j_res)
    for ticket in j_res:
        assert len(t_res[ticket]) == len(j_res[ticket])
        for a, b in zip(t_res[ticket], j_res[ticket]):
            assert_same_bits(_np(a), _np(b), f"ticket {ticket}")


def _assert_same_traffic(tsrv, jsrv):
    ts, js = tsrv.stats(), jsrv.stats()
    assert set(ts) == set(js)
    check_stats("engine", ts)
    j_check_stats("engine", ts)             # and by the reference's schema
    for key in ("rounds", "requests", "submits", "loads", "evictions",
                "hits", "resident", "free", "generation", "pending",
                "inflight", "queued", "queued_tiles", "pinned", "tenants",
                "round_policy", "capacity", "ctx_cache", "arena"):
        assert ts[key] == js[key], key
    assert set(ts["stage_walls"]) == set(js["stage_walls"])
    assert set(ts["tenant_latency"]) == set(js["tenant_latency"])
    for tenant, row in js["tenant_latency"].items():
        assert ts["tenant_latency"][tenant]["n"] == row["n"]
    assert tsrv.bank.resident == jsrv.bank.resident


@pytest.mark.parametrize("mode", ("flush", "as_completed", "flush_sync"))
def test_trace_bit_identical_to_reference(kernels, trace, mode):
    jsrv, tsrv = _servers()
    jt = _submit_all(jsrv, trace, kernels, 0)
    tt = _submit_all(tsrv, trace, kernels, 1)
    assert tt == jt
    assert tsrv.pending == jsrv.pending == N_REQUESTS
    assert tsrv.pending_tiles == jsrv.pending_tiles
    assert tsrv.queued_by_tenant() == jsrv.queued_by_tenant()
    if mode == "as_completed":
        j_order = [(t, ys) for t, ys in jsrv.as_completed()]
        t_order = [(t, ys) for t, ys in tsrv.as_completed()]
        assert [t for t, _ in t_order] == [t for t, _ in j_order]
        j_res, t_res = dict(j_order), dict(t_order)
    else:
        j_res, t_res = getattr(jsrv, mode)(), getattr(tsrv, mode)()
    _assert_same_delivery(t_res, j_res)
    _assert_same_traffic(tsrv, jsrv)
    assert tsrv.stats()["evictions"] > 0     # capacity 4 under nine kernels
    for ticket in tt:
        assert tsrv.record(ticket)["round"] == jsrv.record(ticket)["round"]
    # a second pass over warm banks: hits and evictions still move together
    _submit_all(jsrv, trace, kernels, 0), _submit_all(tsrv, trace, kernels, 1)
    _assert_same_delivery(getattr(tsrv, "flush")(), getattr(jsrv, "flush")())
    _assert_same_traffic(tsrv, jsrv)


def test_three_drains_agree_and_match_the_oracles(kernels, trace):
    """Within the port: flush == as_completed == flush_sync == dispatch, bit
    for bit; every request agrees with the DFG oracle to 1e-5."""
    results = {}
    for mode in ("flush", "as_completed", "flush_sync"):
        srv = tserve.OverlayServer(bank_capacity=BANK, device="cpu")
        tickets = _submit_all(srv, trace, kernels, 1)
        res = (dict(srv.as_completed()) if mode == "as_completed"
               else getattr(srv, mode)())
        results[mode] = [res[t] for t in tickets]
        assert srv.pending == 0 and srv.bank.n_pinned == 0
        assert srv.overlay.arena.stats()["outstanding"] == 0
    ov = toverlay.Overlay(device="cpu")
    bank = ov.load_many([k[1] for k in kernels.values()])
    results["dispatch"] = ov.dispatch(
        bank, [(kernels[n][1], xs) for n, xs, _ in trace])
    for mode in ("as_completed", "flush_sync", "dispatch"):
        for got, want in zip(results[mode], results["flush"]):
            for a, b in zip(got, want):
                assert_same_bits(_np(a), _np(b), mode)
    for (name, xs, _), got in zip(trace, results["flush"]):
        dfg = kernels[name][1].dfg
        ref = tvm.dfg_eval(dfg, {n: torch.from_numpy(v)
                                 for n, v in zip(dfg.inputs, xs)})
        for o, y in zip(dfg.outputs, got):
            assert isinstance(y, np.ndarray) and y.shape == xs[0].shape
            np.testing.assert_allclose(y, ref[o].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ("drr", "coalesce", "dynamic"))
def test_round_policies_bit_identical_to_reference(kernels, trace, policy):
    jsrv, tsrv = _servers(round_policy=policy, round_kernels=2,
                          max_inflight=3)
    _submit_all(jsrv, trace[:24], kernels, 0)
    _submit_all(tsrv, trace[:24], kernels, 1)
    _assert_same_delivery(tsrv.flush(), jsrv.flush())
    _assert_same_traffic(tsrv, jsrv)


def test_stats_schema_and_stage_walls(kernels, trace):
    srv = tserve.OverlayServer(bank_capacity=BANK, device="cpu")
    _submit_all(srv, trace[:12], kernels, 1)
    srv.flush()
    st = srv.stats()
    check_stats("engine", st)
    assert ENGINE_STATS_KEYS <= set(st)
    assert set(st["stage_walls"]) == {"plan_s", "assemble_s", "execute_s",
                                      "collect_s"}
    assert all(v > 0 for v in st["stage_walls"].values())
    assert st["arena"]["outstanding"] == 0 and st["arena"]["recycles"] > 0
    assert srv.n_submits == srv.n_requests == 12
    pct = srv.latency_percentiles()
    assert set(pct) == {"p50", "p95", "p99"} and pct["p50"] <= pct["p99"]
    srv.reset_metrics()
    assert srv.latencies() == {}


def test_admission_refusal_as_in_reference(kernels):
    jsrv, tsrv = _servers(admission={"metered": (1.0, 2.0)})
    for srv, which, err in ((jsrv, 0, jserve.AdmissionError),
                            (tsrv, 1, AdmissionError)):
        k = kernels["poly5"][which]
        xs = [np.ones(128, np.float32) for _ in k.dfg.inputs]
        srv.submit(k, xs, tenant="metered")
        srv.submit(k, xs, tenant="metered")          # burst of 2 exhausted
        with pytest.raises(err) as ei:
            srv.submit(k, xs, tenant="metered")
        assert ei.value.tenant == "metered" and ei.value.retry_after > 0
        srv.submit(k, xs, tenant="free")             # unmetered: unaffected
        srv.clock.advance(1.0)                       # one token accrues
        srv.submit(k, xs, tenant="metered")
        assert srv.pending == 4
    _assert_same_delivery(tsrv.flush(), jsrv.flush())
    assert tsrv.pending == 0


def test_ticket_errors_as_in_reference(kernels):
    for srv, which in zip(_servers(), (0, 1)):
        k = kernels["chebyshev"][which]
        t = srv.submit(k, [np.linspace(-1, 1, 64, dtype=np.float32)])
        assert srv.try_result(t) is None             # queued, not delivered
        out = srv.result(t)
        assert np.shape(out[0]) == (64,)
        with pytest.raises(KeyError):
            srv.result(t)                            # already claimed
        with pytest.raises(KeyError):
            srv.try_result(t)
        with pytest.raises(KeyError):
            srv.result(10_000)                       # unknown ticket
        with pytest.raises(KeyError):
            srv.try_result(10_000)


def test_empty_and_zero_length_requests(kernels):
    srv = tserve.OverlayServer(bank_capacity=2, device="cpu")
    assert srv.flush() == {} and srv.flush_sync() == {}
    assert srv.pump_once() is False
    k = kernels["chebyshev"][1]
    t0 = srv.submit(k, [np.zeros(0, np.float32)])
    t1 = srv.submit(k, [np.ones(64, np.float32)])
    out = srv.flush()
    assert np.shape(out[t0][0]) == (0,) and np.shape(out[t1][0]) == (64,)


def test_work_requests_ride_the_same_rounds(kernels):
    jsrv, tsrv = _servers()
    for srv, which in ((jsrv, 0), (tsrv, 1)):
        k = kernels["poly6"][which]
        srv.submit(k, [np.full(128, 0.5, np.float32) for _ in k.dfg.inputs])
        srv.submit_work(lambda: "done", tenant="bulk", cost=3, label="step")
    j_res, t_res = jsrv.flush(), tsrv.flush()
    assert t_res[1] == j_res[1] == "done"
    assert_same_bits(_np(t_res[0][0]), _np(j_res[0][0]))
    assert tsrv.stats()["rounds"] == jsrv.stats()["rounds"]


def test_constructor_checks(kernels):
    with pytest.raises(ValueError):
        tserve.OverlayServer(max_inflight=0, device="cpu")
    with pytest.raises(ValueError):
        tserve.OverlayServer(round_kernels=0, device="cpu")
    with pytest.raises(ValueError):
        tserve.OverlayServer(round_policy=DynamicTilePolicy(),
                             quantum_tiles=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tserve.OverlayServer()                   # None means the GPU


def test_overlay_demo_cli_on_cpu(capsys):
    assert tserve.main(["--overlay-demo", "--bank", "4", "--requests", "18",
                        "--req-batch", "128", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 18 mixed requests over 9 kernels" in out
    assert tserve.main(["--overlay-demo", "--bank", "3", "--requests", "9",
                        "--req-batch", "64", "--device", "cpu", "--stream",
                        "--policy", "coalesce"]) == 0


def test_tenant_latency_summary_matches_reference():
    samples = [("a", 0.1), ("a", 0.3), ("b", 0.2), ("a", 0.2), ("b", 0.9)]
    assert tserve.tenant_latency_summary(samples, slo_s=0.25) == \
        jserve.tenant_latency_summary(samples, slo_s=0.25)
    assert tserve.tenant_latency_summary(samples, slo_s={"a": 0.15}) == \
        jserve.tenant_latency_summary(samples, slo_s={"a": 0.15})
