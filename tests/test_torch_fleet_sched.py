"""The fleet's scheduling policies, port against the JAX package, decision
by decision: ``PressureAutoscaler`` on the fake fleets and fake clocks of
``tests/test_autoscale.py``; ``PreemptibleTier`` over every inner round
policy on the same flows; ``ResidencyRouter`` / ``WorkStealingRouter`` on
real fleets (the port's on the CPU, the JAX one with ``backend="jnp"``);
``AutoPump`` over both engines.  Policies hold no arrays, so every
comparison here is exact equality of decisions, counters and stats.
"""

import os
import sys
import threading
from collections import deque

import numpy as np
import pytest
import torch

from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.launch import serve as jserve
from repro import sched as jsched
from repro_torch import sched as tsched
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.launch import serve as tserve
from torch_port_support import assert_same_bits

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)
CPU = torch.device("cpu")
#: every thread join and pump wait in this file gives up after this long
WAIT_S = 60.0


# ------------------------------------------------------------ fake fleets
class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class FakeReplica:
    def __init__(self, queued_tiles=0, pending_tiles=0):
        self.queued_tiles = queued_tiles
        self.pending_tiles = pending_tiles


class FakeFleet:
    def __init__(self, *replicas):
        self.replicas = list(replicas)


def test_sched_exports_match_the_reference():
    assert set(tsched.__all__) == set(jsched.__all__)
    assert tsched.BULK_PREFIX == jsched.BULK_PREFIX
    assert isinstance(tsched.PressureAutoscaler(), tsched.AutoscalePolicy)
    for router in (tsched.ResidencyRouter(), tsched.WorkStealingRouter()):
        assert isinstance(router, tsched.RouterPolicy)


# ------------------------------------------------------------- autoscaler
AUTOSCALER_KNOBS = (
    dict(),
    dict(up_tiles=8, up_rounds=1),
    dict(up_tiles=8, up_rounds=3, cooldown_s=10.0),
    dict(down_rounds=3, min_replicas=2),
    dict(up_tiles=50, up_rounds=2, down_rounds=2, max_replicas=3,
         cooldown_s=2.5),
    dict(up_tiles=4, up_rounds=1, down_rounds=1, min_replicas=1,
         max_replicas=6, cooldown_s=0.0),
)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("knobs", range(len(AUTOSCALER_KNOBS)))
def test_autoscaler_decides_as_the_reference(knobs, seed):
    """A seeded walk over fake fleets — load spikes and lulls, replicas
    joining and leaving, the clock moving — fed to both policies: the
    same decisions (kind and replica index) at every observation, and the
    same stats throughout."""
    kw = AUTOSCALER_KNOBS[knobs]
    rng = np.random.RandomState(100 * knobs + seed)
    jclock, tclock = FakeClock(), FakeClock()
    jauto = jsched.PressureAutoscaler(clock=jclock, **kw)
    tauto = tsched.PressureAutoscaler(clock=tclock, **kw)
    # one fake fleet each: the policies key idle streaks by replica object
    jfleet, tfleet = FakeFleet(FakeReplica()), FakeFleet(FakeReplica())
    for step in range(80):
        event = rng.choice(["load", "lull", "idle", "join", "leave", "tick"])
        n = len(jfleet.replicas)
        leave = int(rng.randint(n))
        for fleet in (jfleet, tfleet):
            if event == "join" and n < 8:
                fleet.replicas.append(FakeReplica())
            elif event == "leave" and n > 1:
                fleet.replicas.pop(leave)
        state = rng.randint(0, 120, size=(len(jfleet.replicas), 2))
        if event == "idle":
            state[:] = 0
        elif event == "lull":
            state //= 20
        for fleet in (jfleet, tfleet):
            for rep, (q, p) in zip(fleet.replicas, state):
                rep.queued_tiles, rep.pending_tiles = int(q), int(q + p)
        dt = float(rng.choice([0.0, 0.5, 1.0, 3.0]))
        jclock.t += dt
        tclock.t += dt
        want, got = jauto.observe(jfleet), tauto.observe(tfleet)
        assert got == want, f"step {step} ({event})"
        assert tauto.stats() == jauto.stats(), f"step {step}"
        assert tauto.scale_up_pending == jauto.scale_up_pending
        assert tauto.saturated == jauto.saturated
        for kind, idx in want:          # applied to both fleets alike
            for fleet in (jfleet, tfleet):
                if kind == "up":
                    fleet.replicas.append(FakeReplica())
                elif len(fleet.replicas) > 1:
                    fleet.replicas.pop(idx)
    assert jauto.n_up_decisions + jauto.n_down_decisions > 0, "never acted"
    jauto.reset_metrics()
    tauto.reset_metrics()
    assert tauto.stats() == jauto.stats()


@pytest.mark.parametrize("kw", [
    dict(up_tiles=0), dict(up_tiles=-1), dict(up_rounds=0),
    dict(down_rounds=0), dict(cooldown_s=-0.1),
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
])
def test_autoscaler_refuses_the_same_knobs(kw):
    with pytest.raises(ValueError):
        jsched.PressureAutoscaler(**kw)
    with pytest.raises(ValueError):
        tsched.PressureAutoscaler(**kw)


# -------------------------------------------------------- preemptible tier
def _request(pkg, ticket, tenant, key, cost):
    return pkg.OverlayRequest(ticket=ticket, kernel=None, xs=[],
                              tenant=tenant, key=key, cost=cost)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("inner", ("drr", "coalesce", "dynamic"))
def test_preemptible_tier_forms_the_reference_rounds(inner, seed):
    """Latency and bulk tenants arrive at random; each package's tier
    forms rounds over its own flows, the way the engine calls it (drained
    flows pruned first).  The rounds, the deficits, the service order and
    the tier counters agree at every step."""
    rng = np.random.RandomState(seed)
    tenants = ("a", "b", "c", "bulk:train", "batch")
    side = {}
    for name, pkg in (("jax", jsched), ("port", tsched)):
        tier = pkg.PreemptibleTier(inner, bulk_tenants={"batch"},
                                   quantum_tiles=float(rng.choice([2, 8])))
        side[name] = (pkg, tier, {}, deque())
        rng = np.random.RandomState(seed)   # same knob draw on both sides
    rng.choice([2, 8])
    ticket = 0
    for step in range(60):
        arrivals = [(tenants[rng.randint(len(tenants))],
                     ("k", int(rng.randint(4))), int(rng.randint(1, 5)))
                    for _ in range(int(rng.randint(0, 4)))]
        formed = {}
        for name, (pkg, tier, flows, rr) in side.items():
            for i, (tenant, key, cost) in enumerate(arrivals):
                flow = flows.get(tenant)
                if flow is None:
                    flow = flows[tenant] = pkg.Flow(queue=deque())
                    rr.append(tenant)
                flow.queue.append(_request(pkg, ticket + i, tenant, key,
                                           cost))
            for t in [t for t in rr if not flows[t].queue]:
                del flows[t]
                rr.remove(t)
            reqs = tier.form_round(flows, rr, int(1 + step % 3))
            formed[name] = (None if reqs is None
                            else [(r.ticket, r.tenant) for r in reqs])
            tier.observe(sum(r.cost for r in reqs or ()), 1e-3 * step)
        ticket += len(arrivals)
        assert formed["port"] == formed["jax"], f"step {step}"
        (_, jt, jf, jrr), (_, tt, tf, trr) = side["jax"], side["port"]
        assert list(trr) == list(jrr)
        assert ({t: f.deficit for t, f in tf.items()}
                == {t: f.deficit for t, f in jf.items()})
        assert tt.stats() == jt.stats()
    assert jt.n_bulk_rounds > 0 and jt.n_latency_rounds > 0


def test_preemptible_tier_refuses_the_same_misuse():
    for pkg in (jsched, tsched):
        with pytest.raises(ValueError):
            pkg.PreemptibleTier(pkg.DeficitRoundRobin(), quantum_tiles=4)
        with pytest.raises(ValueError):
            pkg.PreemptibleTier(pkg.PreemptibleTier())


# ------------------------------------------------------------ real fleets
class FakeTick:
    """An engine clock that advances a millisecond a reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


@pytest.fixture(scope="module")
def kernels():
    return {n: (joverlay.compile_program(jbench.benchmark(n)),
                toverlay.compile_program(tbench.benchmark(n)))
            for n in NAMES}


def _fleets(n_replicas, **kw):
    """The JAX fleet (``backend="jnp"``, every replica on the first JAX
    device) and the port's (every replica on the CPU), same knobs."""
    import jax
    j = jserve.ShardedOverlayServer(
        n_replicas=n_replicas, clock=FakeTick(), backend="jnp",
        devices=[jax.devices()[0]] * n_replicas, **kw)
    t = tserve.ShardedOverlayServer(
        n_replicas=n_replicas, clock=FakeTick(), devices=[CPU] * n_replicas,
        **kw)
    return j, t


def _trace(n, seed, lanes=(128, 256), skew=True):
    """``n`` requests ``(name, xs, tenant)``; zipf-skewed kernel choice so
    some replicas run hot and the router has something to decide."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, len(NAMES) + 1, dtype=np.float64)
    p = 1.0 / ranks ** (1.3 if skew else 0.0)
    p /= p.sum()
    out = []
    for i in range(n):
        name = NAMES[rng.choice(len(NAMES), p=p)]
        n_in = len(jbench.benchmark(name).inputs)
        n = int(rng.choice(lanes))
        xs = [rng.uniform(-2, 2, (n,)).astype(np.float32)
              for _ in range(n_in)]
        out.append((name, xs, f"tenant{i % 3}"))
    return out


def _same_outputs(got, want, what):
    assert len(got) == len(want), what
    for y, w in zip(got, want):
        assert_same_bits(np.asarray(y), np.asarray(w), what)


def _router_state(fleet):
    return (fleet.n_route_hits, fleet.n_route_misses, fleet.n_migrations,
            fleet.n_steals)


@pytest.mark.parametrize("steal", (False, True))
def test_router_routes_as_the_reference(kernels, steal):
    """Every submit lands on the same replica in both fleets (hits,
    misses and hot-context migrations alike); between bursts one pump
    step each — where a stealing router moves queued groups — and the
    replica of every ticket still agrees.  Then the outputs, bit for
    bit."""
    jf, tf = _fleets(3, bank_capacity=4, round_kernels=2, steal=steal,
                     migrate_factor=2.0, migrate_min_tiles=2,
                     migrate_cooldown=4, steal_min_tiles=2)
    tickets = []
    for i, (name, xs, tenant) in enumerate(_trace(48, seed=7)):
        jt = jf.submit(kernels[name][0], xs, tenant=tenant)
        tt = tf.submit(kernels[name][1], xs, tenant=tenant)
        assert tt == jt
        tickets.append(tt)
        assert tf.record(tt)["replica"] == jf.record(jt)["replica"], i
        assert _router_state(tf) == _router_state(jf), i
        if i % 8 == 7:
            assert tf.pump_once() == jf.pump_once()
            assert _router_state(tf) == _router_state(jf), i
            for t in tickets:
                assert tf.record(t)["replica"] == jf.record(t)["replica"]
    assert jf.n_route_misses > 0 and jf.n_route_hits > 0
    assert jf.n_migrations > 0
    if steal:
        assert jf.n_steals > 0
    jres, tres = jf.flush(), tf.flush()
    assert sorted(tres) == sorted(jres) == tickets
    for t in tickets:
        _same_outputs(tres[t], jres[t], f"ticket {t}")
    js, ts = jf.stats(), tf.stats()
    for key in ("route_hits", "route_misses", "migrations", "steals",
                "residency_hit_rate", "rounds", "requests", "evictions"):
        assert ts[key] == js[key], key
    assert ts["directory"] == js["directory"]


def test_make_router_builds_the_same_policies():
    for steal in (False, True):
        j = jsched.make_router(steal=steal, steal_min_tiles=3)
        t = tsched.make_router(steal=steal, steal_min_tiles=3)
        assert type(t).__name__ == type(j).__name__
        assert t.stats().keys() == j.stats().keys()
    for pkg in (jsched, tsched):
        with pytest.raises(ValueError):
            pkg.ResidencyRouter(migrate_factor=0.5)


# ------------------------------------------------------------------- pump
@pytest.mark.parametrize("fleet", (False, True))
def test_pump_steps_as_the_reference(kernels, fleet):
    """``pump_once`` — the pump thread's unit of work — driven by hand on
    both engines: the same answer at every step (a round delivered, or
    idle), the same fleet size under an autoscaler, the same deliveries."""
    if fleet:
        auto = dict(up_tiles=2.0, up_rounds=1, down_rounds=2,
                    cooldown_s=0.0, max_replicas=3)
        jsrv, tsrv = _fleets(1, bank_capacity=4, round_kernels=2)
        jsrv.autoscaler = jsched.PressureAutoscaler(clock=FakeClock(), **auto)
        tsrv.autoscaler = tsched.PressureAutoscaler(clock=FakeClock(), **auto)
    else:
        jsrv = jserve.OverlayServer(bank_capacity=4, round_kernels=2,
                                    clock=FakeTick())
        tsrv = tserve.OverlayServer(bank_capacity=4, round_kernels=2,
                                    clock=FakeTick(), device="cpu")
    trace = _trace(20, seed=3)
    for half in (trace[:12], trace[12:]):
        for name, xs, tenant in half:
            assert (tsrv.submit(kernels[name][1], xs, tenant=tenant)
                    == jsrv.submit(kernels[name][0], xs, tenant=tenant))
        for step in range(40):
            worked = jsrv.pump_once()
            assert tsrv.pump_once() == worked, step
            assert tsrv.pending == jsrv.pending, step
            if fleet:
                assert tsrv.n_replicas == jsrv.n_replicas, step
            if not worked and not jsrv.pending:
                break
        else:
            raise AssertionError("the engine never went idle")
    jres, tres = jsrv.flush(), tsrv.flush()
    assert sorted(tres) == sorted(jres) == list(range(len(trace)))
    for t in jres:
        _same_outputs(tres[t], jres[t], f"ticket {t}")
    if fleet:
        assert tsrv.peak_replicas == jsrv.peak_replicas > 1
        assert tsrv.n_scale_downs == jsrv.n_scale_downs > 0


def test_autopump_thread_serves_as_the_reference(kernels):
    """The pump thread under stress: more client threads than cores, a
    short switch interval, every ticket waited for with a timeout and
    delivered once, bit for bit against the JAX engine's barrier drain;
    the claim semantics and the closed-pump error are the reference's."""
    jsrv = jserve.OverlayServer(bank_capacity=4, round_kernels=2)
    n_threads = 2 * (os.cpu_count() or 4)
    trace = _trace(2 * n_threads, seed=5)
    want = {}
    for name, xs, tenant in trace:
        want[jsrv.submit(kernels[name][0], xs, tenant=tenant)] = None
    want = jsrv.flush_sync()
    ticks = []
    pump = tsched.AutoPump(tserve.OverlayServer(bank_capacity=4,
                                                round_kernels=2,
                                                device="cpu"),
                           poll_interval=0.001)
    pump.add_tick_listener(ticks.append)
    got, errors = {}, []

    def client(part):
        try:
            for i in part:
                name, xs, tenant = trace[i]
                t = pump.submit(kernels[name][1], xs, tenant=tenant)
                got[i] = (t, pump.result(t, timeout=WAIT_S))
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client,
                                args=(range(k, len(trace), n_threads),))
               for k in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
            assert not th.is_alive(), "a client thread hung"
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    pump.wait_idle(timeout=WAIT_S)
    for i, (t, outs) in got.items():
        _same_outputs(outs, want[i], f"request {i}")
    assert sorted(t for t, _ in got.values()) == list(range(len(trace)))
    with pytest.raises(KeyError):
        pump.try_result(0)               # claimed already
    bad = pump.try_results([0, 999])
    assert isinstance(bad[0], KeyError) and isinstance(bad[999], KeyError)
    st = pump.stats()
    assert st["pump_alive"] and st["pump_rounds"] > 0 and ticks
    pump.close(timeout=WAIT_S)
    name, xs, tenant = trace[0]
    late = pump.submit(kernels[name][1], xs, tenant=tenant)
    with pytest.raises(RuntimeError, match="closed"):
        pump.result(late, timeout=WAIT_S)
    _same_outputs(pump.server.flush()[late], want[0], "kept after close")
    with pytest.raises(ValueError):
        tsched.AutoPump(object(), poll_interval=0)
