"""The port's ``ShardedOverlayServer`` against the JAX package's.

The same submit trace goes to both fleets with the same knobs and
injected clocks — the port's replicas on the CPU
(``devices=[torch.device("cpu")] * n``), the JAX replicas on one JAX CPU
device with ``backend="jnp"`` — and they must agree:

* per GLOBAL ticket, outputs bit for bit in float32;
* on every fleet decision the tests can see: routing hits, misses and
  migrations, steals, scale-ups and -downs, evacuated requests, the
  replica and round that served each ticket;
* with the single-bank ``OverlayServer.flush_sync`` of the port, on every
  drain path (``flush``, ``as_completed``, ``flush_sync``, ``result``,
  ``pump_once``);
* through a seeded grow/drain soak, every ticket delivered exactly once.

No tolerance anywhere in this file.  The stream test at the end needs a
CUDA device and is skipped without one.
"""

import numpy as np
import pytest
import torch

from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro import sched as jsched
from repro_torch import sched as tsched
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as tserve
from repro_torch.telemetry import check_stats
from torch_port_support import assert_same_bits

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)
CPU = torch.device("cpu")
#: fleet counters both packages must agree on after every step
COUNTERS = ("n_route_hits", "n_route_misses", "n_migrations", "n_steals",
            "n_scale_ups", "n_scale_downs", "n_evacuated_requests",
            "n_evacuated_tiles", "n_replicas", "peak_replicas", "pending",
            "n_submits")


class FakeTick:
    """An engine clock that advances a millisecond a reading."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def kernels():
    return {n: (joverlay.compile_program(jbench.benchmark(n)),
                toverlay.compile_program(tbench.benchmark(n)))
            for n in NAMES}


def _trace(n, seed, lanes=(128, 256), skew=0.0):
    """``n`` requests ``(name, xs, tenant)``; ``skew`` > 0 draws kernels
    zipf-style, so a few replicas run hot (what stealing needs)."""
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, len(NAMES) + 1, dtype=np.float64) ** skew
    p /= p.sum()
    out = []
    for i in range(n):
        name = NAMES[rng.choice(len(NAMES), p=p)]
        b = int(rng.choice(lanes))
        xs = [rng.uniform(-2, 2, (b,)).astype(np.float32)
              for _ in jbench.benchmark(name).inputs]
        out.append((name, xs, f"tenant{rng.randint(3)}"))
    return out


class Twin:
    """The JAX fleet and the port's fleet, driven in lockstep, plus the
    port's single-bank oracle fed the same submits."""

    def __init__(self, kernels, n_replicas, autoscale=None, **kw):
        import jax
        self.kernels = kernels
        self.j = jserve.ShardedOverlayServer(
            n_replicas=n_replicas, clock=FakeTick(), backend="jnp",
            devices=[jax.devices()[0]] * n_replicas,
            autoscaler=(jsched.PressureAutoscaler(clock=FakeClock(),
                                                  **autoscale)
                        if autoscale else None), **kw)
        self.t = tserve.ShardedOverlayServer(
            n_replicas=n_replicas, clock=FakeTick(),
            devices=[CPU] * n_replicas,
            autoscaler=(tsched.PressureAutoscaler(clock=FakeClock(),
                                                  **autoscale)
                        if autoscale else None), **kw)
        self.oracle = tserve.OverlayServer(bank_capacity=16, device="cpu",
                                           clock=FakeTick())
        self.to_oracle: dict[int, int] = {}
        self.oracle_out: dict[int, list] = {}
        self.delivered: set[int] = set()

    def submit(self, name, xs, tenant):
        jt = self.j.submit(self.kernels[name][0], xs, tenant=tenant)
        tt = self.t.submit(self.kernels[name][1], xs, tenant=tenant)
        assert tt == jt
        self.to_oracle[tt] = self.oracle.submit(self.kernels[name][1], xs,
                                                tenant=tenant)
        self.check_state("submit")
        return tt

    def check_state(self, what):
        for c in COUNTERS:
            assert getattr(self.t, c) == getattr(self.j, c), f"{what}: {c}"

    def check(self, tres: dict, jres: dict, what: str):
        """Both fleets delivered the same tickets, bit for bit, each for
        the first time, each equal to the single-bank oracle's."""
        assert sorted(tres) == sorted(jres), what
        self.oracle_out.update(self.oracle.flush_sync())
        for t, ys in tres.items():
            assert t not in self.delivered, f"{what}: ticket {t} twice"
            self.delivered.add(t)
            assert len(ys) == len(jres[t])
            want = self.oracle_out.pop(self.to_oracle.pop(t))
            for y, jy, w in zip(ys, jres[t], want):
                assert_same_bits(np.asarray(y), np.asarray(jy),
                                 f"{what}: ticket {t} vs JAX fleet")
                assert_same_bits(np.asarray(y), w.numpy(),
                                 f"{what}: ticket {t} vs single bank")
        self.check_state(what)

    def drain(self, mode, rng=None):
        if mode == "flush":
            self.check(self.t.flush(), self.j.flush(), mode)
        elif mode == "flush_sync":
            self.check(self.t.flush_sync(), self.j.flush_sync(), mode)
        elif mode == "as_completed":
            # completion order is part of the contract: compare it too
            tl, jl = list(self.t.as_completed()), list(self.j.as_completed())
            assert [t for t, _ in tl] == [t for t, _ in jl]
            self.check(dict(tl), dict(jl), mode)
        elif mode == "result":
            pending = sorted(self.to_oracle)
            order = (rng.permutation(len(pending)) if rng is not None
                     else range(len(pending)))
            for i in order:
                t = pending[i]
                self.check({t: self.t.result(t)}, {t: self.j.result(t)},
                           f"result({t})")
        elif mode == "pump":
            for step in range(400):
                worked = self.j.pump_once()
                assert self.t.pump_once() == worked, step
                self.check_state(f"pump step {step}")
                if not worked and not self.j.pending:
                    break
            tres, jres = {}, {}
            for t in sorted(self.to_oracle):
                tres[t], jres[t] = self.t.try_result(t), self.j.try_result(t)
                assert tres[t] is not None and jres[t] is not None
            self.check(tres, jres, mode)
        else:
            raise ValueError(mode)


DRAINS = ("flush", "as_completed", "flush_sync", "result", "pump")


@pytest.mark.parametrize("mode", DRAINS)
@pytest.mark.parametrize("steal", (False, True), ids=("residency", "steal"))
@pytest.mark.parametrize("n_replicas", (2, 4))
def test_drains_match_the_jax_fleet(kernels, n_replicas, steal, mode):
    """One request a kernel homes every context; then a backlog aimed at
    the replica that owns the most kernels (the other replicas idle, so a
    stealing router has work to move; migration is off there, so
    stealing is what moves it), drained one way."""
    twin = Twin(kernels, n_replicas, bank_capacity=4, round_kernels=2,
                steal=steal, steal_min_tiles=2,
                migrate_min_tiles=10 ** 9 if steal else 8)
    rng = np.random.RandomState(n_replicas)
    for name in NAMES:
        twin.submit(name, [rng.uniform(-2, 2, (32,)).astype(np.float32)
                           for _ in jbench.benchmark(name).inputs], "warm")
    twin.drain("flush")
    homes: dict[int, list] = {}
    for name in NAMES:
        h = twin.t.directory.locate(kernels[name][1], twin.t.banks)
        assert h == twin.j.directory.locate(kernels[name][0], twin.j.banks)
        if h is not None:
            homes.setdefault(h, []).append(name)
    hot = max(homes.values(), key=len)
    assert len(hot) >= 2
    for i in range(24):
        name = hot[i % len(hot)]
        b = int(rng.choice((128, 256)))
        twin.submit(name, [rng.uniform(-2, 2, (b,)).astype(np.float32)
                           for _ in jbench.benchmark(name).inputs],
                    f"tenant{i % 3}")
    n = len(NAMES) + 24
    for t in range(n):
        assert (twin.t.record(t)["replica"] == twin.j.record(t)["replica"])
    twin.drain(mode, np.random.RandomState(1))
    if steal and mode in ("flush", "as_completed", "pump"):
        assert twin.j.n_steals > 0, "nothing was stolen"
    assert not twin.to_oracle and len(twin.delivered) == n
    for t in range(len(NAMES), n):
        rt, rj = twin.t.record(t), twin.j.record(t)
        assert (rt["replica"], rt["round"]) == (rj["replica"], rj["round"])
    ts, js = twin.t.stats(), twin.j.stats()
    check_stats("fleet", ts)
    assert set(ts) == set(js)
    for key in ("rounds", "requests", "evictions", "route_hits",
                "route_misses", "steals", "queue_depth", "claims",
                "directory"):
        assert ts[key] == js[key], key
    assert [p["loads"] for p in ts["per_replica"]] == \
        [p["loads"] for p in js["per_replica"]]


@pytest.mark.parametrize("seed", range(4))
def test_grow_drain_soak_matches_the_jax_fleet(kernels, seed):
    """Seeded interleavings of submits and bursts, every drain path, and
    forced ``add_replica`` / ``drain_replica`` with an autoscaler live, on
    both fleets in lockstep: every ticket delivered exactly once, bit for
    bit, the same scaling decisions throughout."""
    rng = np.random.RandomState(0xF1EE7 + seed)
    auto = dict(up_tiles=float(rng.choice([4.0, 16.0])),
                up_rounds=int(rng.choice([1, 2])),
                down_rounds=int(rng.choice([2, 4])), cooldown_s=0.0,
                min_replicas=1, max_replicas=4)
    twin = Twin(kernels, int(rng.choice([1, 2, 3])), autoscale=auto,
                bank_capacity=4, round_kernels=2,
                max_inflight=int(rng.choice([1, 2])),
                steal=bool(rng.rand() < 0.5))
    trace = _trace(400, seed=seed)
    nxt = 0
    for step in range(36):
        action = rng.choice(["submit", "burst", "drain", "result", "grow",
                             "shrink", "launch"],
                            p=[0.3, 0.15, 0.2, 0.1, 0.1, 0.1, 0.05])
        if action in ("submit", "burst"):
            for _ in range(1 if action == "submit" else rng.randint(4, 9)):
                twin.submit(*trace[nxt])
                nxt += 1
        elif action == "drain" and twin.to_oracle:
            twin.drain(rng.choice(DRAINS), rng)
            assert not twin.to_oracle, "a drain left tickets undelivered"
        elif action == "result" and twin.to_oracle:
            t = sorted(twin.to_oracle)[rng.randint(len(twin.to_oracle))]
            twin.check({t: twin.t.result(t)}, {t: twin.j.result(t)},
                       f"step {step}: result({t})")
        elif action == "grow" and twin.j.n_replicas < 5:
            assert twin.t.add_replica() == twin.j.add_replica()
        elif action == "shrink" and twin.j.n_replicas > 1:
            i = int(rng.randint(twin.j.n_replicas))
            assert twin.t.drain_replica(i) == twin.j.drain_replica(i)
        elif action == "launch":
            # rounds in flight when the next grow/drain comes
            for srv in (twin.t, twin.j):
                for rep in srv.replicas:
                    rep._fill_pipeline()
        twin.check_state(f"step {step} ({action})")
    assert twin.t.add_replica() == twin.j.add_replica()
    assert twin.t.drain_replica(0) == twin.j.drain_replica(0)
    twin.drain("flush")
    assert not twin.to_oracle and len(twin.delivered) == nxt
    assert twin.t.pending == 0
    assert twin.t.stats()["orphaned_results"] == 0
    for bank in twin.t.banks:
        assert bank.n_pinned == 0
    ts, js = twin.t.stats(), twin.j.stats()
    for key in ("scale_ups", "scale_downs", "evacuated_requests",
                "evacuated_tiles", "replicas_retired", "peak_replicas",
                "orphan_claims", "claims", "rounds", "requests"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("claim", ("result", "try_result", "as_completed",
                                   "flush_sync"))
def test_orphaned_results_claim_as_the_jax_fleet(kernels, claim):
    """Rounds in flight on a replica that is drained: its delivered
    results move to the fleet's orphan store and every claim path serves
    them, once; a second claim raises on both sides."""
    twin = Twin(kernels, 2, bank_capacity=6, round_kernels=2)
    for name, xs, tenant in _trace(12, seed=9):
        twin.submit(name, xs, tenant)
    for srv in (twin.t, twin.j):
        for rep in srv.replicas:
            rep._fill_pipeline()
        while srv.replicas[0]._inflight:
            srv.replicas[0]._retire_oldest()
    assert twin.t.drain_replica(0) == twin.j.drain_replica(0)
    orphans = sorted(twin.j._orphaned)
    assert orphans and sorted(twin.t._orphaned) == orphans
    t0 = orphans[0]
    rec_t, rec_j = twin.t.record(t0), twin.j.record(t0)
    assert rec_t["replica"] is rec_j["replica"] is None
    assert rec_t["tenant"] == rec_j["tenant"]
    if claim == "result":
        twin.drain("result")
    elif claim == "try_result":
        twin.check({t0: twin.t.try_result(t0)}, {t0: twin.j.try_result(t0)},
                   "try_result")
        twin.drain("as_completed")
    else:
        twin.drain(claim)
    for srv in (twin.t, twin.j):
        with pytest.raises(KeyError, match="already claimed"):
            srv.result(t0)
        with pytest.raises(KeyError):
            srv.try_result(t0)
        with pytest.raises(KeyError, match="unknown"):
            srv.result(10 ** 6)


def test_preemptible_fleet_matches_the_jax_fleet(kernels):
    """``make_preemptible`` on every replica, and on a replica added
    later: bulk tenants run only in rounds the latency tier left idle;
    the same round serves each ticket on both sides."""
    twin = Twin(kernels, 2, bank_capacity=4, round_kernels=2)
    tiers_t = twin.t.make_preemptible({"batch"})
    tiers_j = twin.j.make_preemptible({"batch"})
    assert len(tiers_t) == len(tiers_j) == 2
    assert twin.t.add_replica() == twin.j.add_replica()
    assert isinstance(twin.t.replicas[-1].round_policy,
                      tsched.PreemptibleTier)
    assert twin.t.replicas[-1].round_policy.bulk_tenants == {"batch"}
    rng = np.random.RandomState(4)
    for i, (name, xs, _) in enumerate(_trace(30, seed=4)):
        tenant = ("batch", "bulk:x", "alice", "bob")[rng.randint(4)]
        twin.submit(name, xs, tenant)
    twin.drain("flush")
    for t in range(30):
        assert twin.t.record(t)["round"] == twin.j.record(t)["round"]
    bulk_t = sum(rep.round_policy.n_bulk_rounds for rep in twin.t.replicas)
    bulk_j = sum(rep.round_policy.n_bulk_rounds for rep in twin.j.replicas)
    assert bulk_t == bulk_j > 0
    # the single-engine method of the port, on its own
    srv = tserve.OverlayServer(device="cpu")
    tier = srv.make_preemptible(["batch"])
    assert srv.make_preemptible(["other"]) is tier
    assert tier.bulk_tenants == {"batch", "other"}


def test_fleet_admission_and_work_match_the_jax_fleet(kernels):
    """Admission spans replicas (one bucket per tenant for the fleet),
    and host-side work rides the same tickets."""
    kw = dict(bank_capacity=4, admission={"alice": (1e-6, 3.0)})
    twin = Twin(kernels, 2, **kw)
    name, xs, _ = _trace(1, seed=2, lanes=(256,))[0]   # 2 tiles a request
    twin.submit(name, xs, "alice")
    for srv, k, err in ((twin.t, kernels[name][1], tsched.AdmissionError),
                        (twin.j, kernels[name][0], jsched.AdmissionError)):
        with pytest.raises(err):
            srv.submit(k, xs, tenant="alice")
    wt = twin.t.submit_work(lambda: "done", tenant="bob", cost=3)
    wj = twin.j.submit_work(lambda: "done", tenant="bob", cost=3)
    assert wt == wj
    tres, jres = twin.t.flush(), twin.j.flush()
    assert tres[wt] == jres[wj] == "done"
    del tres[wt], jres[wj]
    twin.check(tres, jres, "flush")
    assert twin.t.queued_by_tenant() == twin.j.queued_by_tenant() == {}


def test_metrics_and_latencies_match_the_jax_fleet(kernels):
    twin = Twin(kernels, 3, bank_capacity=4, slo_s=0.5)
    for name, xs, tenant in _trace(15, seed=11):
        twin.submit(name, xs, tenant)
    twin.drain("flush")
    assert twin.t.latencies() == twin.j.latencies()
    assert (twin.t.tenant_latency_percentiles()
            == twin.j.tenant_latency_percentiles())
    assert twin.t.latency_percentiles() == twin.j.latency_percentiles()
    twin.t.reset_metrics()
    twin.j.reset_metrics()
    assert twin.t.latencies() == twin.j.latencies() == {}
    assert twin.t.n_route_hits == twin.j.n_route_hits == 0
    assert twin.t.residency_hit_rate != twin.t.residency_hit_rate  # NaN


def test_drain_and_grow_refuse_as_the_jax_fleet(kernels):
    twin = Twin(kernels, 1, bank_capacity=4)
    for srv in (twin.t, twin.j):
        with pytest.raises(ValueError, match="last replica"):
            srv.drain_replica(0)
        with pytest.raises(IndexError):
            srv.drain_replica(3)
    assert twin.t.add_replica(device="cpu") == 1
    assert twin.t.devices == [CPU, CPU]


# ------------------------------------------------------------ serving mesh
class _JaxLikeDevice:
    def __init__(self, i):
        self.id = i


def test_serving_mesh_places_as_the_reference():
    """Placement by the same rule: wrap round the pool, count sharing per
    device, grow onto the least shared device with ties on the lowest
    key.  The port keys a CUDA device by its index and the CPU by
    ``CPU_KEY``."""
    cuda = [torch.device("cuda", i) for i in range(4)]
    fake = [_JaxLikeDevice(i) for i in range(4)]
    for n in (1, 3, 4, 6, 9):
        got = tmesh.make_serving_mesh(n, cuda)
        want = jmesh.make_serving_mesh(n, fake)
        assert [d.index for d in got] == [d.id for d in want]
        assert tmesh.device_sharing(got) == jmesh.device_sharing(want)
        pick = tmesh.least_shared_device(cuda, got)
        assert pick.index == jmesh.least_shared_device(fake, want).id
    cpus = tmesh.make_serving_mesh(4, [CPU])
    assert cpus == [CPU] * 4
    assert tmesh.device_sharing(cpus) == {tmesh.CPU_KEY: 4}
    assert tmesh.device_key(torch.device("cuda", 2)) == 2
    assert tmesh.least_shared_device([CPU, torch.device("cuda", 0)],
                                     [CPU]) == torch.device("cuda", 0)
    for pkg, pool in ((tmesh, cuda), (jmesh, fake)):
        with pytest.raises(ValueError):
            pkg.make_serving_mesh(0, pool)
        with pytest.raises(ValueError):
            pkg.least_shared_device([], pool)


def test_fleet_wants_a_card_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.ShardedOverlayServer(n_replicas=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_serving_mesh(2)


# ------------------------------------------------------------------ card
@pytest.mark.cuda
def test_each_replica_owns_a_distinct_non_default_stream(kernels):
    """On the card every replica's ``OverlayServer`` owns its own stream,
    none of them the default stream, and its bank's tensors were made
    there; the fleet delivers what the CPU fleet delivers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    fleet = tserve.ShardedOverlayServer(n_replicas=4, bank_capacity=4,
                                        devices=[dev], steal=True)
    streams = [rep.stream for rep in fleet.replicas]
    assert all(isinstance(s, torch.cuda.Stream) for s in streams)
    assert len({s.cuda_stream for s in streams}) == 4
    default = torch.cuda.default_stream(dev).cuda_stream
    assert default not in {s.cuda_stream for s in streams}
    fleet.add_replica()
    assert len({rep.stream.cuda_stream for rep in fleet.replicas}) == 5
    cpu = tserve.ShardedOverlayServer(n_replicas=4, bank_capacity=4,
                                      devices=[CPU], steal=True)
    trace = _trace(24, seed=6)
    for name, xs, tenant in trace:
        fleet.submit(kernels[name][1], xs, tenant=tenant)
        cpu.submit(kernels[name][1], xs, tenant=tenant)
    got, want = fleet.flush(), cpu.flush()
    assert sorted(got) == sorted(want)
    for t in want:
        for y, w in zip(got[t], want[t]):
            assert_same_bits(np.asarray(y), np.asarray(w), f"ticket {t}")
