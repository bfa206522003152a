"""Training as a tenant on the port (``repro_torch.launch.trainer_tenant``),
the reference's suite (``tests/test_train_tenant.py``) on the port's
``OverlayServer`` and ``ShardedOverlayServer``, on the CPU:

1. co-scheduled == standalone ``run_training``, bit for bit — params,
   opt_state, loss trace — under the three round policies (latency
   traffic every beat) and under fleet grow / drain churn;
2. preempt / resume exactly once, 4 seeded preemption schedules, plain
   and with int8 gradient compression (``ef`` survives every yield);
3. serving starves training and never the reverse; serving p99 with
   training stays within a generous bound of the dedicated engine;
4. ``train.*`` counters fan out to the server's sink; ``check_stats``;
5. the seed-matrix determinism of ``make_train_step`` (plain,
   compressed, mixed).

Every serving result is held bit for bit against ``Overlay.dispatch``.
One ``cuda``-marked test runs the tenant on a CUDA ``OverlayServer``
against a standalone run on the card (skipped where there is no card).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.bank import ContextBank
from repro_torch.core.overlay import Overlay, compile_program
from repro_torch.core.paper_bench import benchmark
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.serve import OverlayServer, ShardedOverlayServer
from repro_torch.launch.train import run_training
from repro_torch.launch.trainer_tenant import TrainingTenant
from repro_torch.models import init_params
from repro_torch.models.blocks import tree_map
from repro_torch.runtime import optim as O
from repro_torch.runtime.steps import make_train_step
from repro_torch.sched import (CoalescingPolicy, DeficitRoundRobin,
                               DynamicTilePolicy, PreemptibleTier)
from repro_torch.telemetry import check_stats
from torch_port_support import assert_trees_bitwise

CPU = torch.device("cpu")
POLICIES = {
    "drr": lambda: DeficitRoundRobin(quantum_tiles=2.0),
    "coalesce": lambda: CoalescingPolicy(quantum_tiles=2.0,
                                         coalesce_tiles=8),
    "dynamic": lambda: DynamicTilePolicy(quantum_tiles=2.0, init_tiles=8,
                                         min_tiles=2),
}
STEPS = 8


@pytest.fixture(scope="module")
def cfgs():
    cfg = get_smoke_config("deepseek-7b")
    oc = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    dc = DataConfig(global_batch=2, seq_len=32, vocab=cfg.vocab)
    return cfg, oc, dc


@pytest.fixture(scope="module")
def step_fn(cfgs):
    cfg, oc, _ = cfgs
    return make_train_step(cfg, oc)


@pytest.fixture(scope="module")
def step_fn_compress(cfgs):
    cfg, oc, _ = cfgs
    return make_train_step(cfg, oc, compress_grads=True)


def _standalone(cfgs, *, steps=STEPS, step_fn=None, compress=False,
                device=CPU):
    """The reference: a plain ``run_training`` loop, no engine."""
    cfg, oc, dc = cfgs
    params, opt, losses = None, None, []
    for rec in run_training(cfg, oc, dc, steps=steps, yield_every=1,
                            compress_grads=compress, step_fn=step_fn,
                            device=device):
        params, opt = rec["params"], rec["opt_state"]
        losses.append(rec["loss"])
    return params, opt, losses


@pytest.fixture(scope="module")
def ref(cfgs, step_fn):
    return _standalone(cfgs, step_fn=step_fn)


@pytest.fixture(scope="module")
def ref_compress(cfgs, step_fn_compress):
    return _standalone(cfgs, step_fn=step_fn_compress, compress=True)


@pytest.fixture(scope="module")
def kernel():
    return compile_program(benchmark("poly5"))


def _xs(kernel, batch, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-2, 2, (batch,)).astype(np.float32)
            for _ in kernel.dfg.inputs]


def _oracle(k, xs, device=CPU):
    [want] = Overlay(device=device).dispatch(ContextBank(4, device=device),
                                             [(k, xs)])
    return want


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    np.testing.assert_array_equal(_host(got).view(np.uint32),
                                  _host(want).view(np.uint32))


def _drive_cosched(server, tenant, kernel, *, beats_cap=64, device=CPU):
    """Tick the tenant between serving beats until training finishes;
    every serving request must come back same-beat and bit-exact."""
    beat = 0
    while not tenant.done:
        xs = _xs(kernel, 4, beat)
        t = server.submit(kernel, xs, tenant="alice")
        tenant.tick()
        res = server.flush()
        assert t in res, "serving request starved by training"
        _same(res[t][0], _oracle(kernel, xs, device)[0])
        beat += 1
        assert beat < beats_cap, "co-scheduled run failed to finish"
    return beat


def _assert_same_run(tenant, want):
    ref_params, ref_opt, ref_losses = want
    assert tenant.losses == ref_losses
    assert_trees_bitwise(tenant.params, ref_params, "params")
    assert_trees_bitwise(tenant.opt_state, ref_opt, "opt_state")


# ============================================== differential: bit-identity
@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_cosched_bit_identity_policies(cfgs, step_fn, ref, kernel, policy):
    cfg, oc, dc = cfgs
    srv = OverlayServer(bank_capacity=8, round_policy=POLICIES[policy](),
                        device=CPU)
    tenant = TrainingTenant(srv, cfg, oc, dc, steps=STEPS, yield_every=3,
                            step_fn=step_fn)
    assert isinstance(srv.round_policy, PreemptibleTier)
    assert tenant.stream is None          # CPU: no stream of its own
    _drive_cosched(srv, tenant, kernel)
    _assert_same_run(tenant, ref)
    assert tenant.step_trace == list(range(STEPS))
    st = tenant.stats()
    check_stats("train", st)
    assert st["steps"] == STEPS and st["done"]


def test_cosched_bit_identity_fleet_churn(cfgs, step_fn, ref, kernel):
    cfg, oc, dc = cfgs
    fleet = ShardedOverlayServer(n_replicas=2, bank_capacity=6,
                                 devices=[CPU] * 2)
    tenant = TrainingTenant(fleet, cfg, oc, dc, steps=STEPS, yield_every=2,
                            step_fn=step_fn)
    beat = 0
    while not tenant.done:
        if beat == 1:
            fleet.add_replica()
        if beat == 3:
            fleet.drain_replica(0)
        xs = _xs(kernel, 4, beat)
        t = fleet.submit(kernel, xs, tenant="alice")
        tenant.tick()
        res = fleet.flush()
        assert t in res
        _same(res[t][0], _oracle(kernel, xs)[0])
        beat += 1
        assert beat < 64
    _assert_same_run(tenant, ref)
    check_stats("fleet", fleet.stats())
    for rep in fleet.replicas:
        assert isinstance(rep.round_policy, PreemptibleTier)


# ===================================== exactly-once preempt/resume property
def _random_yield(seed):
    """Seeded preemption schedule: always preempt at the first poll, then
    coin-flip every boundary."""
    rng = np.random.RandomState(seed)
    state = {"first": True}

    def should_yield():
        if state["first"]:
            state["first"] = False
            return True
        return bool(rng.rand() < 0.5)

    return should_yield


@pytest.mark.parametrize("seed", [0, 1, 2, 3],
                         ids=[f"seed{i}" for i in range(4)])
def test_preempt_resume_exactly_once(cfgs, step_fn, ref, kernel, seed):
    cfg, oc, dc = cfgs
    srv = OverlayServer(bank_capacity=8, device=CPU)
    tenant = TrainingTenant(srv, cfg, oc, dc, steps=STEPS, yield_every=4,
                            step_fn=step_fn, should_yield=_random_yield(seed))
    _drive_cosched(srv, tenant, kernel)
    assert tenant.step_trace == list(range(STEPS)), "step lost or doubled"
    _assert_same_run(tenant, ref)
    st = tenant.stats()
    check_stats("train", st)
    assert st["preemptions"] >= 1
    assert st["resumes"] == st["preemptions"], "unpaired preempt/resume"
    assert tenant.cursor == SyntheticCorpus(dc).cursor(STEPS)


@pytest.mark.parametrize("seed", [0, 1, 2, 3],
                         ids=[f"seed{i}" for i in range(4)])
def test_preempt_resume_exactly_once_compressed(cfgs, step_fn_compress,
                                                ref_compress, kernel, seed):
    cfg, oc, dc = cfgs
    srv = OverlayServer(bank_capacity=8, device=CPU)
    tenant = TrainingTenant(srv, cfg, oc, dc, steps=STEPS, yield_every=4,
                            compress_grads=True, step_fn=step_fn_compress,
                            should_yield=_random_yield(seed))
    _drive_cosched(srv, tenant, kernel)
    assert tenant.step_trace == list(range(STEPS))
    assert "ef" in tenant.opt_state, "error-feedback state dropped"
    _assert_same_run(tenant, ref_compress)
    assert tenant.stats()["resumes"] == tenant.stats()["preemptions"] >= 1


# ================================================= starvation is one-sided
def test_serving_starves_training_never_reverse(cfgs, step_fn, kernel):
    cfg, oc, dc = cfgs
    srv = OverlayServer(bank_capacity=8, max_inflight=1, device=CPU)
    tenant = TrainingTenant(srv, cfg, oc, dc, steps=4, yield_every=2,
                            step_fn=step_fn)
    tenant.tick()                      # micro-round queued on the bulk tier
    tier = srv.round_policy
    tickets = [srv.submit(kernel, _xs(kernel, 4, i), tenant="alice")
               for i in range(2)]
    for i in range(12):
        tickets.append(srv.submit(kernel, _xs(kernel, 4, 10 + i),
                                  tenant="alice"))
        srv.pump_once()
        assert tier.n_bulk_rounds == 0, "bulk round formed under backlog"
        assert tenant.stats()["steps"] == 0, "training ran while starved"
    assert int(srv.telemetry.counter("engine.rounds")) >= 10
    res = srv.flush()
    assert all(t in res for t in tickets), "serving starved — never allowed"
    tenant.run()
    assert tenant.done and tenant.stats()["steps"] == 4
    assert tier.n_bulk_rounds >= 1


def test_serving_p99_bounded_under_training(cfgs, step_fn, kernel):
    """A structural guard (a latency round retiring behind a bulk launch
    would break it), with the reference's generous bound."""
    cfg, oc, dc = cfgs

    def drive(with_training):
        srv = OverlayServer(bank_capacity=8, max_inflight=1, device=CPU)
        tenant = None
        if with_training:
            tenant = TrainingTenant(srv, cfg, oc, dc, steps=6,
                                    yield_every=2, step_fn=step_fn)
        for beat in range(12):
            xs = _xs(kernel, 4, beat)
            t = srv.submit(kernel, xs, tenant="alice")
            if tenant is not None:
                tenant.tick()
            res = srv.flush()
            assert t in res
        return srv.tenant_latency_percentiles()["alice"]["p99"]

    p99_dedicated = drive(with_training=False)
    p99_cosched = drive(with_training=True)
    assert p99_cosched <= p99_dedicated * 10 + 0.25, (
        p99_cosched, p99_dedicated)


# ============================================ telemetry: train.* counters
def test_train_counters_fan_out_to_server_sink(cfgs, step_fn):
    cfg, oc, dc = cfgs
    srv = OverlayServer(bank_capacity=4, device=CPU)
    tenant = TrainingTenant(srv, cfg, oc, dc, steps=2, yield_every=2,
                            step_fn=step_fn)
    tenant.run()
    assert int(srv.telemetry.counter("train.steps")) == 2
    assert int(tenant.telemetry.counter("train.steps")) == 2
    check_stats("train", tenant.stats())


def test_tenant_rejects_bad_arguments(cfgs):
    cfg, oc, dc = cfgs
    srv = OverlayServer(bank_capacity=4, device=CPU)
    with pytest.raises(ValueError, match="exceed"):
        TrainingTenant(srv, cfg, oc, dc, steps=2, start_step=2)
    with pytest.raises(ValueError, match="yield_every"):
        TrainingTenant(srv, cfg, oc, dc, steps=2, yield_every=0)


# ====================================== seed-matrix determinism regression
@pytest.mark.parametrize("variant", ["plain", "compress", "mixed"])
def test_seed_matrix_step_determinism(cfgs, variant):
    cfg, oc, dc = cfgs
    compress = variant == "compress"
    mixed = variant == "mixed"

    def one_run():
        params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
        if mixed:
            params = tree_map(lambda p: p.to(torch.bfloat16), params)
        opt = O.init_opt_mixed(params) if mixed else O.init_opt(params)
        fn = make_train_step(cfg, oc, compress_grads=compress, mixed=mixed)
        last = None
        for rec in run_training(cfg, oc, dc, steps=4, params=params,
                                opt_state=opt, compress_grads=compress,
                                mixed=mixed, step_fn=fn):
            last = rec
        return last["params"], last["opt_state"], last["loss"]

    p1, o1, l1 = one_run()
    p2, o2, l2 = one_run()
    assert l1 == l2
    assert_trees_bitwise(p1, p2, "params")
    assert_trees_bitwise(o1, o2, "opt_state")


# ================================================================== card
@pytest.mark.cuda
def test_cuda_tenant_equals_standalone_card_run(cfgs, kernel):
    """On the card: the tenant's steps run on its own stream inside the
    replica's rounds, and land bit for bit where a standalone run on the
    default stream lands; every serving result equals the oracle."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, oc, dc = cfgs
    dev = torch.device("cuda", torch.cuda.current_device())
    want = _standalone(cfgs, device=dev)
    srv = OverlayServer(bank_capacity=4, device=dev)
    tenant = TrainingTenant(srv, cfg, oc, dc, steps=STEPS, yield_every=2)
    assert tenant.stream is not None
    assert tenant.stream != torch.cuda.current_stream(dev)
    _drive_cosched(srv, tenant, kernel, device=dev)
    _assert_same_run(tenant, want)
