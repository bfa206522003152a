"""Every generator of inputs gives the same inputs for the same seed, and
other inputs for another; seeds past 32 bits are taken."""

import numpy as np
import pytest
import torch

from chipbench.tests.support import tiny_cell

BIG = 2 ** 31 + 12345


class _Engine:
    """Stands in for ``OverlayServer``: notes what is submitted and hands
    the tickets back in order."""

    def __init__(self):
        self.submitted = []

    def submit(self, kernel, inputs, tenant):
        self.submitted.append((kernel, tenant, inputs[0][:4].tobytes()))
        return len(self.submitted) - 1

    def as_completed(self):
        i = 0
        while True:
            yield i, [np.zeros(1, np.float32)]
            i += 1


def _closed_loop(cell, pools, seed, results):
    from chipbench.drivers import overlay_closed as CL
    from chipbench.lib.record import seed_int
    tr = cell.traffic
    tenants = [(f"bulk{i}", i % 9) for i in range(tr["tenants"])]
    eng = _Engine()
    loop = CL.ClosedLoop(eng, list(range(9)), pools, tenants,
                         tr["outstanding_per_tenant"], tr["lanes"],
                         np.random.default_rng(seed_int(seed, 2)))
    for _ in range(results):
        ticket, _ = next(loop.results)
        ti, _, _ = loop.outstanding.pop(ticket)
        loop._submit(ti)
    return eng.submitted


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 1])
def test_overlay_pools_and_schedules(seed):
    """The input pools and the closed loop's submissions (tenant, kernel
    and input set of each) follow the seed."""
    from chipbench.drivers import overlay_common as C
    cell = tiny_cell("tmfu-paper9.bulk")
    cfg, tr = cell.config, cell.traffic
    a = C.input_pools(cfg, seed, 2, 256)
    b = C.input_pools(cfg, seed, 2, 256)
    c = C.input_pools(cfg, seed + 1, 2, 256)
    flat = lambda p: np.concatenate([x for k in p for s in k for x in s])
    assert np.array_equal(flat(a), flat(b))
    assert not np.array_equal(flat(a), flat(c))
    assert np.abs(flat(a)).max() <= 2.0
    s1 = _closed_loop(cell, a, seed, 64)
    assert s1 == _closed_loop(cell, b, seed, 64)
    assert s1 != _closed_loop(cell, a, seed + 1, 64)
    n = tr["tenants"] * tr["outstanding_per_tenant"]
    assert len(s1) == n + 64
    assert [t for _, t, _ in s1[:n]] == [
        f"bulk{i}" for i in range(tr["tenants"])
        for _ in range(tr["outstanding_per_tenant"])]
    assert all(k == int(t[4:]) % 9 for k, t, _ in s1)


@pytest.mark.parametrize("seed", [3, BIG])
def test_token_rows_and_weights(seed):
    from chipbench.drivers import lm_common as L
    from chipbench.reference import dense_lm as R
    docs = tiny_cell("deepseek-7b.train").traffic["documents"]
    a = L.token_rows(seed, 11, 4, 64, 256, docs)
    assert a.shape == (4, 64) and a.dtype == np.int32
    assert np.array_equal(a, L.token_rows(seed, 11, 4, 64, 256, docs))
    assert not np.array_equal(a, L.token_rows(seed + 1, 11, 4, 64, 256,
                                              docs))
    assert a.min() >= 0 and a.max() < 256
    cfg = tiny_cell("deepseek-7b.train").config
    d = R.dims(cfg)
    w1 = R.make_weights(d, seed, "cpu")
    w2 = R.make_weights(d, seed, "cpu")
    w3 = R.make_weights(d, seed + 1, "cpu")
    for n in w1:
        assert torch.equal(w1[n], w2[n])
        assert torch.equal(w1[n], R.make_leaf(d, n, seed, "cpu"))
    assert not torch.equal(w1["wq"], w3["wq"])
