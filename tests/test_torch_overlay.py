"""``ContextBank`` and ``Overlay`` of the PyTorch port against the JAX
package: the same loads, pins and evictions give the same bank; the same
request lists give byte-identical staging buffers and bit-identical
float32 outputs.  No tolerance anywhere in this file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bank as jbank
from repro.core import overlay as joverlay
from repro.core import paper_bench as jbench
from repro.core.arena import RoundArena as JArena
from repro_torch.core import bank as tbank
from repro_torch.core import overlay as toverlay
from repro_torch.core import paper_bench as tbench
from repro_torch.core.arena import RoundArena as TArena
from torch_port_support import assert_same_bits

torch.set_num_threads(1)

NAMES = tuple(jbench.BENCH_NAMES) + ("gradient",)
BANK_FIELDS = ("op", "src_a", "src_b", "imm", "out_idx")


@pytest.fixture(scope="module")
def kernels():
    """``{name: (jax CompiledKernel, port CompiledKernel)}``."""
    return {n: (joverlay.compile_program(jbench.benchmark(n)),
                toverlay.compile_program(tbench.benchmark(n)))
            for n in NAMES}


def _inputs(kernel, batch, seed):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-2, 2, (batch,)).astype(np.float32)
            for _ in kernel.dfg.inputs]


def _requests(kernels, names, batches, seed=0):
    """The same request list for both packages: ``(jax reqs, port reqs)``."""
    jr, tr = [], []
    for i, (n, b) in enumerate(zip(names, batches)):
        jk, tk = kernels[n]
        xs = _inputs(jk, b, seed * 997 + i)
        jr.append((jk, xs)), tr.append((tk, xs))
    return jr, tr


def _assert_banks_equal(tb, jb):
    assert tb.resident == jb.resident
    assert list(tb._lru.items()) == list(jb._lru.items())
    assert tb._free == jb._free
    assert tb._meta == jb._meta
    assert tb.generation == jb.generation and tb._key_gen == jb._key_gen
    assert tb._pins == jb._pins
    ts, js = tb.stats(), jb.stats()
    assert ts == js
    for f in BANK_FIELDS:
        got, want = getattr(tb, f).numpy(), np.asarray(getattr(jb, f))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f


def _assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            assert_same_bits(a, np.asarray(b))


# ------------------------------------------------------------------- the bank
def test_bank_same_sequence_same_state(kernels):
    """Loads, hits, pins, evictions under pressure, a refused load, retire."""
    jb = jbank.ContextBank(capacity=3)
    tb = tbank.ContextBank(capacity=3, device="cpu")
    _assert_banks_equal(tb, jb)
    script = [("load", "chebyshev"), ("load", "poly5"), ("load", "chebyshev"),
              ("pin", "poly6"), ("load", "mibench"), ("slot_of", "poly6"),
              ("load", "qspline"), ("pin", "gradient"), ("peek", "poly5"),
              ("load", "poly5"), ("unpin", "poly6"), ("load", "sgfilter"),
              ("prefetch", "chebyshev"), ("unpin", "gradient"),
              ("load", "poly8")]
    for verb, name in script:
        jk, tk = kernels[name]
        if verb == "prefetch":
            assert tb.prefetch([tk]) == jb.prefetch([jk])
        else:
            assert getattr(tb, verb)(tk) == getattr(jb, verb)(jk), (verb, name)
        assert tb.evictable_capacity() == jb.evictable_capacity()
        _assert_banks_equal(tb, jb)
    assert jb.n_evictions > 0
    # all slots pinned: both refuse the newcomer the same way
    for name in jb.resident:
        jb.pin(kernels[name][0]), tb.pin(kernels[name][1])
    newcomer = next(n for n in NAMES if n not in jb.resident)
    with pytest.raises(jbank.BankError):
        jb.load(kernels[newcomer][0])
    with pytest.raises(tbank.BankError):
        tb.load(kernels[newcomer][1])
    with pytest.raises(tbank.BankError):
        tb.retire()
    for name in jb.resident:
        jb.unpin(kernels[name][0]), tb.unpin(kernels[name][1])
    _assert_banks_equal(tb, jb)
    jb.retire(), tb.retire()
    _assert_banks_equal(tb, jb)
    assert tb.load(kernels["poly5"][1]) == jb.load(kernels["poly5"][0]) == 0


def test_bank_rejects_like_the_reference(kernels):
    with pytest.raises(tbank.BankError):
        tbank.ContextBank(capacity=0, device="cpu")
    tb = tbank.ContextBank(capacity=2, max_outputs=0, device="cpu")
    with pytest.raises(tbank.BankError):
        tb.load(kernels["poly5"][1])
    with pytest.raises(tbank.BankError):
        tb.unpin(kernels["poly5"][1])
    with pytest.raises(TypeError):
        tbank.ContextBank(capacity=2, dtype=torch.float64, device="cpu")


def test_bank_load_writes_in_place(kernels):
    """A load overwrites the slot's rows of the SAME tensors (no new
    [N, S, IM] allocation per load) and leaves the other slots alone."""
    tb = tbank.ContextBank(capacity=2, device="cpu")
    ptrs = [getattr(tb, f).data_ptr() for f in BANK_FIELDS]
    tb.load(kernels["poly5"][1])
    before = tb.op[0].clone()
    tb.load(kernels["poly6"][1])
    tb.load(kernels["gradient"][1])          # evicts poly5 from slot 0
    assert [getattr(tb, f).data_ptr() for f in BANK_FIELDS] == ptrs
    assert not torch.equal(tb.op[0], before)
    assert tb.resident == ("poly6", "gradient")


def test_context_memo_is_host_side_and_shared(kernels):
    _, tk = kernels["sgfilter"]
    b1 = tbank.ContextBank(2, device="cpu")
    b2 = tbank.ContextBank(2, device="cpu")
    b1.load(tk), b2.load(tk)
    memo = tk.program._ctx_memo
    (ctx,) = [memo[k] for k in memo if k[1] == str(torch.float32)]
    assert all(isinstance(getattr(ctx, f), np.ndarray) for f in BANK_FIELDS)
    assert b1._ctx_cache[tbank.context_key(tk)] is ctx
    assert b2._ctx_cache[tbank.context_key(tk)] is ctx


def _jax_bank_state(jb) -> dict:
    """A JAX bank as numpy arrays and plain values (what ``bank_from_numpy``
    takes); the port never sees a ``jax.Array``."""
    return {"op": np.asarray(jb.op), "src_a": np.asarray(jb.src_a),
            "src_b": np.asarray(jb.src_b), "imm": np.asarray(jb.imm),
            "out_idx": np.asarray(jb.out_idx), "capacity": jb.capacity,
            "s_max": jb.s_max, "max_outputs": jb.max_outputs,
            "lru": list(jb._lru.items()), "meta": dict(jb._meta),
            "generation": jb.generation, "key_gen": dict(jb._key_gen),
            "n_loads": jb.n_loads, "n_evictions": jb.n_evictions,
            "n_hits": jb.n_hits}


def test_bank_from_numpy_carries_a_churned_bank_across(kernels):
    jb = jbank.ContextBank(capacity=4)
    for name in ("chebyshev", "poly5", "poly6", "mibench", "qspline",
                 "poly5", "sgfilter", "gradient", "chebyshev"):
        jb.load(kernels[name][0])
    assert jb.n_evictions >= 3
    tb = tbank.bank_from_numpy(_jax_bank_state(jb), device="cpu")
    assert tb.resident == jb.resident and tb.generation == jb.generation
    for f in BANK_FIELDS:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    # the same [G, max_outputs, T] for the same ctx_ids and x
    from repro.core import vm as jvm
    from repro_torch.kernels.tmfu import ops as tops
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 4, size=8).astype(np.int32)
    x = rng.uniform(-2, 2, (8, 32, 128)).astype(np.float32)
    want = jvm.vm_exec_multi(jb.tree(), jb.out_idx, jnp.asarray(ids),
                             jnp.asarray(x))
    got = tops.tmfu_pipeline_multi(tb, torch.from_numpy(ids),
                                   torch.from_numpy(x))
    assert_same_bits(got.numpy(), np.asarray(want))
    # and the same slot (and victim) for the next loads
    for name in ("poly8", "poly5", "mibench"):
        assert tb.load(kernels[name][1]) == jb.load(kernels[name][0]), name
        assert tb.resident == jb.resident
        for f in BANK_FIELDS:
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)))
    drop = {"ctx_cache"}     # the host-side encode cache is not bank state
    assert {k: v for k, v in tb.stats().items() if k not in drop} == \
        {k: v for k, v in jb.stats().items() if k not in drop}


def test_context_from_numpy_carries_a_context_across(kernels):
    from repro.core import vm as jvm
    from repro_torch.core import vm as tvm
    jk, tk = kernels["qspline"]
    jc = jvm.make_context(jk.program)
    fields = {f: np.asarray(getattr(jc, f)) for f in BANK_FIELDS}
    fields.update(n_inputs=jc.n_inputs, n_outputs=jc.n_outputs,
                  context_bytes=jc.context_bytes)
    tc = tvm.context_from_numpy(fields, device="cpu")
    xs = _inputs(jk, 128, 0)
    want = jvm.vm_exec(jc.tree(), jc.out_idx,
                       jvm.pad_inputs([jnp.asarray(v) for v in xs]))
    got = tvm.vm_exec(tc.tree(), tc.out_idx,
                      tvm.pad_inputs([torch.from_numpy(v) for v in xs]))
    assert_same_bits(got.numpy(), np.asarray(want))


def test_bank_directory_follows_generations(kernels):
    tb = tbank.ContextBank(capacity=1, device="cpu")
    d = tbank.BankDirectory()
    _, k5 = kernels["poly5"]
    _, k6 = kernels["poly6"]
    tb.load(k5)
    d.publish_current(k5, 0, tb)
    assert d.locate(k5, [tb]) == 0
    tb.load(k6)                               # evicts poly5
    assert d.locate(k5, [tb]) is None
    assert d.stats()["stale"] == 1


# ------------------------------------------------------------------- assemble
MIXED = (list(NAMES) * 2,
         [64, 100, 128, 300, 17, 256, 90, 128, 1][::-1] + [128] * 9)


@pytest.mark.parametrize("use_arena", (False, True), ids=("fresh", "arena"))
def test_assemble_byte_identical(kernels, use_arena):
    jov = joverlay.Overlay(arena=JArena() if use_arena else None)
    tov = toverlay.Overlay(device="cpu",
                           arena=TArena() if use_arena else None)
    tref = toverlay.Overlay(device="cpu")
    jb = jov.load_many([k[0] for k in kernels.values()])
    tb = tov.load_many([k[1] for k in kernels.values()])
    pool = (17, 48, 64, 96, 200)
    for seed in range(3):                    # rounds 2+ reuse dirtied blocks
        rng = np.random.RandomState(seed)
        names = [NAMES[i % len(NAMES)] for i in range(10)] if seed else MIXED[0]
        batches = ([int(rng.choice(pool)) for _ in names] if seed
                   else MIXED[1])
        jr, tr = _requests(kernels, names, batches, seed)
        jp, tp = jov.plan(jb, jr), tov.plan(tb, tr)
        assert (tp.g_total, tp.g_pad) == (jp.g_total, jp.g_pad)
        assert [(g.key, g.idxs, g.slot, g.lens, g.total, g.n_tiles, g.start)
                for g in tp.groups] == \
            [(g.key, g.idxs, g.slot, g.lens, g.total, g.n_tiles, g.start)
             for g in jp.groups]
        j_ids, j_x = jov.assemble(jp)
        t_ids, t_x = tov.assemble(tp)
        r_ids, r_x = tref.assemble_reference(tref.plan(tb, tr))
        for got in ((t_ids, t_x), (r_ids, r_x)):
            assert got[0].dtype == torch.int32
            assert got[0].numpy().tobytes() == np.asarray(j_ids).tobytes()
            assert got[1].numpy().tobytes() == np.asarray(j_x).tobytes()
        if use_arena:
            # the device copy never aliases the pooled host block
            assert not np.shares_memory(t_x.numpy(), tp.block.x)
        jp.release(jb), tp.release(tb)
    if use_arena:
        assert tov.arena.stats() == jov.arena.stats()
        assert tov.arena.stats()["recycles"] >= 2


def test_assemble_empty_round(kernels):
    tov = toverlay.Overlay(device="cpu", arena=TArena())
    tb = tov.load_many([k[1] for k in kernels.values()])
    _, k = kernels["poly5"]
    p = tov.plan(tb, [(k, [np.zeros(0, np.float32) for _ in k.dfg.inputs])])
    assert tov.assemble(p) is None and tov.execute(tb, None) is None
    assert tov.arena.stats()["checkouts"] == 0
    assert tov.collect(p, None)[0][0].shape == (0,)
    assert tov.collect(p, None, host=True)[0][0].shape == (0,)
    assert tov.dispatch(tb, []) == []


# ------------------------------------------------------------------- dispatch
CASES = {
    "bank_of_9_mixed": MIXED,
    "five_kernels": (("chebyshev", "poly6", "gradient", "mibench", "qspline"),
                     [200, 64, 128, 33, 256]),
    "one_kernel_many": (("sgfilter",) * 5, [1, 127, 128, 129, 500]),
}


@pytest.mark.parametrize("case", CASES)
def test_dispatch_bit_identical(kernels, case):
    names, batches = CASES[case]
    jov, tov = joverlay.Overlay(), toverlay.Overlay(device="cpu")
    used = list(dict.fromkeys(names))
    jb = jov.load_many([kernels[n][0] for n in used])
    tb = tov.load_many([kernels[n][1] for n in used])
    for seed in (0, 7):
        jr, tr = _requests(kernels, names, batches, seed)
        want = jov.dispatch(jb, jr)
        got = tov.dispatch(tb, tr)
        _assert_outputs_equal(got, want)
        for (k, xs), ys in zip(tr, got):
            assert all(y.shape == xs[0].shape for y in ys)
    _assert_banks_equal(tb, jb)


def test_dispatch_with_eviction_between_rounds(kernels):
    """Capacity 4 over nine kernels: every dispatch evicts; slot ids, bank
    counters and outputs stay those of the reference."""
    jov, tov = joverlay.Overlay(), toverlay.Overlay(device="cpu")
    jb = jbank.ContextBank(4)
    tb = tbank.ContextBank(4, device="cpu")
    for r in range(4):
        names = [NAMES[(3 * r + i) % len(NAMES)] for i in range(4)]
        jr, tr = _requests(kernels, names, [96, 128, 40, 200], seed=r)
        _assert_outputs_equal(tov.dispatch(tb, tr), jov.dispatch(jb, jr))
        _assert_banks_equal(tb, jb)
    assert tb.n_evictions > 0
    jr, tr = _requests(kernels, NAMES[:5], [64] * 5)
    with pytest.raises(jbank.BankError):
        jov.dispatch(jb, jr)
    with pytest.raises(tbank.BankError):
        tov.dispatch(tb, tr)


@pytest.mark.parametrize("donate", (False, True), ids=("fresh", "donated"))
def test_staged_pipeline_arena_and_donation(kernels, donate):
    """plan(pin) -> assemble -> execute -> collect(host) with an arena and
    with the in-place executor, against the JAX ``dispatch``."""
    jov = joverlay.Overlay()
    tov = toverlay.Overlay(device="cpu", arena=TArena(), donate=donate)
    jb = jov.load_many([k[0] for k in kernels.values()])
    tb = tov.load_many([k[1] for k in kernels.values()])
    for seed in range(3):
        names = [NAMES[(i + seed) % len(NAMES)] for i in range(10)]
        jr, tr = _requests(kernels, names, [17, 48, 64, 96, 200] * 2, seed)
        p = tov.plan(tb, tr, pin=True)
        assert tb.n_pinned == len(p.groups)
        ys = tov.execute(tb, tov.assemble(p))
        got = tov.collect(p, ys, host=True)
        p.release(tb)
        assert tb.n_pinned == 0
        _assert_outputs_equal(got, jov.dispatch(jb, jr))
    assert tov.arena.stats()["outstanding"] == 0


# -------------------------------------------------------------------- collect
def test_collect_modes_agree_gather_live_forced(kernels, monkeypatch):
    """``collect(host=True)`` takes the host-backed branch for a CPU tensor;
    on a GPU it always takes the ``_gather_live`` branch.  Force that branch
    here and hold all four deliveries against each other."""
    tov = toverlay.Overlay(device="cpu")
    tb = tov.load_many([k[1] for k in kernels.values()])
    _, tr = _requests(kernels, *MIXED)
    p = tov.plan(tb, tr)
    ys = tov.execute(tb, tov.assemble(p))
    want = tov.collect_reference(p, ys, host=True)
    host_backed = tov.collect(p, ys, host=True)
    calls = []
    real = toverlay._gather_live

    def spy(*a):
        calls.append(a[1:])
        return real(*a)

    monkeypatch.setattr(toverlay, "_host_backed", lambda arr: False)
    monkeypatch.setattr(toverlay, "_gather_live", spy)
    gathered = tov.collect(p, ys, host=True)
    assert calls == [(p.g_total, 1)]         # live tiles, live rows only
    lazy = tov.collect(p, ys, host=False)
    lazy_ref = tov.collect_reference(p, ys, host=False)
    for other in (host_backed, gathered, lazy, lazy_ref):
        _assert_outputs_equal(other, want)
    assert all(isinstance(y, np.ndarray) for ys_ in gathered for y in ys_)
    assert all(isinstance(y, torch.Tensor) for ys_ in lazy for y in ys_)


def test_overlay_call_matches_reference(kernels):
    jov, tov = joverlay.Overlay(), toverlay.Overlay(device="cpu")
    for name in NAMES:
        jk, tk = kernels[name]
        xs = _inputs(jk, 300, 9)
        want = jov(jov.load(jk), [jnp.asarray(v) for v in xs])
        got = tov(tov.load(tk), xs)
        _assert_outputs_equal([got], [want])


def test_bfloat16_overlay_stages_float32_and_casts_on_device(kernels):
    """numpy has no bfloat16: the host staging buffer is float32, the device
    tile stack and the bank are bfloat16, host delivery widens to float32."""
    jov = joverlay.Overlay(dtype=jnp.bfloat16)
    tov = toverlay.Overlay(dtype=torch.bfloat16, device="cpu", arena=TArena())
    names = ("chebyshev", "poly6", "gradient")
    jb = jov.load_many([kernels[n][0] for n in names])
    tb = tov.load_many([kernels[n][1] for n in names])
    assert tb.imm.dtype == torch.bfloat16
    jr, tr = _requests(kernels, names, [100, 128, 40], seed=2)
    p = tov.plan(tb, tr)
    ids, x = tov.assemble(p)
    assert p.block.x.dtype == np.float32 and x.dtype == torch.bfloat16
    got = tov.collect(p, tov.execute(tb, (ids, x)), host=True)
    p.release(tb)
    want = jov.dispatch(jb, jr)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == np.float32
            assert_same_bits(a, np.asarray(b).astype(np.float32))
