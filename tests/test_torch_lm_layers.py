"""The port's LM layers (``repro_torch.models.layers`` / ``ssm`` /
``blocks``) against the reference's, one function at a time, on the CPU.

The same numpy-seeded inputs and weights go through both packages.
Tolerances:

* float32 inputs: ``rtol = atol = 1e-5`` (``F32``).  Both sides compute
  in float32 (unit roundoff 6e-8) and differ only in summation order and
  in the libraries' exp / sin / cos; the largest difference seen is below
  3e-6.  A TF32 matmul (2^-11 = 4.9e-4) or a bfloat16 step (2^-8)
  anywhere would fail it.
* bfloat16 inputs: ``rtol = atol = 2e-2`` (``BF16``), the reference's own
  bfloat16 tolerance (``tests/test_kernel_tmfu.py``): a few bf16 ulps
  (2^-8 = 3.9e-3 each) of rounding that the two CPU libraries place
  differently.
* Where a bfloat16 cache is written, one bf16 ulp (``rtol = 2^-7``, ``atol
  = 1e-5``): the float32 values agree to ``F32`` and the cast may round
  them to neighbouring bf16 numbers; a value near zero is a difference of
  O(1) terms, whose float32 error is absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.blocks as JB
import repro.models.layers as JL
import repro.models.ssm as JS
import repro_torch.models.blocks as TB
import repro_torch.models.layers as TL
import repro_torch.models.ssm as TS
from repro.configs import get_smoke_config as jax_smoke
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.kernels.attn_decode import slot_positions

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_ULP = dict(rtol=2 ** -7, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def to_np(x) -> np.ndarray:
    """float32 (or integer) numpy image of a JAX array or a tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def pair(a: np.ndarray, dtype: str):
    """One float32 numpy array as (JAX array, tensor) of ``dtype``."""
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def params(init_fn, *args, seed=0):
    """(JAX tree, torch tree) of one numpy-drawn param set."""
    tree = TB.tree_map(lambda t: t.numpy(),
                       init_fn(TL.Init.numpy(seed), (), *args))
    return (jax.tree.map(jnp.asarray, tree),
            TB.tree_map(torch.from_numpy, tree))


def close(got, want, tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def randn(*shape, seed=1, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------------ basics
@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_and_linear(dtype):
    jp, tp = params(TL.init_linear, 64, 48)
    g = randn(64, seed=3)
    jx, tx = pair(randn(2, 5, 64), dtype)
    tol = DTYPES[dtype][2]
    close(TL.rms_norm({"g": torch.from_numpy(g)}, tx),
          JL.rms_norm({"g": jnp.asarray(g)}, jx), tol)
    close(TL.linear(tp, tx), JL.linear(jp, jx), tol)


def test_rope_frequencies_identical():
    for hd, theta in ((16, 1e4), (128, 1e4), (256, 1e6)):
        np.testing.assert_array_equal(TL.rope_frequencies(hd, theta),
                                      JL.rope_frequencies(hd, theta))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd,theta", [(16, 1e4), (256, 1e6)])
def test_apply_rope(dtype, hd, theta):
    jx, tx = pair(randn(2, 40, 3, hd), dtype)
    pos = np.broadcast_to(np.arange(40)[None] * 7, (2, 40))
    close(TL.apply_rope(tx, torch.from_numpy(pos.copy()), theta),
          JL.apply_rope(jx, jnp.asarray(pos), theta), DTYPES[dtype][2])


# --------------------------------------------------------------- attention
def _qkv(dtype, B=1, S=48, KH=2, G=2, hd=8, seed=2):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, KH, G, hd), (B, S, KH, hd), (B, S, KH, hd)))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    return ([pair(a, dtype) for a in (q, k, v)]
            + [(jnp.asarray(pos), torch.from_numpy(pos))])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None)])
def test_sdpa(dtype, causal, window):
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = _qkv(dtype)
    close(TL._sdpa(tq, tk, tv, tp, tp, causal, window),
          JL._sdpa(jq, jk, jv, jp, jp, causal, window), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", [(True, None), (True, 12),
                                           (False, None)])
def test_flash(dtype, causal, window):
    """kv in chunks of 16 over 48 + 5 keys (the last chunk padded)."""
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = _qkv(dtype, S=53)
    close(TL._flash(tq, tk, tv, tp, tp, causal, window, kv_chunk=16),
          JL._flash(jq, jk, jv, jp, jp, causal, window, kv_chunk=16),
          DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_windowed(dtype):
    """q in chunks of 16 over 53 queries, window 12."""
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = _qkv(dtype, S=53)
    got = TL._flash_windowed(tq, tk, tv, tp, tp, True, 12, q_chunk=16)
    close(got, JL._flash_windowed(jq, jk, jv, jp, jp, True, 12, q_chunk=16),
          DTYPES[dtype][2])
    # and the port's windowed path equals its own direct attention
    close(got, TL._sdpa(tq, tk, tv, tp, tp, True, 12), DTYPES[dtype][2])


@pytest.mark.parametrize("window", [None, 8])
def test_attention_apply_flash_threshold(window):
    """``attention_apply`` past a small ``flash_threshold`` takes the
    chunked paths (windowed when a causal window is set), as the
    reference's does."""
    dims_j, dims_t = JL.AttnDims(4, 2, 16), TL.AttnDims(4, 2, 16)
    jp, tp = params(TL.init_attention, 64, dims_t)
    jx, tx = pair(randn(1, 40, 64), "float32")
    pos = np.broadcast_to(np.arange(40)[None], (1, 40)).copy()
    kw = dict(causal=True, window=window, flash_threshold=16)
    close(TL.attention_apply(tp, tx, dims=dims_t,
                             positions=torch.from_numpy(pos), **kw),
          JL.attention_apply(jp, jx, dims=dims_j, positions=jnp.asarray(pos),
                             **kw), F32)


@pytest.mark.parametrize("window", [None, 6])
def test_attention_decode_past_a_wrap(window):
    """A ring cache of 8 slots decoded from position 5 to 20: the writes
    wrap twice; every step's output and cache agree."""
    dims_j, dims_t = JL.AttnDims(4, 2, 16), TL.AttnDims(4, 2, 16)
    jp, tp = params(TL.init_attention, 64, dims_t)
    ck = randn(2, 8, 2, 16, seed=4)
    cv = randn(2, 8, 2, 16, seed=5)
    jk, tk = pair(ck, "bfloat16")
    jv, tv = pair(cv, "bfloat16")
    for pos in range(5, 21):
        jx, tx = pair(randn(2, 1, 64, seed=10 + pos), "float32")
        jo, jk, jv = JL.attention_decode(jp, jx, jk, jv, jnp.asarray(pos),
                                         dims=dims_j, window=window)
        to, tk, tv = TL.attention_decode(tp, tx, tk, tv, pos, dims=dims_t,
                                         window=window)
        close(tk, jk, BF16_ULP)
        close(tv, jv, BF16_ULP)
        # the step's output read caches that agree to one bf16 ulp
        np.testing.assert_allclose(to_np(to), to_np(jo), rtol=2e-3,
                                   atol=2e-3)
        # continue both from the same caches
        tk = torch.from_numpy(to_np(jk)).bfloat16()
        tv = torch.from_numpy(to_np(jv)).bfloat16()


def test_slot_positions_ring():
    got = slot_positions(8, 20, "cpu").tolist()
    assert got == [16, 17, 18, 19, 20, 13, 14, 15]
    assert slot_positions(8, 3, "cpu").tolist()[:4] == [0, 1, 2, 3]
    assert all(p < 0 for p in slot_positions(8, 3, "cpu").tolist()[4:])


@pytest.mark.parametrize("S", [12, 40])
def test_block_fill_cache_ring_layout(S):
    """gemma3's sliding-window block (smoke window 16): S = 12 fills the
    head of its cache, S = 40 > W fills it in ring layout."""
    jcfg, tcfg = jax_smoke("gemma3-4b"), torch_smoke("gemma3-4b")
    jspec, tspec = jcfg.stacks[0].blocks[0], tcfg.stacks[0].blocks[0]
    assert tspec.window == 16
    tree = TB.tree_map(lambda t: t.numpy(),
                       TB.init_block(TL.Init.numpy(0), (), tcfg, tspec))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = TB.tree_map(torch.from_numpy, tree)
    jh, th = pair(randn(2, S, 64), "float32")
    jc = JB.init_block_cache(jcfg, jspec, 2, 48)
    tc = TB.init_block_cache(tcfg, tspec, 2, 48)
    assert tc["k"].shape == jc["k"].shape == (2, 16, 2, 32)
    jn = JB.block_fill_cache(jcfg, jspec, jp, jh, jc)
    tn = TB.block_fill_cache(tcfg, tspec, tp, th, tc)
    for key in ("k", "v"):
        close(tn[key], jn[key], BF16_ULP)
        assert tn[key].dtype == torch.bfloat16


# ---------------------------------------------------------------- MLP, MoE
@pytest.mark.parametrize("dtype", DTYPES)
def test_mlp(dtype):
    jp, tp = params(TL.init_mlp, 64, 128)
    jx, tx = pair(randn(2, 5, 64), dtype)
    close(TL.mlp_apply(tp, tx), JL.mlp_apply(jp, jx), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe(dtype, n_shared):
    """Six experts, top-2, 40 tokens.  The router probabilities have no
    ties (checked), so ``torch.topk`` and ``lax.top_k`` pick the same
    experts; the aux loss agrees to ``F32`` either way."""
    jp, tp = params(TL.init_moe, 64, 32, 6, n_shared, 64 if n_shared else None)
    x = randn(2, 20, 64)
    jx, tx = pair(x, dtype)
    probs = np.asarray(jax.nn.softmax(
        JL.linear(jp["router"], jx.reshape(40, 64)).astype(jnp.float32), -1))
    top3 = np.sort(probs, -1)[:, -3:]
    assert np.diff(top3, axis=-1).min() > 1e-4, "router near-tie"
    to, taux = TL.moe_apply(tp, tx, top_k=2)
    jo, jaux = JL.moe_apply(jp, jx, top_k=2)
    close(to, jo, DTYPES[dtype][2])
    np.testing.assert_allclose(float(taux), float(jaux), **F32)


def test_moe_routes_like_the_reference():
    """The expert ids and the stable sort order agree exactly."""
    jp, tp = params(TL.init_moe, 64, 32, 6)
    jx, tx = pair(randn(40, 64), "float32")
    _, jeid = jax.lax.top_k(jax.nn.softmax(JL.linear(jp["router"], jx)), 2)
    _, teid = torch.topk(torch.softmax(TL.linear(tp["router"], tx), -1), 2)
    np.testing.assert_array_equal(teid.numpy(), np.asarray(jeid))
    flat = teid.reshape(-1)
    np.testing.assert_array_equal(
        torch.argsort(flat, stable=True).numpy(),
        np.asarray(jnp.argsort(jeid.reshape(-1))))


def test_top_k_breaks_ties_like_lax_top_k():
    """Rows with exact ties (as bf16 router logits give): the port's
    ``lax_top_k`` picks the lower index first, as ``lax.top_k`` does;
    ``torch.topk`` does not promise an order for ties."""
    x = np.array([[0.25, 0.5, 0.25, 0.5, 0.125],
                  [1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.0, 0.75, 0.75, 0.5, 0.75]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = TL.lax_top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_grouped_matmul_is_ragged_dot():
    rng = np.random.RandomState(0)
    xs = rng.standard_normal((10, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8, 5)).astype(np.float32)
    sizes = [3, 0, 5, 2]
    want = jax.lax.ragged_dot(jnp.asarray(xs), jnp.asarray(w),
                              jnp.asarray(sizes, jnp.int32))
    close(TL.grouped_matmul(torch.from_numpy(xs), torch.from_numpy(w), sizes),
          want, F32)


@pytest.mark.parametrize("top_k", [2, 3, 4])
@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_bf16_bits_equal_the_reference(top_k, n_shared):
    """Eight experts, 40 tokens, bfloat16: the port's output is the
    reference's bit for bit at every ``top_k``.  The reference scatter-adds
    a token's k outputs in expert-sorted order (ascending expert id); at
    k >= 3 another order rounds differently in a few hundred of the 2 560
    values, inside ``BF16``, so only bit equality sees it."""
    jp, tp = params(TL.init_moe, 64, 32, 8, n_shared,
                    64 if n_shared else None)
    jx, tx = pair(randn(2, 20, 64), "bfloat16")
    to, _ = TL.moe_apply(tp, tx, top_k=top_k)
    jo, _ = JL.moe_apply(jp, jx, top_k=top_k)
    np.testing.assert_array_equal(to.view(torch.int16).numpy(),
                                  np.asarray(jo).view(np.int16))


def test_moe_combine_is_deterministic():
    """Two runs give the same bits (the combine has no atomics)."""
    _, tp = params(TL.init_moe, 64, 32, 6)
    _, tx = pair(randn(2, 20, 64), "bfloat16")
    a, _ = TL.moe_apply(tp, tx, top_k=2)
    b, _ = TL.moe_apply(tp, tx, top_k=2)
    assert torch.equal(a, b)


# --------------------------------------------------------------------- SSM
DIMS = dict(d_model=32, d_state=8, d_conv=4, expand=2, head_dim=8)


def _mamba(seed=0):
    dj, dt = JS.SSMDims(**DIMS), TS.SSMDims(**DIMS)
    jp, tp = params(TS.init_mamba2, dt, seed=seed)
    return dj, dt, jp, tp


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv(dtype):
    _, _, jp, tp = _mamba()
    jx, tx = pair(randn(2, 11, 80), dtype)
    close(TS._causal_conv(tx, tp["conv_w"], tp["conv_b"]),
          JS._causal_conv(jx, jp["conv_w"], jp["conv_b"]), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_chunked_past_one_chunk(dtype):
    """L = 37 with chunks of 8: four full chunks and a padded tail."""
    b, l, h, p, g, n = 2, 37, 4, 8, 1, 8
    rng = np.random.RandomState(0)
    xh = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((b, l, g, n)).astype(np.float32)
              for _ in range(2))
    D = rng.standard_normal(h).astype(np.float32)
    (jx, tx), (jB, tB), (jC, tC) = (pair(a, dtype) for a in (xh, Bm, Cm))
    got = TS._ssd_chunked(tx, torch.from_numpy(dt), torch.from_numpy(A), tB,
                          tC, torch.from_numpy(D), 8)
    want = JS._ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                           jnp.asarray(D), 8)
    assert got.shape == (b, l, h, p)
    close(got, want, DTYPES[dtype][2])
    close(TS._ssd_final_state(tx, torch.from_numpy(dt), torch.from_numpy(A),
                              tB, tC, 8),
          JS._ssd_final_state(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, 8),
          DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_apply_and_states(dtype):
    dj, dt, jp, tp = _mamba()
    jx, tx = pair(randn(2, 21, 32, scale=0.5), dtype)
    tol = DTYPES[dtype][2]
    close(TS.mamba2_apply(tp, tx, dims=dt, chunk=8),
          JS.mamba2_apply(jp, jx, dims=dj, chunk=8), tol)
    tconv, tssm = TS.mamba2_states(tp, tx, dims=dt, chunk=8)
    jconv, jssm = JS.mamba2_states(jp, jx, dims=dj, chunk=8)
    close(tconv, jconv, tol)
    close(tssm, jssm, tol)


def test_mamba2_decode():
    """Ten recurrent steps from a float32 state: output, conv and ssm
    states agree at every step (float32 conv state, so no bf16 cast sets
    the floor)."""
    dj, dt, jp, tp = _mamba()
    conv = randn(2, 3, 80, seed=6)
    ssm = randn(2, 8, 8, 8, seed=7, scale=0.1)
    jc, tc = jnp.asarray(conv), torch.from_numpy(conv)
    js, ts = jnp.asarray(ssm), torch.from_numpy(ssm)
    for t in range(10):
        jx, tx = pair(randn(2, 1, 32, seed=20 + t), "float32")
        jy, jc, js = JS.mamba2_decode(jp, jx, jc, js, dims=dj)
        ty, tc, ts = TS.mamba2_decode(tp, tx, tc, ts, dims=dt)
        close(ty, jy, F32)
        close(tc, jc, F32)
        close(ts, js, F32)


def test_ssd_chunked_matches_the_recurrence():
    """The port's chunked SSD equals its own step-by-step decode (the
    reference's ``test_ssd_chunked_matches_naive_recurrence``)."""
    _, dt, _, tp = _mamba()
    x = torch.from_numpy(randn(2, 16, 32, scale=0.5))
    y_par = TS.mamba2_apply(tp, x, dims=dt, chunk=4)
    conv = torch.zeros(2, 3, 80)
    ssm = torch.zeros(2, dt.n_heads, 8, 8)
    ys = []
    for t in range(16):
        y, conv, ssm = TS.mamba2_decode(tp, x[:, t:t + 1], conv, ssm, dims=dt)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(),
                               rtol=2e-3, atol=2e-3)
