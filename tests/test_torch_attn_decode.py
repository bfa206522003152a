"""The decode-attention kernel's module (``repro_torch.kernels.attn_decode``).

On the CPU: the wrapper's plain version equals the decode step's attention
core as it was before the kernel (kept here verbatim), bit for bit, over
head dims, query heads a kv head, windows and ring positions; the run of
positions the kernel reads (``visible``) is exactly the mask's; the input
check, the split rule and the lazy build.

On a card (``cuda`` marker, skipped without one): the kernel against the
plain version at the deepseek-7b decode cell's shape, at gemma3's sliding
window past a wrap, on a split, and over every head dim and type, within
``kernel.tolerance``: float32 queries differ only in the order of their
sums (1e-5); bfloat16 queries one bfloat16 step of the output (rtol 2^-7)
and 2^-10 max|want| for the probabilities that round the other way.  On
the CPU, the bfloat16 tolerance takes a float64 evaluation with the same
rounding points and refuses each planted fault (a position dropped, the
logits rounded to bfloat16).
"""

import numpy as np
import pytest
import torch

import repro_torch.models.layers as TL
from repro_torch.kernels import attn_decode as ad
from repro_torch.kernels.attn_decode import kernel as adk

torch.set_num_threads(1)


def previous_core(q, ck, cv, pos, window):
    """``layers.attention_decode``'s ``core`` before the kernel, verbatim
    (x's dtype is q's, as ``project`` makes it)."""
    B, S, hd = ck.shape[0], ck.shape[1], q.shape[-1]
    k_pos = ad.slot_positions(S, pos, q.device)[None].expand(B, S)
    logits = TL._logits(q, ck.to(q.dtype), hd ** -0.5)
    valid = (k_pos <= pos) & (k_pos >= 0)
    if window is not None:
        valid &= k_pos > pos - window
    logits = torch.where(valid[:, None, None, None], logits, TL.NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, cv.to(q.dtype))


def inputs(B, S, KH, G, hd, q_dtype, cache_dtype, seed=0, device="cpu"):
    rng = np.random.RandomState(seed)

    def t(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype).to(device)
    return (t(B, 1, KH, G, hd, dtype=q_dtype),
            t(B, S, KH, hd, dtype=cache_dtype),
            t(B, S, KH, hd, dtype=cache_dtype))


S_RING = 8
#: before the first wrap, the ring just full, its first wrapped write, and
#: well past it
POSITIONS = (S_RING - 3, S_RING - 1, S_RING, 2 * S_RING + 3)


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32],
                         ids=["q_bf16", "q_f32"])
@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("window", [None, 5], ids=["full", "window5"])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
def test_plain_version_is_the_previous_core(hd, G, window, pos, q_dtype):
    q, ck, cv = inputs(2, S_RING, 2, G, hd, q_dtype, torch.bfloat16,
                       seed=hd + G + pos)
    want = previous_core(q, ck, cv, pos, window)
    got = ad.attn_decode(q, ck, cv, pos, window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, want)
    assert torch.equal(ad.attn_decode_plain(q, ck, cv, pos, window), want)


@pytest.mark.parametrize("window", [None, 1, 3, 8, 20])
@pytest.mark.parametrize("S", [1, 5, 8])
def test_the_run_the_kernel_reads_is_the_mask(S, window):
    """``visible``'s positions, at the kernel's slots ``(lo % S + j)``
    wrapped once, are exactly the slots the plain version's mask keeps."""
    for pos in range(0, 3 * S + 2):
        k_pos = ad.slot_positions(S, pos, "cpu")
        valid = (k_pos <= pos) & (k_pos >= 0)
        if window is not None:
            valid &= k_pos > pos - window
        lo, n = adk.visible(S, pos, window)
        slots = [(lo % S + j) - (S if lo % S + j >= S else 0)
                 for j in range(n)]
        assert sorted(slots) == torch.nonzero(valid).flatten().tolist()
        assert [int(k_pos[s]) for s in slots] == list(range(lo, pos + 1))


def test_a_cpu_call_builds_and_launches_nothing():
    before = dict(adk.launch_counts)
    q, ck, cv = inputs(1, 4, 1, 1, 24, torch.float64, torch.float16)
    ad.attn_decode(q, ck, cv, 3)    # the plain version takes any type
    assert adk.launch_counts == before
    assert not adk._libs or torch.cuda.is_available()


def _bad(case):
    q, ck, cv = inputs(2, 8, 2, 2, 64, torch.bfloat16, torch.bfloat16)
    if case == "hd48":
        q, ck, cv = inputs(2, 8, 2, 2, 48, torch.bfloat16, torch.bfloat16)
    elif case == "q_float16":
        q = q.half()
    elif case == "cache_float64":
        ck, cv = ck.double(), cv.double()
    elif case == "k_v_types":
        cv = cv.float()
    elif case == "cache_strided":
        ck = ck.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "cache_sliced":
        ck = torch.cat([ck, ck], -1)[..., :64]
    elif case == "G16":
        q, ck, cv = inputs(2, 8, 2, 16, 64, torch.bfloat16, torch.bfloat16)
    elif case == "query_length2":
        q = torch.cat([q, q], 1)
    elif case == "cache_heads":
        ck, cv = ck[:, :, :1].contiguous(), cv[:, :, :1].contiguous()
    return q, ck, cv


@pytest.mark.parametrize("case", [
    "hd48", "q_float16", "cache_float64", "k_v_types", "cache_strided",
    "cache_sliced", "G16", "query_length2", "cache_heads"])
def test_the_input_check_refuses_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        adk.check_inputs(*_bad(case))


@pytest.mark.parametrize("hd", adk.HEAD_DIMS)
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_the_input_check_takes_every_built_shape(hd, cache_dtype):
    for q_dtype in adk.QUERY_TYPES:
        adk.check_inputs(*inputs(2, 8, 2, 6, hd, q_dtype, cache_dtype))


@pytest.mark.parametrize("B,KH,G,n,want", [
    (32, 32, 1, 2304, 1),       # the deepseek-7b decode cell: 1 024 blocks
    (32, 32, 1, 8192, 1),       # 32 KB of logits: one block still
    (32, 32, 1, 8193, 2),       # one position more: split for the memory
    (32, 8, 8, 32768, 32),      # G 8 at 32k: 1 024 positions a split
    (4, 8, 4, 2304, 9),         # 32 blocks: 9 splits of 256 fill the card
    (2, 2, 2, 2304, 36),        # 4 blocks: splits of 64 positions
    (2, 2, 2, 100, 2),          # a short cache: no split under 64
    (1, 1, 1, 1, 1),
])
def test_splits_adapt_to_the_shape(B, KH, G, n, want):
    got = adk.splits(B * KH, G, n, 132)
    assert got == want
    chunk = -(-n // got)
    assert G * chunk * 4 <= adk.LOGIT_BYTES
    assert (got - 1) * chunk < n           # no split left empty


def test_build_is_lazy_and_names_the_source():
    src = adk.SOURCE.read_text()
    assert adk.SOURCE.suffix == ".cu" and 'extern "C" int attn_decode' in src
    for name in ("attn_decode_kernel", "attn_decode_qk_kernel",
                 "attn_decode_pv_kernel", "cudaGetLastError"):
        assert name in src
    flags = " ".join(adk.variant_flags(128, torch.bfloat16, 1))
    assert "sm_90a" in flags and "-DAD_HD=128" in flags
    assert "-DAD_KT=1" in flags and "-DAD_GM=1" in flags
    assert "fast_math" not in flags
    assert set(adk.launch_counts) == {"attn_decode", "attn_decode_qk",
                                      "attn_decode_pv"}


def evaluate(q, ck, cv, pos, window, fault=None):
    """The core in float64 over the visible rows, rounded where the plain
    version rounds (K and V to q's type, the probabilities, the output);
    ``fault`` plants one error: ``drop`` leaves out the first visible
    position, ``logits_bf16`` rounds the logits to bfloat16."""
    S, hd = ck.shape[1], q.shape[-1]
    lo, _ = adk.visible(S, pos, window)
    slots = [p % S for p in range(lo + (fault == "drop"), pos + 1)]
    k, v = (c[:, slots].to(q.dtype).double() for c in (ck, cv))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.double(), k) * hd ** -0.5
    if fault == "logits_bf16":
        logits = logits.bfloat16().double()
    probs = torch.softmax(logits, dim=-1).to(q.dtype).double()
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v).to(q.dtype)


def atol_needed(got, want) -> float:
    """The atol, over max|want|, that ``got`` needs beside rtol 2^-7."""
    d = (got.float() - want.float()).abs() - 2 ** -7 * want.float().abs()
    return float(d.max()) / float(want.float().abs().max())


#: (B, S, KH, G, hd, pos, window): the card tests' kinds of shape, small
TOLERANCE_CASES = {
    "cell_B4": (4, 2304, 32, 1, 128, 2303, None),
    "gemma3_window": (2, 1024, 4, 2, 256, 3000, 1024),
    "split_B2_KH2": (2, 2304, 2, 4, 128, 2303, None),
    "short_hd16_G2": (3, 400, 2, 2, 16, 300, None),
    "window9": (40, 400, 4, 1, 128, 900, 9),
}
FAULTS = ("drop", "logits_bf16")


@pytest.mark.parametrize("case", list(TOLERANCE_CASES))
def test_the_bf16_tolerance_parts_right_from_wrong(case):
    """``tolerance`` takes a float64 evaluation with the plain version's
    rounding points, at half its atol or less, and refuses each planted
    fault, each at twice its atol or more."""
    B, S, KH, G, hd, pos, window = TOLERANCE_CASES[case]
    q, ck, cv = inputs(B, S, KH, G, hd, torch.bfloat16, torch.bfloat16,
                       seed=1)
    want = ad.attn_decode_plain(q, ck, cv, pos, window)
    tol = adk.tolerance(want)
    assert tol["rtol"] == 2 ** -7
    right = evaluate(q, ck, cv, pos, window)
    torch.testing.assert_close(right.float(), want.float(), **tol)
    assert atol_needed(right, want) <= 2 ** -11
    for fault in FAULTS:
        wrong = evaluate(q, ck, cv, pos, window, fault)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(wrong.float(), want.float(), **tol)
        assert atol_needed(wrong, want) >= 2 ** -9, fault


@pytest.mark.parametrize("hd", [128, 224])
def test_the_default_scale_is_hd_to_the_minus_half(hd):
    """No ``scale`` is hd^-0.5 bit for bit (the deepseek-7b cell's launch
    is unchanged); Zamba2's (hd / 2)^-0.5 reaches the logits."""
    q, ck, cv = inputs(2, S_RING, 2, 1, hd, torch.bfloat16, torch.bfloat16)
    pos = S_RING + 2
    want = previous_core(q, ck, cv, pos, None)
    assert torch.equal(ad.attn_decode_plain(q, ck, cv, pos), want)
    assert torch.equal(ad.attn_decode(q, ck, cv, pos, None, hd ** -0.5),
                       want)
    half = ad.attn_decode(q, ck, cv, pos, None, (hd / 2) ** -0.5)
    assert torch.equal(half, ad.attn_decode_plain(q, ck, cv, pos, None,
                                                  (hd / 2) ** -0.5))
    assert not torch.equal(half, want)


# ------------------------------------------------------------------ on a GPU
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def close_to_plain(got, want):
    torch.testing.assert_close(got.float(), want.float(),
                               **adk.tolerance(want))


#: (B, S, KH, G, hd, pos, window, one pass): the cell's shape at its first
#: and last position, gemma3's sliding window past a wrap, and splits
CARD_CASES = {
    "cell_first": (32, 2304, 32, 1, 128, 2048, None, True),
    "cell_last": (32, 2304, 32, 1, 128, 2303, None, True),
    "gemma3_window": (8, 1024, 4, 2, 256, 3000, 1024, False),
    "split_B2_KH2": (2, 2304, 2, 4, 128, 2303, None, False),
    "split_internvl2": (4, 2304, 8, 6, 128, 1500, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_cuda_kernel_matches_plain(cuda_device, case):
    B, S, KH, G, hd, pos, window, one_pass = CARD_CASES[case]
    q, ck, cv = inputs(B, S, KH, G, hd, torch.bfloat16, torch.bfloat16,
                       seed=1, device=cuda_device)
    want = ad.attn_decode_plain(q, ck, cv, pos, window)
    adk.reset_launch_counts()
    for i in range(2):
        got = ad.attn_decode(q, ck, cv, pos, window)
        torch.cuda.synchronize()
        n = i + 1
        assert adk.launch_counts == (
            {"attn_decode": n, "attn_decode_qk": 0, "attn_decode_pv": 0}
            if one_pass else
            {"attn_decode": 0, "attn_decode_qk": n, "attn_decode_pv": n})
    close_to_plain(got, want)
    # the same inputs give the same bits (the splits add in a fixed order)
    assert torch.equal(got, ad.attn_decode(q, ck, cv, pos, window))


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["bf16_bf16", "f32_bf16", "f32_f32",
                                   "bf16_f32"])
@pytest.mark.parametrize("hd", adk.HEAD_DIMS)
def test_cuda_kernel_every_head_dim_and_type(cuda_device, hd, types):
    q_dtype, cache_dtype = (torch.bfloat16 if t == "bf16" else torch.float32
                            for t in types.split("_"))
    # a split of 5 (6 blocks), and one pass past two wraps in a window
    for B, KH, G, pos, window in ((3, 2, 2, 300, None), (40, 4, 1, 900, 9)):
        q, ck, cv = inputs(B, 400, KH, G, hd, q_dtype, cache_dtype, seed=hd,
                           device=cuda_device)
        got = ad.attn_decode(q, ck, cv, pos, window)
        want = ad.attn_decode_plain(q, ck, cv, pos, window)
        assert got.dtype == q_dtype
        close_to_plain(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [1024, 1279])
def test_cuda_kernel_zamba2_cell(cuda_device, pos):
    """The hd-224 variant at the Zamba2 decode cell's shape (B 16, S 1280,
    KH 32, G 1) with its scale (224 / 2)^-0.5, in one pass."""
    q, ck, cv = inputs(16, 1280, 32, 1, 224, torch.bfloat16, torch.bfloat16,
                       seed=2, device=cuda_device)
    scale = 112 ** -0.5
    adk.reset_launch_counts()
    got = ad.attn_decode(q, ck, cv, pos, None, scale)
    torch.cuda.synchronize()
    assert adk.launch_counts["attn_decode"] == 1
    close_to_plain(got, ad.attn_decode_plain(q, ck, cv, pos, None, scale))
