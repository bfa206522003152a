"""Decode attention straight from the KV cache: the CUDA launch wrapper and
its plain version.

One decode token's attention over a ring cache: q [B, 1, KH, G, hd] in the
activations' type, cache_k / cache_v [B, S, KH, hd] in the cache's type,
the write position ``pos`` and an optional sliding ``window``.  Position
``p`` lies in slot ``p % S`` (``slot_positions``); the positions a query at
``pos`` sees are one run, ``[lo, pos]`` (``visible``).

The plain version, ``attn_decode_plain``, is the decode step's attention
core as the port first wrote it: float32 logits from the upcast q and K, a
mask from ``slot_positions``, a float32 softmax whose probabilities are
rounded to q's type, and their product with V.  ``attn_decode`` takes it
only for a tensor that lies on the CPU; for a CUDA tensor it launches the
kernel of ``csrc/attn_decode.cu`` or raises.  The kernel replaces no TPU
kernel (the reference computes this in plain ``jnp``); it is bound by the
bytes of the cache and reads each visible row once, in its stored type
(the source carries the design notes).

Each (head dim, cache type, G bucket) is its own small library, compiled
with ``nvcc`` at its first use and loaded with ``ctypes``; nothing is built
when this module is imported.  ``launch_counts`` counts kernel launches,
and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _nvcc

#: head dims the kernel is built for: those of the repo's configs and
#: their smoke configs
HEAD_DIMS = (16, 32, 64, 112, 128, 224, 256)
#: cache types the kernel reads, with the ``-DAD_KT`` code
CACHE_TYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query types (also the type of the probabilities and of the output)
QUERY_TYPES = (torch.float32, torch.bfloat16)
#: query heads a kv head: the kernel's register arrays are built for the
#: next of these at or above G
G_BUCKETS = (1, 2, 4, 8)
#: a block keeps its logits in this much dynamic shared memory (with at
#: most 16 KB of static, under the 48 KB a block has without opting in)
LOGIT_BYTES = 32 << 10
#: the fewest positions a split takes when splitting to fill the card
MIN_SPLIT_POSITIONS = 64

#: kernel launches since import (or ``reset_launch_counts``): the one-pass
#: kernel, and the two passes of a split
launch_counts = {"attn_decode": 0, "attn_decode_qk": 0, "attn_decode_pv": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# -------------------------------------------------------------- ring rule
def slot_positions(S: int, pos: int, device) -> torch.Tensor:
    """Absolute position held by each slot of a ring cache of ``S`` slots
    once position ``pos`` has been written at slot ``pos % S`` (slots not
    written yet come out negative)."""
    write_at, wraps = pos % S, pos // S
    slot = torch.arange(S, device=device)
    return torch.where(slot <= write_at, wraps * S + slot,
                       (wraps - 1) * S + slot)


def visible(S: int, pos: int, window) -> tuple[int, int]:
    """``(lo, n)``: the positions ``lo .. lo + n - 1 = pos`` that a query
    at ``pos`` sees in a ring cache of ``S`` slots — those
    ``slot_positions`` puts in the cache, at least 0, and inside the
    ``window`` where one is set."""
    lo = max(0, pos - S + 1)
    if window is not None:
        lo = max(lo, pos - window + 1)
    return lo, pos - lo + 1


# ------------------------------------------------------------------ plain
def attn_decode_plain(q, cache_k, cache_v, pos: int, window=None,
                      scale=None):
    """The attention core on plain tensors: out [B, 1, KH, G, hd] in q's
    type; ``scale`` of the logits, default hd^-0.5."""
    B, S, hd = q.shape[0], cache_k.shape[1], q.shape[-1]
    k_pos = slot_positions(S, pos, q.device)[None].expand(B, S)
    k = cache_k.to(q.dtype)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) \
        * (hd ** -0.5 if scale is None else scale)
    valid = (k_pos <= pos) & (k_pos >= 0)
    if window is not None:
        valid &= k_pos > pos - window
    # -1e30: models.layers.NEG_INF, the value of a masked logit
    logits = torch.where(valid[:, None, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, cache_v.to(q.dtype))


def tolerance(want) -> dict:
    """``torch.testing.assert_close``'s ``rtol`` and ``atol`` that the
    kernel's output keeps to against ``want``, ``attn_decode_plain``'s.

    float32 q: the two differ only in the order of their float32 sums
    (1e-5).  bfloat16 q: each side rounds a float32 result to bfloat16
    once, so two results that differ by little before rounding land at
    most one bfloat16 step apart (rtol 2^-7).  Before that rounding they
    differ where a probability falls on the other side of a bfloat16
    rounding point: 2^-8 of that probability on its row of V, a few times
    a row.  atol is 2^-10 max|want|, between readings of float32 and
    float64 evaluations at the decode cell's shape (B 32, S 2304, KH 32,
    hd 128, four seeds) and of ``tests/test_torch_attn_decode.py``'s
    ``test_the_bf16_tolerance_parts_right_from_wrong``: a correct
    evaluation in another order needs at most 3.3e-4 max|want| (the
    kernel on an H100 1.5e-4); the logits rounded to bfloat16 need 2.6e-3
    or more, one position dropped 1.9e-2.  (The probabilities left
    unrounded need 9e-4 to 1.8e-3, as much as one large probability
    rounded the other way: no tolerance parts them.)"""
    if want.dtype == torch.float32:
        return dict(rtol=1e-5, atol=1e-5)
    return dict(rtol=2 ** -7, atol=2 ** -10 * float(want.float().abs().max()))


# ------------------------------------------------------------------ build
SOURCE = Path(__file__).resolve().parent / "csrc" / "attn_decode.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_libs: dict = {}
_lib_lock = threading.Lock()


def variant_flags(hd: int, cache_dtype, gm: int) -> tuple:
    return NVCC_FLAGS + (f"-DAD_HD={hd}", f"-DAD_KT={CACHE_TYPES[cache_dtype]}",
                         f"-DAD_GM={gm}")


def build_library(hd: int, cache_dtype, gm: int,
                  verbose: bool = False) -> Path:
    """Compile the variant of ``csrc/attn_decode.cu`` for head dim ``hd``,
    cache type ``cache_dtype`` and ``gm`` query heads a kv head, unless an
    up-to-date library exists."""
    return _nvcc.build(SOURCE, variant_flags(hd, cache_dtype, gm),
                       "attn_decode", _nvcc.build_dir(SOURCE.parent.parent),
                       "the decode-attention kernel", verbose)


def load_library(hd: int, cache_dtype, gm: int, verbose: bool = False):
    """Build (if needed) and load a variant; cached per process."""
    key = (hd, cache_dtype, gm)
    with _lib_lock:
        if key not in _libs:
            lib = ctypes.CDLL(str(build_library(hd, cache_dtype, gm,
                                                verbose)))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.attn_decode.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                        i, i, ctypes.c_float, p]
            lib.attn_decode.restype = i
            _libs[key] = lib
    return _libs[key]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def splits(blocks: int, G: int, n: int, sms: int) -> int:
    """Blocks the ``n`` visible positions of a (row, kv head) are split
    over: as many as a block's logits need to fit its shared memory, and
    where ``blocks`` (B x KH) cannot fill the ``sms`` multiprocessors,
    enough to give the card two blocks an SM, with at least
    ``MIN_SPLIT_POSITIONS`` positions each."""
    cap = LOGIT_BYTES // (4 * G)
    need = -(-n // cap)
    if blocks < sms:
        need = max(need, min(-(-2 * sms // blocks),
                             -(-n // MIN_SPLIT_POSITIONS)))
    chunk = -(-n // need)
    return -(-n // chunk)            # no split left empty


# ----------------------------------------------------------------- checks
def check_inputs(q, cache_k, cache_v) -> None:
    """What the kernel takes, checked before a launch (raises on anything
    else): q [B, 1, KH, G, hd] float32 or bfloat16 with G at most 8;
    caches [B, S, KH, hd] alike, float32 or bfloat16, contiguous, on q's
    device, 16-byte aligned; hd one of ``HEAD_DIMS``."""
    if q.dim() != 5 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, KH, G, hd], got {tuple(q.shape)}")
    B, _, KH, G, hd = q.shape
    if q.dtype not in QUERY_TYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one the kernel is built for "
                         f"{HEAD_DIMS}")
    if G > G_BUCKETS[-1]:
        raise ValueError(f"{G} query heads a kv head; the kernel takes at "
                         f"most {G_BUCKETS[-1]}")
    for name, c in (("cache_k", cache_k), ("cache_v", cache_v)):
        if c.dtype not in CACHE_TYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, "
                            f"got {c.dtype}")
        if c.dim() != 4 or (c.shape[0], c.shape[2], c.shape[3]) != (B, KH, hd):
            raise ValueError(f"{name} must be [B={B}, S, KH={KH}, hd={hd}], "
                             f"got {tuple(c.shape)}")
        if not c.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if c.device != q.device:
            raise ValueError(f"{name} lies on {c.device}, q on {q.device}")
        if c.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if cache_v.dtype != cache_k.dtype or cache_v.shape != cache_k.shape:
        raise ValueError("cache_k and cache_v must have one type and shape")


# ---------------------------------------------------------------- wrapper
def attn_decode(q, cache_k, cache_v, pos: int, window=None, scale=None):
    """One decode token's attention: q [B, 1, KH, G, hd] at position
    ``pos`` over the ring caches [B, S, KH, hd] (``pos`` already written),
    the logits times ``scale`` (default hd^-0.5); returns [B, 1, KH, G,
    hd] in q's type.  A CUDA tensor goes through the kernel, or raises; a
    CPU tensor through ``attn_decode_plain``."""
    if not q.is_cuda:
        return attn_decode_plain(q, cache_k, cache_v, pos, window, scale)
    check_inputs(q, cache_k, cache_v)
    q = q.contiguous()
    B, _, KH, G, hd = q.shape
    S = cache_k.shape[1]
    lo, n = visible(S, pos, window)
    n_split = splits(B * KH, G, n, _sm_count(q.device))
    gm = next(b for b in G_BUCKETS if b >= G)
    lib = load_library(hd, cache_k.dtype, gm)
    out = torch.empty_like(q)
    ws = tickets = None
    if n_split > 1:
        rows = B * KH * G
        ws = torch.empty(rows * (n + n_split * (2 + hd)), dtype=torch.float32,
                         device=q.device)
        tickets = torch.zeros(B * KH, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        status = lib.attn_decode(
            q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(), B, S, KH, G, lo,
            n, n_split, int(q.dtype == torch.bfloat16),
            hd ** -0.5 if scale is None else scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if status != 0:
        raise RuntimeError(f"attn_decode: launch failed with CUDA error "
                           f"{status}")
    if n_split > 1:
        launch_counts["attn_decode_qk"] += 1
        launch_counts["attn_decode_pv"] += 1
    else:
        launch_counts["attn_decode"] += 1
    return out
