"""Shared support for the tests of the PyTorch port (``repro_torch``).

* ``all_opcodes_context(kind)`` — one hand-built context that uses all 18
  opcodes, as host arrays.
* ``special_lanes(kind, n_lanes)`` — a ``[32, n_lanes]`` register-file
  image whose lanes carry every ordered pair of the special values
  (+-0, +-inf, NaN, large magnitudes; for int32: INT_MIN, INT_MAX, values
  whose products wrap).
* ``bits(a)`` / ``assert_same_bits(got, want)`` — bit-pattern comparison,
  NaN by position.

The context is laid out so that a bit-for-bit comparison between two
implementations is meaningful:

* AND / OR / XOR appear only in stage 0, where they read the inputs
  themselves.  Their results (which may be denormal bit patterns, or a
  non-NaN made out of a NaN) are only forwarded afterwards (BYP / OUT),
  never fed to arithmetic — an implementation that flushes denormals in
  arithmetic, or gives another NaN payload, still agrees.
* No arithmetic on the chosen values yields a denormal.

``chip_smoke.py`` keeps a copy of ``all_opcodes_context`` and
``special_lanes`` (it may import nothing from ``tests/``).
"""

from __future__ import annotations

import numpy as np

RF = 32
N_OPS = 18
(BYP, ADD, SUB, MUL, ADDC, SUBC, RSUBC, MULC, SQR, MAX, MIN, ABS, NEG,
 AND, OR, XOR, OUT, NOP) = range(N_OPS)
_BITWISE = (AND, OR, XOR)

FLOAT_SPECIALS = (0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 3e38, -3e38,
                  2.5, -7.25, 0.5)
INT_SPECIALS = (0, -1, 1, -2**31, 2**31 - 1, 46341, -46341, 65536, 12345,
                -7, 2, -2**30)
FLOAT_IMMS = (0.5, -1.25, 3.0, -0.0, 2.0)
INT_IMMS = (3, -5, 7, 0, 65537)


def all_opcodes_context(kind: str, s_max: int = 16) -> dict:
    """Host arrays ``op, src_a, src_b`` (int32) and ``imm`` (float64), each
    ``[s_max, 32]``, for ``kind`` in ``{"float", "int"}``; ``out_idx`` is all
    32 rows.  Stages beyond the third are identity (BYP slot i <- rf[i])."""
    imms = FLOAT_IMMS if kind == "float" else INT_IMMS
    op = np.full((s_max, RF), BYP, np.int32)
    a = np.tile(np.arange(RF, dtype=np.int32), (s_max, 1))
    b = a.copy()
    imm = np.zeros((s_max, RF), np.float64)
    # stage 0: every opcode once on (even row, odd row), then the ordered
    # ops again with the operands swapped
    tail = (MAX, MIN, MAX, MIN, SUB, MUL, ADD, RSUBC, ABS, NEG, SQR, MULC,
            SUBC, ADDC)
    for i in range(RF):
        if i < N_OPS:
            op[0, i], a[0, i], b[0, i] = i, 2 * (i % 8), 2 * (i % 8) + 1
        else:
            k = i - N_OPS
            op[0, i], a[0, i], b[0, i] = tail[k], 2 * (k % 8) + 1, 2 * (k % 8)
        imm[0, i] = imms[i % len(imms)]
    # stage 1: arithmetic over stage 0's arithmetic results; bitwise results
    # are forwarded only
    arith = [i for i in range(RF) if op[0, i] not in _BITWISE]
    cycle = (ADD, SUB, MUL, MAX, MIN, ABS, NEG, ADDC, MULC, RSUBC, SUBC, SQR)
    for n, i in enumerate(arith):
        op[1, i] = cycle[n % len(cycle)]
        a[1, i] = i
        b[1, i] = arith[(n + 5) % len(arith)]
        imm[1, i] = imms[(i + 2) % len(imms)]
    # stage 2: stream out (OUT on even slots, BYP on odd), one NOP
    op[2, 0::2] = OUT
    op[2, 31] = NOP
    return {"op": op, "src_a": a, "src_b": b, "imm": imm,
            "out_idx": np.arange(RF, dtype=np.int32),
            "n_inputs": RF, "n_outputs": RF, "context_bytes": 0}


def special_lanes(kind: str, n_lanes: int = 256, seed: int = 0) -> np.ndarray:
    """``[32, n_lanes]`` float32 or int32 image: in lane ``l`` every even
    row holds special ``l % n`` and every odd row special ``(l // n) % n``
    (so 144 lanes cover all ordered pairs); lanes beyond the pairs are
    random."""
    specials = FLOAT_SPECIALS if kind == "float" else INT_SPECIALS
    dtype = np.float32 if kind == "float" else np.int32
    n = len(specials)
    vals = np.asarray(specials, dtype=np.float64 if kind == "float"
                      else np.int64).astype(dtype)
    lanes = np.arange(n_lanes)
    x = np.empty((RF, n_lanes), dtype)
    x[0::2] = vals[lanes % n]
    x[1::2] = vals[(lanes // n) % n]
    rng = np.random.RandomState(seed)
    extra = n_lanes - n * n
    if extra > 0:
        if kind == "float":
            x[:, n * n:] = rng.uniform(-4, 4, (RF, extra)).astype(dtype)
        else:
            x[:, n * n:] = rng.randint(-2**31, 2**31 - 1, (RF, extra),
                                       dtype=np.int64).astype(dtype)
    return x


def bits(a) -> np.ndarray:
    """The bit patterns of a float32 / int32 (4-byte) or 2-byte array."""
    a = np.ascontiguousarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def assert_same_bits(got, want, what: str = "") -> None:
    """Equal bit patterns, except that NaN need only match NaN by position."""
    got, want = np.ascontiguousarray(got), np.ascontiguousarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind == "f":
        gn, wn = np.isnan(got), np.isnan(want)
        np.testing.assert_array_equal(gn, wn, err_msg=f"{what}: NaN positions")
        keep = ~gn
        np.testing.assert_array_equal(bits(got)[keep], bits(want)[keep],
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


# ------------------------------------------------- the same data, both sides
DTYPE_NAMES = ("float32", "bfloat16", "int32")


def dtype_pair(name: str):
    """``(jax dtype, torch dtype)`` for one of ``DTYPE_NAMES``."""
    import jax.numpy as jnp
    import torch
    return {"float32": (jnp.float32, torch.float32),
            "bfloat16": (jnp.bfloat16, torch.bfloat16),
            "int32": (jnp.int32, torch.int32)}[name]


def both(arr: np.ndarray, name: str):
    """One numpy array (float32 or int32) as ``(jax array, CPU tensor)`` of
    dtype ``name`` holding IDENTICAL bits.  For bfloat16 the rounding is
    done once (by torch) and JAX is handed the 16-bit patterns: the two
    frameworks convert a float32 NaN to different bfloat16 NaN patterns,
    which AND / OR / XOR would turn into different numbers."""
    import jax
    import jax.numpy as jnp
    import torch
    jd, td = dtype_pair(name)
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(td)
    if name == "bfloat16":
        pat = t.view(torch.int16).numpy()
        return jax.lax.bitcast_convert_type(jnp.asarray(pat), jd), t
    return jnp.asarray(arr, jd), t


def jax_bits(a) -> np.ndarray:
    """A JAX array as numpy, bfloat16 as its int16 patterns."""
    import jax
    import jax.numpy as jnp
    if a.dtype == jnp.bfloat16:
        return np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16))
    return np.asarray(a)


def torch_bits(t) -> np.ndarray:
    """A tensor as numpy, bfloat16 as its int16 patterns."""
    import torch
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def assert_same_result(t, j, what: str = "") -> None:
    """A port tensor against a JAX array: equal bits, NaN by position."""
    import torch
    got, want = torch_bits(t), jax_bits(j)
    if t.dtype == torch.bfloat16:
        gn = torch.isnan(t).cpu().numpy()
        wn = np.isnan(np.asarray(j).astype(np.float32))
        np.testing.assert_array_equal(gn, wn, err_msg=f"{what}: NaN positions")
        np.testing.assert_array_equal(got[~gn], want[~gn], err_msg=what)
    else:
        assert_same_bits(got, want, what)


def random_inputs(n_inputs: int, batch: int, name: str, seed: int):
    """The kernels' usual test inputs: uniform(-2, 2) floats, or ints in
    [-6, 6] for int32 — as a list of numpy arrays (float32 / int32)."""
    rng = np.random.RandomState(seed)
    if name == "int32":
        return [rng.randint(-6, 7, size=(batch,)).astype(np.int32)
                for _ in range(n_inputs)]
    return [rng.uniform(-2, 2, (batch,)).astype(np.float32)
            for _ in range(n_inputs)]
