"""Shared support for the tests of the PyTorch port (``repro_torch``).

* ``all_opcodes_context(kind)`` — one hand-built context that uses all 18
  opcodes, as host arrays.
* ``swap_context``, ``chain_context``, ``dense_context``,
  ``identity_context`` — contexts that exercise the kernels' sparse
  schedule (``SPECIAL_CONTEXTS`` names them with the all-opcodes one):
  rows read and written within one stage, a row read right after it is
  written, every slot active, no slot active.
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

``chip_smoke.py`` keeps a copy of the contexts and of ``special_lanes``
(it may import nothing from ``tests/``).
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


def _identity(s_max: int):
    op = np.full((s_max, RF), BYP, np.int32)
    a = np.tile(np.arange(RF, dtype=np.int32), (s_max, 1))
    return op, a, a.copy(), np.zeros((s_max, RF), np.float64)


def _ctx(op, a, b, imm) -> dict:
    return {"op": op, "src_a": a, "src_b": b, "imm": imm}


def identity_context(kind: str, s_max: int = 16) -> dict:
    """Every slot passes its own row on (BYP, and OUT in the last stage)."""
    op, a, b, imm = _identity(s_max)
    op[-1, 1::2] = OUT
    return _ctx(op, a, b, imm)


def swap_context(kind: str, s_max: int = 16) -> dict:
    """Stage 0 swaps rows 3 and 7 (slot 3 reads 7, slot 7 reads 3) and, in
    the same stage, computes rows 5 and 9 from each other."""
    op, a, b, imm = _identity(s_max)
    op[0, 3], a[0, 3] = BYP, 7
    op[0, 7], a[0, 7] = OUT, 3
    op[0, 5], a[0, 5], b[0, 5] = ADD, 9, 5
    op[0, 9], a[0, 9], b[0, 9] = SUB, 5, 9
    return _ctx(op, a, b, imm)


def chain_context(kind: str, s_max: int = 16) -> dict:
    """Stage s writes row 1 + s % 3 from the row stage s - 1 wrote (and from
    row 0): every read after stage 0 is of a row written just before."""
    imms = FLOAT_IMMS if kind == "float" else INT_IMMS
    op, a, b, imm = _identity(s_max)
    cycle = (ADDC, MUL, SUB, MULC, ADD, RSUBC)
    prev = 0
    for s in range(s_max):
        dst = 1 + s % 3
        op[s, dst], a[s, dst], b[s, dst] = cycle[s % len(cycle)], prev, 0
        imm[s, dst] = imms[s % len(imms)]
        prev = dst
    return _ctx(op, a, b, imm)


def dense_context(kind: str, s_max: int = 16, seed: int = 0) -> dict:
    """Every one of ``s_max x 32`` slots active: opcodes drawn over all 18,
    sources over all 32 rows, made from ``numpy.random.RandomState(seed)``;
    a BYP or OUT that drew its own row reads the next one instead."""
    rng = np.random.RandomState(seed)
    imms = FLOAT_IMMS if kind == "float" else INT_IMMS
    op = rng.randint(0, N_OPS, size=(s_max, RF)).astype(np.int32)
    a = rng.randint(0, RF, size=(s_max, RF)).astype(np.int32)
    b = rng.randint(0, RF, size=(s_max, RF)).astype(np.int32)
    slot = np.arange(RF)
    own = ((op == BYP) | (op == OUT)) & (a == slot)
    a[own] = (a[own] + 1) % RF
    imm = np.asarray(imms, np.float64)[rng.randint(0, len(imms),
                                                   size=(s_max, RF))]
    return _ctx(op, a, b, imm)


#: the hand-built contexts beside the nine benchmark kernels
SPECIAL_CONTEXTS = {"all_opcodes": all_opcodes_context,
                    "swap": swap_context, "chain": chain_context,
                    "dense": dense_context, "identity": identity_context}


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


# ------------------------------------------------------------ training
def float32_mode(monkeypatch) -> None:
    """``COMPUTE_DTYPE`` float32 in both packages' model modules."""
    import jax.numpy as jnp
    import torch
    import repro.models.layers as JL
    import repro.models.model as JM
    import repro_torch.models.layers as TL
    import repro_torch.models.model as TM
    for mod in (JL, JM):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (TL, TM):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)


def leaf_pairs(port_tree, jax_tree):
    """``(keystr path, port leaf, reference leaf)`` in the reference's
    order; asserts that both trees have the same paths."""
    import jax
    from repro_torch.models.blocks import tree_leaves_with_path
    jl = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    tl = tree_leaves_with_path(port_tree)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    return [(p, t, j) for (p, t), (_, j) in zip(tl, jl)]


def as_f32(x) -> np.ndarray:
    """A port tensor or a JAX array as float32 numpy (bf16 widened)."""
    import torch
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def leaf_rel(got, want) -> float:
    """max |got - want| over max |want| of the leaf (1 where want is 0)."""
    got, want = as_f32(got).astype(np.float64), as_f32(want).astype(np.float64)
    scale = np.abs(want).max() if want.size else 0.0
    return float(np.abs(got - want).max(initial=0.0) / (scale or 1.0))


def assert_trees_bitwise(a, b, what: str = "") -> None:
    """Two port trees: the same paths, every leaf the same dtype, shape
    and bits."""
    from repro_torch.models.blocks import tree_leaves_with_path
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, (what, p, x.dtype, y.dtype)
        np.testing.assert_array_equal(bits(torch_bits(x)), bits(torch_bits(y)),
                                      err_msg=f"{what}{p}")
