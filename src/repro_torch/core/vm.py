"""Plain PyTorch overlay virtual machine.

Executes an encoded overlay ``Program`` (isa.py) with *instructions as
data*: a kernel change is a context switch — new int32 instruction words +
constant tables are written, no code is rebuilt.  This is the software
analogue of the paper's daisy-chained 40-bit context load (Section III-A)
vs. the vendor-tool / partial-reconfiguration flow.

Semantics mirror the hardware: a linear cascade of stages (the direct
FU->FU interconnect); within a stage the FU is time-multiplexed over its
instruction memory; the register file holds the words streamed from the
previous stage; results stream out in instruction order.

The datapath is vectorized over a batch of independent kernel iterations
(the lane equivalent of replicating pipelines, paper Fig. 4).

``vm_exec`` / ``vm_exec_multi`` here are the PLAIN executor: straight
tensor code, written to be read and to run the CPU tests, not for speed.
On a CUDA device the serving path goes through the hand-written kernel in
``repro_torch.kernels.tmfu`` instead; that kernel is held against this
module.

Number semantics are spelled out where PyTorch's defaults differ from the
reference executor's:

* MAX / MIN treat ``+0 > -0`` (``max(+0, -0) = max(-0, +0) = +0``,
  ``min`` gives ``-0`` both ways) and propagate NaN from either operand;
  ``torch.maximum`` lets the first operand win on signed zeros.
* AND / OR / XOR on a float tile act on its bit pattern.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import isa
from repro_torch.core.dfg import CONST_OPS, DFG, Op
from repro_torch.core.isa import IM_DEPTH, RF_DEPTH, Program

#: default maximum pipeline length: two cascaded 8-FU pipelines (paper V)
S_MAX = 16

#: the one table torch dtype <-> numpy HOST dtype.  numpy has no bfloat16:
#: a bfloat16 overlay keeps its host-side images (staging buffers, context
#: memos) in float32 — every bfloat16 value is exactly a float32 — and
#: casts on the device.
HOST_DTYPE = {
    torch.float32: np.dtype(np.float32),
    torch.bfloat16: np.dtype(np.float32),
    torch.int32: np.dtype(np.int32),
}
#: same-width integer type carrying a float tile's bit pattern
_BITS_DTYPE = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """numpy dtype of the host-side image of a ``dtype`` tile."""
    try:
        return HOST_DTYPE[dtype]
    except KeyError:
        raise TypeError(f"overlay tiles are float32, bfloat16 or int32, "
                        f"got {dtype}") from None


def tensor_dtype(np_dtype) -> torch.dtype:
    """The tile dtype whose host image has numpy dtype ``np_dtype``
    (float32 -> float32, int32 -> int32)."""
    np_dtype = np.dtype(np_dtype)
    for t in (torch.float32, torch.int32):
        if HOST_DTYPE[t] == np_dtype:
            return t
    raise TypeError(f"no overlay tile type has the host type {np_dtype}")


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means the CUDA device.

    Nothing falls back to the CPU on its own — a caller who wants the CPU
    (the tests do) says ``device="cpu"``.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the overlay runs on the GPU unless the "
                "caller passes device='cpu'")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_host(t: torch.Tensor) -> np.ndarray:
    """numpy image of a tensor (bfloat16 widens to float32, exactly)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


# ------------------------------------------------------------- op semantics
def _bitwise(fn, a, b):
    it = _BITS_DTYPE.get(a.dtype)
    if it is None:
        return fn(a, b)
    return fn(a.view(it), b.view(it)).view(a.dtype)


def _maximum(a, b):
    """MAX with +0 > -0 and NaN from either operand (see module note)."""
    it = _BITS_DTYPE.get(a.dtype)
    if it is None:
        return torch.maximum(a, b)
    r = torch.where(a > b, a, b)
    r = torch.where(a == b, (a.view(it) & b.view(it)).view(a.dtype), r)
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


def _minimum(a, b):
    """MIN with -0 < +0 and NaN from either operand (see module note)."""
    it = _BITS_DTYPE.get(a.dtype)
    if it is None:
        return torch.minimum(a, b)
    r = torch.where(a < b, a, b)
    r = torch.where(a == b, (a.view(it) | b.view(it)).view(a.dtype), r)
    return torch.where(torch.isnan(a) | torch.isnan(b), a + b, r)


#: Branch table indexed by Op — the no-decoder dispatch.
_BRANCHES = (
    lambda a, b, imm: a,                                    # BYP
    lambda a, b, imm: a + b,                                # ADD
    lambda a, b, imm: a - b,                                # SUB
    lambda a, b, imm: a * b,                                # MUL
    lambda a, b, imm: a + imm,                              # ADDC
    lambda a, b, imm: a - imm,                              # SUBC
    lambda a, b, imm: imm - a,                              # RSUBC
    lambda a, b, imm: a * imm,                              # MULC
    lambda a, b, imm: a * a,                                # SQR
    lambda a, b, imm: _maximum(a, b),                       # MAX
    lambda a, b, imm: _minimum(a, b),                       # MIN
    lambda a, b, imm: torch.abs(a),                         # ABS
    lambda a, b, imm: torch.neg(a),                         # NEG
    lambda a, b, imm: _bitwise(torch.bitwise_and, a, b),    # AND
    lambda a, b, imm: _bitwise(torch.bitwise_or, a, b),     # OR
    lambda a, b, imm: _bitwise(torch.bitwise_xor, a, b),    # XOR
    lambda a, b, imm: a,                                    # OUT
    lambda a, b, imm: torch.zeros_like(a),                  # NOP
)
assert len(_BRANCHES) == len(Op)


def apply_op(opc: int, va, vb, imm):
    """One instruction's result: ``OP[opc](va, vb, imm)``."""
    if not 0 <= int(opc) < len(_BRANCHES):
        raise ValueError(f"bad opcode {opc}")
    return _BRANCHES[int(opc)](va, vb, imm)


@dataclasses.dataclass(frozen=True)
class Context:
    """Overlay context image (the '40-bit word stream').

    The fields are tensors on the executing device; ``ContextBank`` also
    keeps host images of the same shape as numpy arrays (``imm`` then in
    ``host_dtype``).
    """

    op: torch.Tensor       # [S_MAX, IM_DEPTH] int32
    src_a: torch.Tensor    # [S_MAX, IM_DEPTH] int32
    src_b: torch.Tensor    # [S_MAX, IM_DEPTH] int32
    imm: torch.Tensor      # [S_MAX, IM_DEPTH] dtype (const table, pre-gathered)
    out_idx: torch.Tensor  # [n_outputs] int32 — RF slots of the primary outputs
    n_inputs: int
    n_outputs: int
    context_bytes: int

    def tree(self):
        return (self.op, self.src_a, self.src_b, self.imm)


def host_context(program: Program, s_max: int = S_MAX,
                 dtype: torch.dtype = torch.float32) -> Context:
    """Encode a Program into dense HOST arrays (numpy ``Context``).

    ``imm`` is rounded to ``dtype`` and stored in ``host_dtype(dtype)``.
    """
    S = len(program.images)
    if S > s_max:
        raise ValueError(f"{program.name}: {S} stages > s_max={s_max}")
    # identity padding: BYP slot i -> rf[i]; pads both unused instruction
    # slots inside live stages (beyond that stage's stream) and whole stages.
    op = np.full((s_max, IM_DEPTH), int(Op.BYP), np.int32)
    a_ = np.tile(np.arange(IM_DEPTH, dtype=np.int32), (s_max, 1))
    b_ = a_.copy()
    imm = np.zeros((s_max, IM_DEPTH), np.float64)
    for s, img in enumerate(program.images):
        for slot, w in enumerate(img.words):
            o, dest, sa, sb = isa.unpack_word(int(w))
            assert dest == slot
            op[s, slot] = int(o)
            a_[s, slot] = sa
            if o in CONST_OPS:
                imm[s, slot] = float(img.consts[sb])
                b_[s, slot] = sa
            else:
                b_[s, slot] = sb
    # one rounding, float64 -> dtype, then the exact widening to the host type
    imm_host = to_host(torch.from_numpy(imm).to(dtype)).astype(
        host_dtype(dtype), copy=False)
    return Context(op=op, src_a=a_, src_b=b_, imm=imm_host,
                   out_idx=_output_slots(program),
                   n_inputs=program.n_inputs, n_outputs=program.n_outputs,
                   context_bytes=program.context_bytes)


def context_from_numpy(fields: dict, device=None,
                       dtype: torch.dtype | None = None) -> Context:
    """Build a device ``Context`` from numpy arrays and plain values.

    ``fields`` holds ``op``, ``src_a``, ``src_b``, ``imm``, ``out_idx``
    (arrays) and ``n_inputs``, ``n_outputs``, ``context_bytes`` — e.g. the
    attributes of a context built by another implementation of this
    overlay.  ``dtype`` defaults to the tensor type of ``imm``'s numpy
    dtype; pass ``torch.bfloat16`` with a float32 ``imm`` for a bfloat16
    context.
    """
    device = resolve_device(device)
    imm = np.array(fields["imm"])            # a writable copy, as below
    if dtype is None:
        dtype = tensor_dtype(imm.dtype)
    imm = imm.astype(host_dtype(dtype), copy=False)

    def i32(name):
        return torch.from_numpy(np.array(fields[name], dtype=np.int32)).to(device)

    return Context(op=i32("op"), src_a=i32("src_a"), src_b=i32("src_b"),
                   imm=torch.from_numpy(imm).to(device).to(dtype),
                   out_idx=i32("out_idx"),
                   n_inputs=int(fields["n_inputs"]),
                   n_outputs=int(fields["n_outputs"]),
                   context_bytes=int(fields["context_bytes"]))


def make_context(program: Program, s_max: int = S_MAX,
                 dtype: torch.dtype = torch.float32, device=None) -> Context:
    """Encode a Program into dense executor tensors (context switch image)."""
    host = host_context(program, s_max, dtype)
    return context_from_numpy(dataclasses.asdict(host), device, dtype)


def _output_slots(program: Program) -> np.ndarray:
    # The Program does not carry value names; the schedule guarantees the
    # final stage's stream contains the outputs. We record output slots at
    # encode time via a side table attached by overlay.compile_program.
    slots = getattr(program, "_output_slots", None)
    if slots is None:
        # default: the last n_outputs instructions of the final stage
        n = len(program.images[-1].words)
        return np.arange(n - program.n_outputs, n, dtype=np.int32)
    return np.asarray(slots, dtype=np.int32)


# ---------------------------------------------------------------- executor
def run_stages(op, src_a, src_b, imm, rf):
    """All stages over a stack of tiles: the plain TMFU datapath.

    ``op/src_a/src_b/imm`` are ``[G, S, IM_DEPTH]`` — tile ``g``'s own
    instruction rows — and ``rf`` is ``[G, RF_DEPTH, T]``.  For each stage
    and slot ``i``: ``out[i] = OP[op[s, i]](rf[src_a[s, i]],
    rf[src_b[s, i]], imm[s, i])``, then ``rf = out``.  Returns the final
    register file ``[G, RF_DEPTH, T]``.

    A whole stage is evaluated at once: both operands are gathered for all
    32 slots, every opcode that occurs in the stage is computed on the
    full block and selected by mask.  No Python loop over tiles.
    """
    G, S, I = op.shape
    T = rf.shape[-1]
    for s in range(S):
        ia = src_a[:, s, :, None].long().expand(G, I, T)
        ib = src_b[:, s, :, None].long().expand(G, I, T)
        va = torch.gather(rf, 1, ia)
        vb = torch.gather(rf, 1, ib)
        cv = imm[:, s, :, None]
        ops = op[:, s, :, None]
        out = torch.zeros_like(va)           # NOP (and the select's default)
        for opc in torch.unique(ops).tolist():
            if opc == int(Op.NOP):
                continue
            out = torch.where(ops == opc, apply_op(opc, va, vb, cv), out)
        rf = out
    return rf


def vm_exec(ctx_tree, out_idx, x, rf_depth: int = RF_DEPTH):
    """Run the overlay: x [rf_depth, batch] -> outputs [n_out, batch].

    ``x`` carries the primary inputs in slots [0, n_inputs); the caller pads.
    ``ctx_tree`` is data: ``(op, src_a, src_b, imm)``, each [S, IM_DEPTH].
    """
    op, src_a, src_b, imm = (leaf[None] for leaf in ctx_tree)
    rf = run_stages(op, src_a, src_b, imm, x[None])[0]
    return rf[out_idx.long()]


def vm_exec_multi(bank_tree, out_idx_bank, ctx_ids, x,
                  rf_depth: int = RF_DEPTH):
    """Multi-tenant executor: one call serves a whole bank.

    ``bank_tree`` leaves are the ContextBank's stacked [N, S_MAX, IM_DEPTH]
    instruction arrays; ``out_idx_bank`` is [N, max_outputs] int32;
    ``ctx_ids`` is [G] int32 selecting a resident context per tile and ``x``
    is [G, rf_depth, tile].  Context selection is a pure gather on the id —
    a mixed-kernel batch runs through one call, the serving-scale analogue
    of the paper's daisy-chained context stream (the switch cost is an
    index).

    Returns [G, max_outputs, tile]; callers slice each tile's rows down to
    the selected kernel's n_outputs.
    """
    ids = ctx_ids.long()
    op, src_a, src_b, imm = (leaf[ids] for leaf in bank_tree)
    rf = run_stages(op, src_a, src_b, imm, x)
    rows = out_idx_bank[ids].long()                        # [G, max_out]
    return torch.gather(rf, 1, rows[:, :, None].expand(-1, -1, x.shape[-1]))


def pad_inputs(xs: list[torch.Tensor], rf_depth: int = RF_DEPTH,
               device=None) -> torch.Tensor:
    """Stack primary inputs into the [rf_depth, batch] RF image.

    ``device`` places the image (and thus the execution that consumes it);
    ``None`` keeps the inputs' own device.
    """
    first = torch.as_tensor(xs[0])
    x = torch.zeros((rf_depth, *first.shape), dtype=first.dtype,
                    device=first.device if device is None else device)
    for i, v in enumerate(xs):
        x[i].copy_(torch.as_tensor(v))      # fills the fresh image in place
    return x


# ------------------------------------------------------------------- oracle
def dfg_eval(dfg: DFG, env: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Direct tensor evaluation of the DFG — the functional oracle."""
    vals = dict(env)
    for n in dfg.topo_order():
        node = dfg.nodes[n]
        a = vals[node.args[0]]
        b = vals[node.args[1]] if len(node.args) > 1 else a
        if node.op not in _DFG_OPS:
            raise KeyError(node.op)
        vals[n] = apply_op(node.op, a, b, node.imm)
    return {o: vals[o] for o in dfg.outputs}


#: ops a DFG node may carry (the scheduler adds OUT/NOP, never a DFG)
_DFG_OPS = frozenset({Op.BYP, Op.ADD, Op.SUB, Op.MUL, Op.ADDC, Op.SUBC,
                      Op.RSUBC, Op.MULC, Op.SQR, Op.MAX, Op.MIN, Op.ABS,
                      Op.NEG})
