"""Instruction encoding — the paper's no-decoder 32-bit word + 40-bit context.

Paper Section III-A: a 32-bit instruction = 21-bit DSP48E1 configuration +
two 5-bit source operand addresses; context words are 40 bits = 32-bit
instruction + 8-bit FU tag, daisy-chained through the FU instruction ports.

Software adaptation: there is no DSP48E1 to configure, so the "configuration"
field carries (opcode, dest-slot, const-index) which the TMFU kernel/VM
dispatches on directly with a branch table — no decode stage, matching the
paper's no-decoder philosophy.  Packing (32 bits):

    [31:27] opcode (5)   [26:22] dest slot (5)
    [21:17] srcA RF addr (5)     [16:12] srcB RF addr / const idx (5)
    [11: 0] dsp_cfg (12) — emulated DSP48E1 OPMODE/ALUMODE/INMODE image

Constants are pre-loaded into a small per-FU constant table at context-load
time (the RF is writable at init; paper Section III-A), addressed by the
srcB field for *C ops.  Context stream = one 40-bit word per instruction +
one per constant.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dfg import CONST_OPS, Op
from repro_torch.core.schedule import Schedule

#: register-file / instruction-memory depth (paper: 32-entry RAM32M)
RF_DEPTH = 32
IM_DEPTH = 32
#: per-FU constant-table depth (carved from the top of the RF address space)
CONST_DEPTH = 8
#: bytes per 40-bit context word
CONTEXT_WORD_BYTES = 5

# Emulated DSP48E1 configuration images per opcode (OPMODE[6:0] ++ ALUMODE
# [3:0] ++ INMODE-ish bit).  Values chosen to match the DSP48E1 manual's
# add/sub/mul opmodes; they are carried verbatim so the instruction word is
# bit-faithful even though the executor dispatches on the opcode field.
_DSP_CFG = {
    Op.BYP:  0b000_0011_0000_0,
    Op.ADD:  0b000_0011_0011_0,
    Op.SUB:  0b011_0011_0011_0,
    Op.MUL:  0b000_0101_0101_1,
    Op.ADDC: 0b000_0011_0011_0,
    Op.SUBC: 0b011_0011_0011_0,
    Op.RSUBC: 0b011_0011_0011_1,
    Op.MULC: 0b000_0101_0101_1,
    Op.SQR:  0b000_0101_0101_1,
    Op.MAX:  0b010_0011_0011_0,
    Op.MIN:  0b010_0011_0011_1,
    Op.ABS:  0b010_0011_0000_0,
    Op.NEG:  0b011_0011_0000_0,
    Op.AND:  0b000_1111_0000_0,
    Op.OR:   0b000_1111_0001_0,
    Op.XOR:  0b000_1111_0010_0,
    Op.OUT:  0b000_0011_0000_0,
    Op.NOP:  0,
}


def pack_word(op: Op, dest: int, src_a: int, src_b: int) -> int:
    assert 0 <= dest < 32 and 0 <= src_a < 32 and 0 <= src_b < 32
    return (int(op) << 27) | (dest << 22) | (src_a << 17) | (src_b << 12) \
        | _DSP_CFG[op]


def unpack_word(w: int) -> tuple[Op, int, int, int]:
    return (Op((w >> 27) & 0x1F), (w >> 22) & 0x1F,
            (w >> 17) & 0x1F, (w >> 12) & 0x1F)


@dataclasses.dataclass
class StageImage:
    """Encoded instruction memory + constant table of one FU."""

    stage: int
    words: np.ndarray       # [n_instr] uint32
    consts: np.ndarray      # [n_consts] float32 (context-loaded)
    n_loads: int


@dataclasses.dataclass
class Program:
    """A fully encoded overlay kernel context ('the bitstream analogue')."""

    name: str
    images: tuple[StageImage, ...]
    n_inputs: int
    n_outputs: int
    ii: int

    @property
    def context_words(self) -> int:
        return sum(len(i.words) + len(i.consts) for i in self.images)

    @property
    def context_bytes(self) -> int:
        """Paper Section V: 65..410 B over the benchmark set."""
        return self.context_words * CONTEXT_WORD_BYTES

    def context_switch_cycles(self) -> int:
        """One daisy-chained 40-bit word per cycle (paper: worst case 82)."""
        return self.context_words

    def context_switch_us(self, f_mhz: float = 300.0) -> float:
        return self.context_switch_cycles() / f_mhz


class EncodeError(ValueError):
    pass


def encode(sched: Schedule) -> Program:
    """Encode a Schedule into per-FU instruction images.

    RF layout per FU: loads occupy addresses [0, n_loads); constants are
    addressed through the srcB field into the per-FU constant table.
    Results stream to the next FU in instruction order, so an instruction's
    dest slot is its position in the output stream.
    """
    images = []
    for prog in sched.stages:
        if prog.n_instrs > IM_DEPTH:
            raise EncodeError(
                f"{sched.dfg.name}: stage {prog.stage} needs "
                f"{prog.n_instrs} instruction slots > {IM_DEPTH}")
        if prog.n_loads > RF_DEPTH - CONST_DEPTH:
            raise EncodeError(
                f"{sched.dfg.name}: stage {prog.stage} streams "
                f"{prog.n_loads} words > RF capacity")
        addr = {v: i for i, v in enumerate(prog.loads)}
        consts: list[float] = []
        words = []
        for slot, ins in enumerate(prog.instrs):
            a = addr[ins.args[0]]
            if ins.op in CONST_OPS:
                consts.append(float(ins.imm))
                if len(consts) > CONST_DEPTH:
                    raise EncodeError(
                        f"{sched.dfg.name}: stage {prog.stage} needs "
                        f"{len(consts)} constants > {CONST_DEPTH}")
                b = len(consts) - 1
            elif len(ins.args) > 1:
                b = addr[ins.args[1]]
            else:
                b = a  # unary/SQR/BYP: srcB mirrors srcA (paper: 'SQR (R0 R0)')
            words.append(pack_word(ins.op, slot, a, b))
        images.append(StageImage(
            stage=prog.stage,
            words=np.asarray(words, dtype=np.uint32),
            consts=np.asarray(consts, dtype=np.float32),
            n_loads=prog.n_loads))
    return Program(name=sched.dfg.name, images=tuple(images),
                   n_inputs=len(sched.dfg.inputs),
                   n_outputs=len(sched.dfg.outputs), ii=sched.ii)
