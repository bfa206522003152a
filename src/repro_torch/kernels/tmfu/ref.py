"""Per-instruction oracle for the TMFU pipeline kernel.

Executes the encoded overlay context with plain Python loops over stages and
instruction slots — bit-identical semantics to the hardware model: every
instruction result streams to slot *i* of the next stage's register file.
One opcode branch per instruction (``core.vm.apply_op``), no masks and no
gathers, so it shares nothing but the 18 opcode bodies with the stage-wide
plain executor it cross-checks.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.vm import apply_op


def tmfu_ref(op: np.ndarray, src_a: np.ndarray, src_b: np.ndarray,
             imm: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Reference: x [RF_DEPTH, batch] -> final RF [RF_DEPTH, batch].

    ``op/src_a/src_b/imm`` are host arrays ``[S, IM_DEPTH]``; ``imm`` holds
    values exactly representable in ``x.dtype``.
    """
    S, I = op.shape
    rf = torch.as_tensor(x)
    for s in range(S):
        outs = []
        for i in range(I):
            va = rf[int(src_a[s, i])]
            vb = rf[int(src_b[s, i])]
            cv = torch.tensor(imm[s, i].item(), dtype=rf.dtype,
                              device=rf.device)
            outs.append(apply_op(int(op[s, i]), va, vb, cv))
        rf = torch.stack(outs)
    return rf
