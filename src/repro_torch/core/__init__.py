"""The paper's primary contribution: an area-efficient overlay built from
linearly-connected, time-multiplexed functional units.

Pipeline: frontend (HLL->DFG) -> schedule (ASAP staging + bypass + II) ->
isa (32-bit no-decoder words, 40-bit context stream) -> overlay executor
(one CUDA TMFU kernel / plain PyTorch VM, context switch = data swap).
"""

from repro_torch.core.bank import (BankDirectory, BankError, ContextBank,
                                   bank_from_numpy, context_key)
from repro_torch.core.dfg import DFG, Node, Op
from repro_torch.core.frontend import build_dfg
from repro_torch.core.schedule import Schedule, schedule
from repro_torch.core.isa import Program, encode
from repro_torch.core.overlay import CompiledKernel, Overlay, compile_program
from repro_torch.core.vm import (context_from_numpy, dfg_eval, make_context,
                                 vm_exec, vm_exec_multi)

__all__ = [
    "DFG", "Node", "Op", "build_dfg", "Schedule", "schedule", "Program",
    "encode", "CompiledKernel", "Overlay", "compile_program",
    "dfg_eval", "ContextBank", "BankError", "BankDirectory", "context_key",
    "bank_from_numpy", "context_from_numpy", "make_context",
    "vm_exec", "vm_exec_multi",
]
