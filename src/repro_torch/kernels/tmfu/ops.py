"""Public wrappers for the TMFU pipeline kernel."""

from __future__ import annotations

import torch

from repro_torch.core.isa import RF_DEPTH
from repro_torch.kernels.tmfu.kernel import (DEFAULT_BLOCK_BATCH,
                                             tmfu_pipeline_rf,
                                             tmfu_pipeline_rf_multi,
                                             tmfu_pipeline_rf_multi_donated)


def _imm_to_i32(imm: torch.Tensor) -> torch.Tensor:
    """Pack immediates as int32 context words (bitcast f32 for float paths)."""
    if imm.dtype.is_floating_point:
        return imm.float().view(torch.int32)
    return imm.to(torch.int32)


def tmfu_pipeline(ctx, x: torch.Tensor,
                  block_batch: int = DEFAULT_BLOCK_BATCH) -> torch.Tensor:
    """Execute an overlay Context on the TMFU datapath.

    ctx: repro_torch.core.vm.Context;  x: [RF_DEPTH, batch] input RF image.
    Returns the primary outputs, shape [n_outputs, batch].
    """
    rf_depth, batch = x.shape
    assert rf_depth == RF_DEPTH
    bt = min(block_batch, _round_up(batch, 128))
    padded = _round_up(batch, bt)
    if padded != batch:
        x = torch.nn.functional.pad(x, (0, padded - batch))
    rf = tmfu_pipeline_rf(ctx.op, ctx.src_a, ctx.src_b,
                          _imm_to_i32(ctx.imm), x.contiguous(),
                          block_batch=bt)
    return rf[ctx.out_idx.long(), :batch]


def tmfu_pipeline_multi(bank, ctx_ids: torch.Tensor, x: torch.Tensor,
                        donate: bool = False) -> torch.Tensor:
    """Execute a mixed-context tile batch on the TMFU datapath.

    bank: repro_torch.core.bank.ContextBank; ctx_ids: [G] int32 slot ids;
    x: [G, RF_DEPTH, tile].  Returns [G, max_outputs, tile] — each tile's
    rows gathered through its selected context's output slots (callers
    slice to the kernel's real n_outputs).

    ``donate=True`` lets the pipeline write the final register files over
    ``x`` (the RF stack has exactly the input's shape) instead of into a
    second [G, RF_DEPTH, tile] allocation; ``x`` no longer holds the inputs
    afterwards, so only consume-once callers (the serving engines) may set
    it.
    """
    op, src_a, src_b, imm = bank.tree()
    rf_fn = tmfu_pipeline_rf_multi_donated if donate else tmfu_pipeline_rf_multi
    ids = ctx_ids.to(torch.int32)
    rf = rf_fn(op, src_a, src_b, _imm_to_i32(imm), ids, x)
    out_rows = bank.out_idx[ids.long()].long()             # [G, max_out]
    return torch.gather(rf, 1,
                        out_rows[:, :, None].expand(-1, -1, x.shape[-1]))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m
