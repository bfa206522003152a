"""Analytical area / throughput / context-switch models (paper Section V).

These models reproduce every row of Tables II and III from schedule-derived
quantities; the constants come straight from the paper:

  * FU cost: 1 DSP48E1 + 81 slices; 1 DSP ≙ 60 slices on the Zynq
    XC7Z020 => 141 e-Slices per FU.
  * Pipeline clock f = 300 MHz (8-FU pipeline on Zynq: 303 MHz).
  * Throughput = op_nodes / II × f   (GOPS)   — verified to reproduce
    Table III column 'Tput' for all 8 benchmarks.
  * Area(e-Slices) = #FUs × 141                — verified: Table III 'Area'.
  * Context switch: one 40-bit word / cycle; paper worst case 82 words =
    410 B = 0.27 µs @ 300 MHz, vs 13 µs (SCFU-SCN [13]) and 200 µs (PR).
"""

from __future__ import annotations

import dataclasses

#: single-FU implementation cost on Zynq XC7Z020 (ISE 14.6, paper III-A)
FU_DSP = 1
FU_LUTS = 160
FU_FFS = 293
FU_FMAX_MHZ = 325.0
#: 8-FU pipeline + 2 I/O FIFOs
PIPE8_DSP = 8
PIPE8_LUTS = 808
PIPE8_FFS = 1077
PIPE8_FMAX_MHZ = 303.0
VIRTEX7_FMAX_MHZ = 600.0

DSP_TO_SLICES = 60
FU_SLICES = 81
FU_ESLICES = FU_DSP * DSP_TO_SLICES + FU_SLICES  # = 141

F_CLK_MHZ = 300.0

#: published comparison points (paper Section V)
SCFU_CONTEXT_US = 13.0
PR_CONTEXT_US = 200.0
PR_BITSTREAM_BYTES = 75 * 1024


def area_eslices(n_fus: int) -> int:
    return n_fus * FU_ESLICES


def pipelines_needed(n_fus: int, pipe_len: int = 8) -> int:
    """Benchmarks needing >8 FUs cascade two 8-FU pipelines (Section V)."""
    return -(-n_fus // pipe_len)


def throughput_gops(n_ops: int, ii: int, f_mhz: float = F_CLK_MHZ) -> float:
    return n_ops / ii * f_mhz / 1000.0


def mops_per_eslice(n_ops: int, ii: int, n_fus: int,
                    f_mhz: float = F_CLK_MHZ) -> float:
    return throughput_gops(n_ops, ii, f_mhz) * 1000.0 / area_eslices(n_fus)


@dataclasses.dataclass(frozen=True)
class PaperRow:
    """One published benchmark row (Tables II + III)."""

    name: str
    n_in: int
    n_out: int
    edges: int
    ops: int
    depth: int
    parallelism: float
    ii: int
    eopc: float
    tput_gops: float          # proposed overlay
    area_eslices: int         # proposed overlay
    scfu_tput: float          # SCFU-SCN overlay [13]
    scfu_area: int
    hls_tput: float           # Vivado HLS
    hls_area: int


#: Tables II & III verbatim.
PAPER_ROWS: tuple[PaperRow, ...] = (
    PaperRow("chebyshev", 1, 1, 12, 7, 7, 1.00, 6, 1.2,
             0.35, 987, 2.35, 1900, 2.21, 265),
    PaperRow("sgfilter", 2, 1, 27, 18, 9, 2.00, 10, 1.8,
             0.54, 1269, 6.03, 4560, 4.59, 645),
    PaperRow("mibench", 3, 1, 22, 13, 6, 2.16, 11, 1.2,
             0.35, 846, 4.36, 3040, 3.51, 305),
    PaperRow("qspline", 7, 1, 50, 26, 8, 3.25, 18, 1.4,
             0.43, 1128, 8.71, 8360, 6.11, 1270),
    PaperRow("poly5", 3, 1, 43, 27, 9, 3.00, 14, 1.9,
             0.58, 1269, 9.05, 6460, 7.02, 765),
    PaperRow("poly6", 3, 1, 72, 44, 11, 4.00, 17, 2.6,
             0.78, 1551, 14.74, 11400, 11.88, 1455),
    PaperRow("poly7", 3, 1, 62, 39, 13, 3.00, 17, 2.3,
             0.69, 1833, 13.07, 10640, 10.92, 1025),
    PaperRow("poly8", 3, 1, 51, 32, 11, 2.90, 15, 2.1,
             0.64, 1551, 10.72, 7220, 8.32, 1025),
)

PAPER_BY_NAME = {r.name: r for r in PAPER_ROWS}
