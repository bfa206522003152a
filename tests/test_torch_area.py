"""The port's ``core/area.py`` (the paper's area, throughput and
context-switch models) equals the reference's exactly, and the port's
timing functions of ``core/overlay.py`` (``Overlay.time_context_switch``,
``spatial_jit``, ``time_recompile``) run on the CPU.

``spatial_jit`` compiles with ``torch.compile`` (inductor's C++ backend on
the CPU needs a C++ compiler): one small DFG, one compile for the check
and one timed recompile, about 45 s here.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.core.area as JA
import repro_torch.core.area as TA
from repro_torch.core.overlay import (Overlay, compile_program, spatial_jit,
                                      time_recompile)
from repro_torch.core.paper_bench import BENCH_NAMES, benchmark
from repro_torch.core.vm import dfg_eval

CONSTANTS = ("FU_DSP", "FU_LUTS", "FU_FFS", "FU_FMAX_MHZ", "PIPE8_DSP",
             "PIPE8_LUTS", "PIPE8_FFS", "PIPE8_FMAX_MHZ", "VIRTEX7_FMAX_MHZ",
             "DSP_TO_SLICES", "FU_SLICES", "FU_ESLICES", "F_CLK_MHZ",
             "SCFU_CONTEXT_US", "PR_CONTEXT_US", "PR_BITSTREAM_BYTES")


def test_constants_equal():
    public = {k for k in vars(JA) if k.isupper()}
    assert public == {k for k in vars(TA) if k.isupper()}
    assert set(CONSTANTS) <= public
    for k in public - {"PAPER_ROWS", "PAPER_BY_NAME"}:
        assert getattr(TA, k) == getattr(JA, k), k


def test_paper_rows_equal():
    assert len(TA.PAPER_ROWS) == len(JA.PAPER_ROWS) == 8
    for t, j in zip(TA.PAPER_ROWS, JA.PAPER_ROWS):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert list(TA.PAPER_BY_NAME) == list(JA.PAPER_BY_NAME)
    for name, row in TA.PAPER_BY_NAME.items():
        assert dataclasses.asdict(row) == dataclasses.asdict(
            JA.PAPER_BY_NAME[name])


@pytest.mark.parametrize("n_fus", [1, 7, 8, 9, 16, 17, 33])
def test_area_functions_equal(n_fus):
    assert TA.area_eslices(n_fus) == JA.area_eslices(n_fus)
    for pipe in (4, 8):
        assert TA.pipelines_needed(n_fus, pipe) == JA.pipelines_needed(
            n_fus, pipe)
    for ops, ii in ((7, 6), (44, 17), (26, 18)):
        assert TA.throughput_gops(ops, ii) == JA.throughput_gops(ops, ii)
        assert TA.throughput_gops(ops, ii, 600.0) == JA.throughput_gops(
            ops, ii, 600.0)
        assert TA.mops_per_eslice(ops, ii, n_fus) == JA.mops_per_eslice(
            ops, ii, n_fus)


def test_rows_reproduce_the_published_throughput_and_area():
    """Throughput = ops / II x f and area = FUs x 141 reproduce every row
    (FUs = depth, the linear pipeline's length)."""
    for r in TA.PAPER_ROWS:
        assert math.isclose(TA.throughput_gops(r.ops, r.ii), r.tput_gops,
                            abs_tol=0.006), r.name
        assert TA.area_eslices(r.depth) == r.area_eslices, r.name


def test_spatial_jit_equals_dfg_eval_and_recompile_times():
    k = compile_program(benchmark("poly6"))
    rng = np.random.RandomState(0)
    xs = [torch.from_numpy(rng.uniform(-2, 2, 64).astype(np.float32))
          for _ in k.dfg.inputs]
    got = spatial_jit(k.dfg)(xs)
    want = dfg_eval(k.dfg, dict(zip(k.dfg.inputs, xs)))
    assert len(got) == len(k.dfg.outputs)
    for g, o in zip(got, k.dfg.outputs):
        torch.testing.assert_close(g, want[o], rtol=1e-6, atol=1e-6)
    t = time_recompile(k.dfg, xs, iters=1)
    assert math.isfinite(t) and t > 0


@pytest.mark.parametrize("name", list(BENCH_NAMES)[:3])
def test_time_context_switch(name):
    ov = Overlay(device="cpu")
    t = ov.time_context_switch(compile_program(benchmark(name)), iters=3)
    assert math.isfinite(t) and t > 0
