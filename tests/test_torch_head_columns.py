"""The index arithmetic of Mamba2's exchange of head columns, with no
process group: ``ssm.head_columns`` (the in-projection's columns a
``model`` rank's heads need, in ``_by_heads``' order) and
``layers.column_plan`` / ``chunk_spans`` (who sends whom which columns
of a column-parallel block in the one all-to-all of
``layers.exchange_columns``, each rank's piece of the B and C span that
the all-gather after it makes whole, and where a rank's columns lie in
what it then has).

For mamba2-2.7b's and zamba2-7b's published dims on 2, 4, 8 and 16
ranks, and the smoke dims on the axes their 8 heads split over: each
rank's columns against a count written out head by head; the exchange
played out in numpy — what a rank holds plus what the all-to-all brings
it, then the all-gathered span, picked — is exactly those columns, in
that order; no rank receives a column twice; the pieces tile the span;
the split sizes agree between sender and receiver and add up on both
sides; no rank sends more than its block or receives more than one
block beside its piece; the blocks are DTensor's ``Shard`` chunks.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.layers import chunk_spans, column_plan
from repro_torch.models.ssm import head_columns

CASES = [(arch, n) for arch in ("mamba2-2.7b", "zamba2-7b")
         for n in (2, 4, 8, 16)] \
    + [("mamba2-2.7b|smoke", n) for n in (2, 4, 8)]


def _dims(arch):
    if arch.endswith("|smoke"):
        return get_smoke_config(arch.split("|")[0]).ssm
    return get_config(arch).ssm


def _width(d):
    return 2 * d.d_inner + 2 * d.n_groups * d.d_state + d.n_heads


def _written_out(d, n, r):
    """Rank ``r``'s columns head by head: z of each head, x of each head,
    B then C of each group its heads fall in, dt of each head."""
    din, N, H, G, P = d.d_inner, d.d_state, d.n_heads, d.n_groups, \
        d.head_dim
    heads = range(r * H // n, (r + 1) * H // n)
    groups = sorted({h * G // H for h in heads})
    z = [c for h in heads for c in range(h * P, (h + 1) * P)]
    x = [din + c for c in z]
    b = [2 * din + g * N + i for g in groups for i in range(N)]
    c = [2 * din + G * N + g * N + i for g in groups for i in range(N)]
    dt = [2 * din + 2 * G * N + h for h in heads]
    return np.asarray(z + x + b + c + dt)


@pytest.mark.parametrize("arch,n", CASES)
def test_each_rank_gets_exactly_its_heads_columns(arch, n):
    d = _dims(arch)
    width = _width(d)
    a, b = 2 * d.d_inner, 2 * d.d_inner + 2 * d.n_groups * d.d_state
    needs = [head_columns(d, n, r) for r in range(n)]
    spans = chunk_spans(width, n)
    # DTensor's Shard(-1) blocks are torch.chunk's
    chunks = torch.arange(width).chunk(n)
    assert [(int(c[0]), int(c[-1]) + 1) for c in chunks] == spans[:len(chunks)]
    wants, splits, picks = column_plan(needs, width, (a, b))
    # the all-to-all, played out: rank r gets from each rank s, in rank
    # order, the columns of s's block it wants
    got = [np.concatenate([w[(w >= lo) & (w < hi)] for lo, hi in spans])
           for w in wants]
    pieces = [g[(g >= a) & (g < b)] for g in got]
    np.testing.assert_array_equal(np.concatenate(pieces), np.arange(a, b))
    width_piece = max(len(p) for p in pieces)
    assert all(len(p) == width_piece for p in pieces if len(p))
    for r in range(n):
        np.testing.assert_array_equal(needs[r], _written_out(d, n, r))
        assert np.all(np.diff(needs[r]) > 0)
        np.testing.assert_array_equal(got[r], wants[r])
        assert len(set(got[r].tolist())) == len(got[r])
        np.testing.assert_array_equal(
            np.concatenate([got[r], np.arange(a, b)])[picks[r]], needs[r])
        # outside the span, exactly the rank's heads' columns
        outside = (needs[r] < a) | (needs[r] >= b)
        np.testing.assert_array_equal(
            got[r][(got[r] < a) | (got[r] >= b)], needs[r][outside])
        # split sizes: sender's and receiver's agree, and add up
        lo, hi = spans[r]
        assert splits[r].sum() == sum(((w >= lo) & (w < hi)).sum()
                                      for w in wants)
        assert splits[:, r].sum() == len(wants[r])
        assert list(splits[:, r]) == [((wants[r] >= s_lo) & (wants[r] < s_hi))
                                      .sum() for s_lo, s_hi in spans]
        # balance: no rank sends more than its block, or receives more
        # than one block beside its piece
        assert splits[r].sum() - splits[r, r] <= hi - lo
        assert splits[:, r].sum() - splits[r, r] <= spans[0][1] + width_piece
