"""Deterministic, resumable, host-sharded token pipeline (the reference's
``data/pipeline.py``).

Two sources:
  * ``SyntheticCorpus`` — a counter-based token stream: deterministic in
    (seed, step, host_index), no files, arbitrarily large.  The reference
    draws it with ``jax.random`` (threefry), which PyTorch cannot
    reproduce; this one is numpy's Philox keyed by the seed, its counter
    set by (step, host_index) — another stream under the same contract.
  * ``MemmapCorpus``   — a flat uint16/uint32 token file, read via
    np.memmap with a strided cursor: the same tokens as the reference's,
    bit for bit.

Both expose ``batch(step) -> {"tokens": [B_local, S] int32}`` on the host
(the caller moves it to its device), where B_local is this host's shard
of the global batch, plus a ``cursor(step)`` that goes into checkpoints so
restarts resume exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    vocab: int
    seed: int = 0
    num_hosts: int = 1
    host_index: int = 0

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class SyntheticCorpus:
    def __init__(self, dc: DataConfig):
        self.dc = dc

    def batch(self, step: int) -> dict:
        dc = self.dc
        # Philox-4x64: key = the seed, counter = (0, 0, step, host); a
        # batch draws n / 4 blocks from the two low words, so no two
        # (step, host) pairs share a block
        bits = np.random.Philox(
            key=np.array([dc.seed, 0], np.uint64),
            counter=np.array([0, 0, step, dc.host_index], np.uint64))
        n = dc.local_batch * dc.seq_len
        toks = (bits.random_raw(n) % np.uint64(dc.vocab)).astype(np.int32)
        return {"tokens": torch.from_numpy(
            toks.reshape(dc.local_batch, dc.seq_len))}

    def cursor(self, step: int) -> dict:
        return {"kind": "synthetic", "seed": self.dc.seed, "step": step}

    @staticmethod
    def resume(dc: DataConfig, cursor: dict) -> tuple["SyntheticCorpus", int]:
        assert cursor["kind"] == "synthetic"
        return SyntheticCorpus(dataclasses.replace(dc, seed=cursor["seed"])), \
            cursor["step"]


class MemmapCorpus:
    def __init__(self, dc: DataConfig, path: str, dtype=np.uint16):
        self.dc = dc
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.n = len(self.tokens) // dc.seq_len

    def batch(self, step: int) -> dict:
        dc = self.dc
        # strided, host-disjoint rows; wraps deterministically
        base = step * dc.global_batch + dc.host_index * dc.local_batch
        rows = (base + np.arange(dc.local_batch)) % self.n
        out = np.stack([
            self.tokens[r * dc.seq_len:(r + 1) * dc.seq_len] for r in rows])
        return {"tokens": torch.from_numpy(out.astype(np.int32) % dc.vocab)}

    def cursor(self, step: int) -> dict:
        return {"kind": "memmap", "step": step}


def make_corpus(dc: DataConfig, path: str | None = None):
    return MemmapCorpus(dc, path) if path else SyntheticCorpus(dc)
