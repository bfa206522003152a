"""Prefill / decode steps used by the launcher, and the batch decoration
shared with the training slice."""

from __future__ import annotations

import torch

from repro_torch.models import model as M


def decorate_batch(cfg, dc, batch, seq_len: int | None = None):
    """Attach the zero vision/frame embeds that archs with those towers
    expect, in place; returns the batch.  The single batch-shaping point
    for every path that builds a batch for a step (reads only
    ``dc.local_batch`` and ``dc.seq_len``).  The embeds are made on the
    device of ``batch["tokens"]``."""
    device = batch["tokens"].device
    if cfg.vision_tokens:
        batch["vision_embeds"] = torch.zeros(
            (dc.local_batch, cfg.vision_tokens, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    if cfg.encoder is not None:
        batch["frame_embeds"] = torch.zeros(
            (dc.local_batch, seq_len or dc.seq_len, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    return batch


def make_prefill_step(cfg, cache_len=None):
    def prefill_step(params, batch):
        logits, caches = M.prefill(
            cfg, params, batch["tokens"], cache_len=cache_len,
            extra_embeds=batch.get("vision_embeds"),
            frame_embeds=batch.get("frame_embeds"))
        return logits, caches

    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, caches, token, pos):
        logits, new_caches = M.decode_step(cfg, params, caches, token, pos)
        # greedy next token (serving driver may re-sample)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, next_tok, new_caches

    return decode_step
