"""Train / prefill / decode steps used by the launchers, and the batch
decoration they share."""

from __future__ import annotations

import contextlib

import torch

from repro_torch.models import model as M
from repro_torch.models.blocks import tree_leaves, tree_unflatten
from repro_torch.models.layers import full_value, is_dtensor, whole_dim
from repro_torch.runtime import optim as O
from repro_torch.runtime.compress import compress_decompress
from repro_torch.telemetry import span


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


def _dtensor_mode(sharded: bool):
    """For DTensor params, DTensor's implicit replication: the plain
    tensors the model makes (positions, masks, zeros) then count as
    replicated on the params' mesh.  Otherwise nothing."""
    if sharded:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def loss_and_grads(cfg, params, batch):
    """The loss and its gradient tree (``params``' structure), by
    autograd over the param leaves: the reference's ``value_and_grad``.

    Params may be DTensors on a mesh (the batch then too): the loss comes
    back as a plain tensor, each gradient with its param's placements.
    Profiler ranges: ``train_step.forward`` and ``train_step.backward``
    (on a GPU autograd launches the backward's kernels from its own
    device thread, so on the device's timeline this range holds only
    the gradient's seed)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    sharded = is_dtensor(leaves[0])
    with torch.enable_grad(), _dtensor_mode(sharded):
        with span("train_step.forward"):
            loss = M.loss_fn(cfg, tree_unflatten(params, leaves), batch)
        with span("train_step.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
    if sharded:     # a Partial gradient is reduced onto its param's shards
        grads = [g if g.placements == p.placements
                 else g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, leaves)]
    return full_value(loss.detach()), tree_unflatten(params, list(grads))


def make_train_step(cfg, oc: O.OptConfig, *, compress_grads: bool = False,
                    mixed: bool = False, donate: bool = False):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Loss and gradients (``loss_and_grads``), then the optional int8
    compression hook (error feedback carried in ``opt_state['ef']``) and
    AdamW, in the reference's order.  mixed=True: params arrive in bf16
    and the f32 master lives in opt_state.  donate=True: params and
    optimizer state are updated in place (``adamw_update_``) and
    returned — the reference's ``donate_argnums=(0, 1)``; only the
    latest state is then valid.  metrics: {"loss", "grad_norm", "lr"},
    0-d float32 tensors.  The update runs inside the profiler range
    ``train_step.update`` (a profile attributes its kernels by it).
    """
    keys = ("m", "v", "master", "count") if mixed else ("m", "v", "count")
    update = {(False, False): O.adamw_update,
              (False, True): O.adamw_update_,
              (True, False): O.adamw_update_mixed,
              (True, True): O.adamw_update_mixed_}[mixed, donate]

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch)
        if compress_grads:
            grads, ef = compress_decompress(grads, opt_state.get("ef"))
            opt_state = dict(opt_state, ef=ef)
        with span("train_step.update"):
            new_params, new_state, stats = update(
                oc, grads, {k: opt_state[k] for k in keys}, params)
        if compress_grads:
            new_state = dict(new_state, ef=opt_state["ef"])
        return new_params, new_state, {"loss": loss, **stats}

    return train_step


def make_prefill_step(cfg, cache_len=None, *, layout="2d"):
    """``layout``: the sharding rules' layout of the caches made on a mesh
    (``models.model.prefill``)."""
    def prefill_step(params, batch):
        logits, caches = M.prefill(
            cfg, params, batch["tokens"], cache_len=cache_len,
            extra_embeds=batch.get("vision_embeds"),
            frame_embeds=batch.get("frame_embeds"), layout=layout)
        return logits, caches

    return prefill_step


def make_decode_step(cfg):
    """(params, caches, token, pos) -> (logits, next token, caches).

    The step writes the new token's K and V into slot ``pos % S`` of the
    K/V caches it is given, in place, and returns those same tensors (the
    reference's ``donate_argnums``); every slot a later step can read from
    caches the caller kept stays as it was, so a generation restarted
    from kept caches serves the same tokens.  The SSM and conv states come
    back new.  A wrapped ring (``pos >= S``) is copied first and the
    caller's left whole (``layers.attention_decode``).  A
    caller that runs two steps from one cache at once clones it itself.
    """
    def decode_step(params, caches, token, pos):
        logits, new_caches = M.decode_step(cfg, params, caches, token, pos)
        # greedy next token (serving driver may re-sample)
        # over the whole vocab: DTensor's own argmax over a split vocab
        # gathers its pairs into a wrong shape where the batch is whole
        next_tok = torch.argmax(whole_dim(logits, -1),
                                dim=-1).to(torch.int32)
        return logits, next_tok, new_caches

    return decode_step
