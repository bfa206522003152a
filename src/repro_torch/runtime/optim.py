"""AdamW + cosine schedule over trees of tensors (the reference's
``runtime/optim.py``).

Everything computes in float32 on the params' device; ``count`` is a 0-d
int32 tensor.  Leaves are summed in the reference's leaf order
(``tree_leaves_with_path``: dict keys sorted), so ``global_norm`` adds the
same terms in the same order.

``adamw_update`` is functional: it returns new trees and holds old and new
params and moments at once.  ``adamw_update_`` is the same arithmetic in
place, one leaf (and one slice of a large leaf) at a time, for a run whose
state fills the card — what the reference gets from donating params and
optimizer state to its jitted step.  The two agree bit for bit.

On a mesh, params, gradients and moments are DTensors of the same
placements: ``global_norm``'s sums of squares are all-reduced by DTensor,
and ``adamw_update_`` updates each rank's local shards (elementwise, so
the same bits as the whole tensor would get).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.blocks import tree_leaves_with_path, tree_map
from repro_torch.models.layers import full_value, is_dtensor

#: elements of one leaf updated together in place: bounds the float32
#: temporaries of ``adamw_update_`` to a few of these (256 MB each)
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def schedule(oc: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to 0.1 of ``oc.lr`` (float32)."""
    step = step.to(torch.float32)
    warm = step / max(oc.warmup_steps, 1)
    prog = (step - oc.warmup_steps) / max(oc.total_steps - oc.warmup_steps, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * torch.clamp(prog, 0, 1)))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, 0.1 + 0.9 * cos)


def _leaves(tree) -> list:
    return [x for _, x in tree_leaves_with_path(tree)]


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage); a plain tensor."""
    return x.to_local() if is_dtensor(x) else x


def _count(params) -> torch.Tensor:
    device = _leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def init_opt(params) -> dict:
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": _count(params)}


def init_opt_mixed(params_bf16) -> dict:
    """Mixed precision: bf16 working params + f32 master/moments."""
    master = tree_map(lambda p: p.to(torch.float32, copy=True), params_bf16)
    return {"m": tree_map(torch.zeros_like, master),
            "v": tree_map(torch.zeros_like, master),
            "master": master, "count": _count(params_bf16)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares, leaf by leaf in the reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for _, x in tree_leaves_with_path(tree)))


def _prologue(oc: OptConfig, grads, count):
    """The step's scalars: (count + 1, lr, grad norm, clip scale, bc1, bc2)."""
    count = count + 1
    lr = schedule(oc, count)
    gnorm = full_value(global_norm(grads))
    scale = torch.clamp_max(torch.full_like(gnorm, oc.grad_clip)
                            / (gnorm + 1e-9), 1.0)
    c = count.to(torch.float32)
    return count, lr, gnorm, scale, 1 - oc.b1 ** c, 1 - oc.b2 ** c


def adamw_update(oc: OptConfig, grads, state, params):
    """Returns (new_params, new_state, stats)."""
    count, lr, gnorm, scale, bc1, bc2 = _prologue(oc, grads, state["count"])
    grads = tree_map(lambda g: g.to(torch.float32) * scale, grads)
    b1, b2 = oc.b1, oc.b2
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)

    def upd(p, m_, v_):
        mh = m_ / bc1
        vh = v_ / bc2
        step = mh / (torch.sqrt(vh) + oc.eps) + oc.weight_decay * p
        return (p - lr * step).to(p.dtype)

    new_params = tree_map(upd, params, m, v)
    return new_params, {"m": m, "v": v, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}


def adamw_update_(oc: OptConfig, grads, state, params):
    """``adamw_update`` in place: params, ``state["m"]``, ``state["v"]``
    and ``state["count"]`` are overwritten (grads are read only).  Same
    arithmetic, same order, element by element; returns the same
    triple, its trees being the arguments themselves."""
    count, lr, gnorm, scale, bc1, bc2 = _prologue(oc, grads, state["count"])
    state["count"].copy_(count)
    b1, b2 = oc.b1, oc.b2
    with torch.no_grad():
        for g, m_, v_, p in zip(*(map(_local, _leaves(t)) for t in (
                grads, state["m"], state["v"], params))):
            for gc, mc, vc, pc in zip(g.reshape(-1).split(CHUNK),
                                      *(x.view(-1).split(CHUNK)
                                        for x in (m_, v_, p))):
                gf = gc.to(torch.float32) * scale
                mc.mul_(b1).add_(gf * (1 - b1))
                vc.mul_(b2).add_((gf * (1 - b2)).mul_(gf))
                step = (mc / bc1).div_(torch.sqrt(vc / bc2).add_(oc.eps))
                step.add_(oc.weight_decay * pc)
                pc.sub_(step.mul_(lr))
    return params, state, {"grad_norm": gnorm, "lr": lr}


def adamw_update_mixed(oc: OptConfig, grads_bf16, state, _params_bf16):
    """AdamW on the f32 master; returns fresh bf16 working params."""
    new_master, sub, stats = adamw_update(
        oc, grads_bf16, {k: state[k] for k in ("m", "v", "count")},
        state["master"])
    new_params = tree_map(lambda p: p.to(torch.bfloat16), new_master)
    return new_params, {**sub, "master": new_master}, stats


def adamw_update_mixed_(oc: OptConfig, grads_bf16, state, params_bf16):
    """``adamw_update_mixed`` in place: the master and moments updated,
    then the bf16 working params overwritten with the master's cast."""
    _, sub, stats = adamw_update_(
        oc, grads_bf16, {k: state[k] for k in ("m", "v", "count")},
        state["master"])
    with torch.no_grad():
        for p, w in zip(_leaves(params_bf16), _leaves(state["master"])):
            p.copy_(w)
    return params_bf16, {**sub, "master": state["master"]}, stats

