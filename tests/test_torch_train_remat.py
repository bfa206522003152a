"""Within the port, bit for bit (CPU, both compute modes where it
matters): the train-mode stack runner's variants and the in-place
optimizer compute exactly what the plain forms compute.

* remat ``"full"`` == ``"dots"`` == no remat (``spatial``: split per layer,
  no checkpoint), and tm (``torch.unbind``) == spatial: logits, loss and
  every gradient, all ten smoke configs.
* remat really recomputes: ``"full"`` runs every layer's matmuls again in
  backward, ``"dots"`` keeps the 2-D weight products (``aten.mm``) and
  recomputes the rest.
* the stacking repair: in train mode every stacked leaf is consumed by
  ONE ``UnbindBackward`` (no per-layer ``SelectBackward``, which would
  add a whole-stack zero tensor per layer in backward).
* ``donate=True`` (in place) == functional, three steps, plain /
  compressed / mixed.
"""

import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.models import (forward, loss_fn, numpy_params,
                                params_from_numpy)
from repro_torch.models.blocks import tree_leaves, tree_map, tree_unflatten
from repro_torch.runtime import optim as O
from repro_torch.runtime.steps import (decorate_batch, loss_and_grads,
                                      make_train_step)
from torch_port_support import assert_trees_bitwise

VARIANTS = {"tm_full": dict(scan_layers=True, remat_policy="full"),
            "tm_dots": dict(scan_layers=True, remat_policy="dots"),
            "spatial": dict(scan_layers=False)}


def batch_for(cfg, step=0):
    dc = DataConfig(2, 16, cfg.vocab)
    b = SyntheticCorpus(dc).batch(step)
    return decorate_batch(cfg, dc, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_layouts_bit_for_bit(arch):
    base = get_smoke_config(arch)
    params = params_from_numpy(base, numpy_params(base, 0), "cpu")
    batch = batch_for(base)
    out = {}
    for name, kw in VARIANTS.items():
        cfg = dataclasses.replace(base, **kw)
        logits, aux, _ = forward(cfg, params, batch["tokens"][:, :-1],
                                 extra_embeds=batch.get("vision_embeds"),
                                 frame_embeds=batch.get("frame_embeds"))
        loss, grads = loss_and_grads(cfg, params, batch)
        out[name] = {"logits": logits, "aux": aux, "loss": loss,
                     "grads": grads}
    ref = out["spatial"]
    for name in ("tm_full", "tm_dots"):
        assert_trees_bitwise(out[name], ref, f"{arch} {name} vs spatial")


class CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_and_dots_saves_weight_products():
    base = get_smoke_config("deepseek-7b")
    params = params_from_numpy(base, numpy_params(base, 0), "cpu")
    batch = batch_for(base)
    counts = {}
    for name, kw in VARIANTS.items():
        cfg = dataclasses.replace(base, **kw)
        with CountMM() as mode:
            loss_and_grads(cfg, params, batch)
        counts[name] = mode.n
    # per layer, "full" computes the weight products again in backward
    # up to the last one backward needs: q, k, v, o, gate, up (the down
    # projection feeds only the residual sum, and the recompute stops
    # before it); "dots" keeps them all
    layers = base.n_layers
    assert counts["tm_full"] == counts["spatial"] + 6 * layers, counts
    assert counts["tm_dots"] == counts["spatial"], counts


def test_moe_group_sizes_read_again_in_the_recompute(monkeypatch):
    """The MoE dispatch reads its group sizes on the host (one sync a MoE
    layer); under remat the recompute reads them again: two reads a MoE
    layer a step in tm mode ("full" and "dots" alike), one in spatial."""
    import repro_torch.models.blocks as blocks
    base = get_smoke_config("qwen2-moe-a2.7b")
    params = params_from_numpy(base, numpy_params(base, 0), "cpu")
    batch = batch_for(base)
    n_moe = sum(s.count for s in base.stacks for b in s.blocks if b.moe)
    calls = []
    real = blocks.moe_apply
    monkeypatch.setattr(blocks, "moe_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for name, kw in VARIANTS.items():
        calls.clear()
        loss_and_grads(dataclasses.replace(base, **kw), params, batch)
        want = n_moe if name == "spatial" else 2 * n_moe
        assert len(calls) == want, (name, len(calls), n_moe)


def _consumers(loss, leaves):
    """For each leaf, the names of the autograd nodes that consume it."""
    ids = {id(x): i for i, x in enumerate(leaves)}
    found = [[] for _ in leaves]
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in ids:
                found[ids[id(var)]].append(type(node).__name__)
            stack.append(nxt)
    return found


@pytest.mark.parametrize("arch", ["deepseek-7b", "zamba2-7b"])
def test_stacked_leaves_unbound_once_in_train_mode(arch):
    cfg = get_smoke_config(arch)
    params = params_from_numpy(cfg, numpy_params(cfg, 0), "cpu")
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(cfg, tree_unflatten(params, leaves), batch_for(cfg))
    names = _consumers(loss, leaves)
    stacked = [[id(x) for x in tree_leaves(sp[j])]
               for st, sp in zip(cfg.stacks, params["stacks"])
               for j, spec in enumerate(st.blocks) if not spec.shared]
    stacked = {i for group in stacked for i in group}
    n = 0
    for p, who in zip(tree_leaves(params), names):
        if id(p) in stacked:
            assert who == ["UnbindBackward0"], who
            n += 1
    assert n > 0


@pytest.mark.parametrize("variant", ["plain", "compress", "mixed"])
def test_donate_equals_functional(variant):
    cfg = get_smoke_config("mamba2-2.7b" if variant == "compress"
                           else "deepseek-7b")
    oc = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    kw = dict(compress_grads=variant == "compress",
              mixed=variant == "mixed")
    runs = []
    for donate in (False, True):
        params = params_from_numpy(cfg, numpy_params(cfg, 0), "cpu")
        if kw["mixed"]:
            params = tree_map(lambda x: x.to(torch.bfloat16), params)
        opt = O.init_opt_mixed(params) if kw["mixed"] else O.init_opt(params)
        step = make_train_step(cfg, oc, donate=donate, **kw)
        first = (params, opt)
        losses = []
        for s in range(3):
            params, opt, m = step(params, opt, batch_for(cfg, s))
            losses.append(m["loss"])
        if donate:      # updated in place: the very tensors passed in
            assert all(a is b for a, b in zip(tree_leaves(params),
                                              tree_leaves(first[0])))
        runs.append((params, opt, losses))
    (pf, of, lf), (pd, od, ld) = runs
    assert all(torch.equal(a, b) for a, b in zip(lf, ld))
    assert_trees_bitwise(pd, pf, "params")
    assert_trees_bitwise(od, of, "opt_state")
