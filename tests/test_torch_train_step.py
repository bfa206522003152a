"""The port's train step (``repro_torch.runtime.steps.make_train_step``)
against the reference's on all ten smoke configs, one step each, on the
CPU in float32 mode; and the port's reference-order flatten
(``tree_leaves_with_path``) against ``jax.tree_util``.

Weights come from ``numpy_params`` (``jnp.asarray`` / ``params_from_numpy``),
tokens from ``numpy.random.RandomState(1)``; the reference runs under
``jax.jit``.

* **loss** to ``REL_F32 = 1e-5`` relative.
* **gradients**, per leaf: ``max|a - b| <= 1e-5 * scale``, ``scale`` the
  leaf's ``max|g|`` — or, for a leaf whose gradient is more than four
  orders of magnitude below the tree's largest, ``1e-4`` of that largest
  (``GRAD_FLOOR``).  Such a leaf is a sum that cancels (zamba2's second
  stack's ``A_log``: max|g| 5.9e-5 against 2.35 for the embedding) and
  carries the float32 rounding of the cotangents it is contracted from:
  its own-max error reads 1.06e-5.
* **moments** of the step: ``m`` and ``sqrt(v)`` (both linear in the
  gradient) to the gradients' bound.
* **new params**: Adam's first step divides each gradient element by its
  own magnitude (``g / (|g| + eps)``), so an element whose gradient sits
  at the float32 noise floor moves by up to ``lr`` either way, whatever
  the tolerance on the gradient.  The update itself is held on the same
  gradients: the port's AdamW on the REFERENCE's gradients against the
  reference's new params to ``1e-6`` relative; and the port's step is its
  own AdamW on its own gradients, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
import repro_torch.models.model as TM
from repro.configs import ARCHS
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.runtime import optim as JO
from repro.runtime.steps import decorate_batch as jax_decorate
from repro.runtime.steps import make_train_step as jax_train_step
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.models import numpy_params, params_from_numpy
from repro_torch.models.blocks import (tree_leaves, tree_leaves_with_path,
                                       tree_map)
from repro_torch.runtime import optim as TO
from repro_torch.runtime.steps import (decorate_batch, loss_and_grads,
                                      make_train_step)
from torch_port_support import (assert_trees_bitwise, float32_mode,
                                leaf_pairs, leaf_rel)

REL_F32 = 1e-5
REL_ADAMW = 1e-6
GRAD_FLOOR = 1e-4
B, S = 2, 32
OC = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def batches(tcfg, jcfg, seed=1):
    tokens = np.random.RandomState(seed).randint(
        0, tcfg.vocab, (B, S + 1)).astype(np.int32)
    jb = jax_decorate(jcfg, JDataConfig(B, S, jcfg.vocab),
                      {"tokens": jnp.asarray(tokens)})
    tb = decorate_batch(tcfg, DataConfig(B, S, tcfg.vocab),
                        {"tokens": torch.from_numpy(tokens)})
    return jb, tb


def assert_grad_like(port, ref, what):
    """Every leaf within ``REL_F32`` of its scale (see the docstring)."""
    pairs = leaf_pairs(port, ref)
    top = max(float(np.abs(np.asarray(j)).max()) for _, _, j in pairs)
    for path, t, j in pairs:
        j = np.asarray(j, np.float64)
        scale = max(float(np.abs(j).max()), GRAD_FLOOR * top)
        err = float(np.abs(t.double().numpy() - j).max()) / scale
        assert err <= REL_F32, (what, path, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, monkeypatch):
    float32_mode(monkeypatch)
    tcfg, jcfg = torch_smoke(arch), jax_smoke(arch)
    tree = numpy_params(tcfg, 0)
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tcfg, tree,
                                                                 "cpu")
    jb, tb = batches(tcfg, jcfg)
    joc, toc = JO.OptConfig(**OC), TO.OptConfig(**OC)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb)))(jp)
    jnew, jstate, jstats = jax.jit(jax_train_step(jcfg, joc))(
        jp, JO.init_opt(jp), jb)
    tnew, tstate, tstats = make_train_step(tcfg, toc)(tp, TO.init_opt(tp),
                                                      tb)
    tloss, tgrads = loss_and_grads(tcfg, tp, tb)

    for got in (tloss, tstats["loss"]):
        assert abs(float(got) - float(jloss)) <= REL_F32 * abs(float(jloss))
    assert torch.equal(tloss, tstats["loss"])
    assert_grad_like(tgrads, jgrads, "grads")
    assert_grad_like(tstate["m"], jstate["m"], "m")
    assert_grad_like(tree_map(torch.sqrt, tstate["v"]),
                     jax.tree.map(jnp.sqrt, jstate["v"]), "sqrt v")
    for k in ("grad_norm", "lr"):
        assert abs(float(tstats[k]) - float(jstats[k])) <= \
            REL_F32 * abs(float(jstats[k])), k
    # the step is the port's AdamW on the port's gradients, bit for bit
    own, own_state, _ = TO.adamw_update(toc, tgrads, TO.init_opt(tp), tp)
    assert_trees_bitwise(tnew, own, "params")
    assert_trees_bitwise(tstate, own_state, "opt_state")
    # the update on the reference's gradients gives its new params
    ref_grads = params_from_numpy(tcfg, jax.tree.map(np.asarray, jgrads),
                                  "cpu")
    upd, _, _ = TO.adamw_update(toc, ref_grads, TO.init_opt(tp), tp)
    for path, t, j in leaf_pairs(upd, jnew):
        assert leaf_rel(t, j) <= REL_ADAMW, (path, leaf_rel(t, j))


def _jax_paths(tree):
    return [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_order_flatten(arch):
    """``tree_leaves_with_path`` gives ``tree_flatten_with_path``'s
    names and order on the param tree and on the plain, mixed and
    compressed optimizer states (shapes from ``jax.eval_shape`` and the
    meta device)."""
    tcfg, jcfg = torch_smoke(arch), jax_smoke(arch)
    jshape = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    tp = TM.init_params(tcfg, device="meta")
    trees = {
        "params": (tp, jshape),
        "opt": (TO.init_opt(tp), jax.eval_shape(JO.init_opt, jshape)),
        "mixed": (TO.init_opt_mixed(tp),
                  jax.eval_shape(JO.init_opt_mixed, jshape)),
        "ef": ({**TO.init_opt(tp), "ef": tp},
               {**jax.eval_shape(JO.init_opt, jshape), "ef": jshape}),
        "checkpoint": ((tp, TO.init_opt(tp)),
                       (jshape, jax.eval_shape(JO.init_opt, jshape))),
    }
    for what, (t, j) in trees.items():
        got = tree_leaves_with_path(t)
        assert [p for p, _ in got] == _jax_paths(j), what
        shapes = [tuple(x.shape) for x in jax.tree.leaves(j)]
        assert [tuple(x.shape) for _, x in got] == shapes, what
    # the port's own order differs where dict keys are out of order
    if arch == "deepseek-7b":
        assert [id(x) for x in tree_leaves(tp)] != \
            [id(x) for _, x in tree_leaves_with_path(tp)]
