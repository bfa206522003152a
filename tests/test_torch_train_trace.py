"""Four training steps in both packages, on the CPU: deepseek-7b-smoke and
mamba2-2.7b-smoke, plain, with int8 gradient compression and mixed
precision.  Both packages train on the reference corpus's batches
(``repro.data.pipeline.SyntheticCorpus``, as numpy), from the same
``numpy_params`` weights; the reference's step runs under ``jax.jit``.

* **float32 mode**: the loss trace to ``REL_F32 = 1e-5`` relative, step
  by step (largest seen: 2.4e-7).
* **bfloat16 mode** (the models' default): both packages round the same
  bf16 products, but a different summation order moves a bf16 value by
  an ulp (2^-8), and the steps carry it on: the trace is held to
  ``REL_BF16 = 1e-2`` relative (largest seen: 5.6e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JCorpus
from repro.runtime import optim as JO
from repro.runtime.steps import make_train_step as jax_train_step
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.models import numpy_params, params_from_numpy
from repro_torch.models.blocks import tree_map
from repro_torch.runtime import optim as TO
from repro_torch.runtime.steps import make_train_step
from torch_port_support import float32_mode

REL_F32 = 1e-5
REL_BF16 = 1e-2
STEPS = 4
OC = dict(lr=1e-3, warmup_steps=1, total_steps=10)


def traces(arch, variant):
    tcfg, jcfg = torch_smoke(arch), jax_smoke(arch)
    tree = numpy_params(tcfg, 0)
    corpus = JCorpus(JDataConfig(2, 32, jcfg.vocab))
    tokens = [np.array(corpus.batch(s)["tokens"]) for s in range(STEPS)]
    kw = dict(compress_grads=variant == "compress", mixed=variant == "mixed")
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tcfg, tree, "cpu")
    if kw["mixed"]:
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        tp = tree_map(lambda x: x.to(torch.bfloat16), tp)
        jo, to = JO.init_opt_mixed(jp), TO.init_opt_mixed(tp)
    else:
        jo, to = JO.init_opt(jp), TO.init_opt(tp)
    jstep = jax.jit(jax_train_step(jcfg, JO.OptConfig(**OC), **kw))
    tstep = make_train_step(tcfg, TO.OptConfig(**OC), **kw)
    jl, tl = [], []
    for t in tokens:
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(t)})
        tp, to, tm = tstep(tp, to, {"tokens": torch.from_numpy(t)})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    if kw["compress_grads"]:
        assert "ef" in to and "ef" in jo
    return np.array(tl), np.array(jl)


@pytest.mark.parametrize("variant", ["plain", "compress", "mixed"])
@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-2.7b"])
@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_four_step_loss_trace(mode, arch, variant, monkeypatch):
    if mode == "float32":
        float32_mode(monkeypatch)
    got, want = traces(arch, variant)
    assert np.isfinite(got).all()
    rel = np.abs(got - want) / np.abs(want)
    bound = REL_F32 if mode == "float32" else REL_BF16
    assert rel.max() <= bound, (got, want, rel)
