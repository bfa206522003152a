"""The port's LM serving entry point: the configs registry, the runtime
steps, ``lm_generate`` and ``serve --arch``, against the reference on
the CPU.

``lm_generate`` is held against a loop written here over the reference's
``make_prefill_step`` / ``make_decode_step`` (the reference CLI's loop),
with the same prompts and weights (``numpy_params``), in float32 mode
(``COMPUTE_DTYPE`` monkeypatched in both packages): every step's logits
agree to ``max|a - b| <= 1e-3 * max|b|`` and the greedy ids are equal.
The float32 logits of one step on the same caches agree to 1e-5
(``tests/test_torch_lm_model.py``); here each package decodes through its
own bfloat16 caches (``init_caches``' default), whose entries agree to
one bf16 ulp (2^-8) and may round apart, so a step reads caches that
differ in a few entries.  The largest error seen is 2.7e-4; bfloat16
compute (relative errors of 7e-3 to 4e-2 against the reference in
``tests/test_torch_lm_model_bf16.py``'s runs) would fail 1e-3.
"""

import argparse
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models.layers as JL
import repro.models.model as JM
import repro_torch.configs as TC
import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro.runtime import steps as jax_steps
from repro_torch.launch import serve
from repro_torch.models import numpy_params, params_from_numpy
from repro_torch.runtime import steps as torch_steps

REL = 1e-3


# ---------------------------------------------------------------- registry
def test_registry_equals_the_reference():
    assert TC.ARCHS == JC.ARCHS
    assert TC.SHAPES == JC.SHAPES
    assert TC.cells() == JC.cells()
    assert len(TC.cells()) == 40
    for arch in TC.ARCHS:
        assert TC.get_family(arch) == JC.get_family(arch)
        for shape in TC.SHAPES:
            assert TC.skip_reason(arch, shape) == JC.skip_reason(arch, shape)
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("no-such-arch")


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_config_modules_equal_the_reference(arch):
    """Each module's constants (``ARCH``, ``FAMILY``, ``SKIP_SHAPES``,
    ``WINDOW``, ``VISION_TOKENS``, ...) and its two configs; the port's
    module is ``repro_torch.configs.<the reference's file name>``."""
    tmod = TC._mod(arch)
    jmod = JC._mod(arch)
    assert tmod.__name__ == jmod.__name__.replace("repro.", "repro_torch.", 1)
    consts = {k for k in vars(jmod) if k.isupper()}
    assert consts == {k for k in vars(tmod) if k.isupper()}
    assert {"ARCH", "FAMILY", "SKIP_SHAPES"} <= consts
    for k in consts:
        assert getattr(tmod, k) == getattr(jmod, k), k
    assert repr(tmod.config()) == repr(jmod.config())
    assert repr(tmod.smoke_config()) == repr(jmod.smoke_config())


# ------------------------------------------------------------------- steps
@pytest.mark.parametrize("arch", ["internvl2-26b", "whisper-base",
                                  "deepseek-7b"])
def test_decorate_batch_matches_the_reference(arch):
    dc = argparse.Namespace(local_batch=2, seq_len=12)
    jb = jax_steps.decorate_batch(JC.get_smoke_config(arch), dc,
                                  {"tokens": jnp.zeros((2, 12), jnp.int32)})
    tb = torch_steps.decorate_batch(TC.get_smoke_config(arch), dc,
                                    {"tokens": torch.zeros(2, 12,
                                                           dtype=torch.int32)})
    assert set(tb) == set(jb)
    for k in jb:
        assert tuple(tb[k].shape) == jb[k].shape
        assert str(tb[k].dtype).removeprefix("torch.") == str(jb[k].dtype)
        assert not np.asarray(tb[k].float()).any()


def _reference_generate(cfg, params, batch, gen):
    """The reference CLI's loop (``repro.launch.serve.main``, ``--arch``),
    unjitted, returning every step's logits and the ids."""
    B, S = batch["tokens"].shape
    prefill = jax_steps.make_prefill_step(
        cfg, cache_len=S + gen + cfg.vision_tokens)
    decode = jax_steps.make_decode_step(cfg)
    logits, caches = prefill(params, batch)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    out, all_logits = [tok], [logits]
    for i in range(gen - 1):
        pos = jnp.asarray(S + cfg.vision_tokens + i, jnp.int32)
        logits, tok, caches = decode(params, caches, tok, pos)
        tok = tok[:, None]
        out.append(tok)
        all_logits.append(logits)
    return all_logits, np.asarray(jnp.concatenate(out, 1))


@pytest.mark.parametrize("arch", ["deepseek-7b", "gemma3-4b", "mamba2-2.7b",
                                  "whisper-base", "internvl2-26b",
                                  "qwen2-moe-a2.7b"])
def test_lm_generate_matches_the_reference_loop(arch, monkeypatch):
    """B = 2 prompts of 12 ids, 9 tokens generated; gemma3's sliding
    window (16 in its smoke config) wraps during the decode."""
    for mod in (JL, JM):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (TL, TM):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    tcfg, jcfg = TC.get_smoke_config(arch), JC.get_smoke_config(arch)
    tree = numpy_params(tcfg, 0)
    params = params_from_numpy(tcfg, tree, "cpu")
    tbatch = serve.lm_batch(tcfg, 2, 12, "cpu")
    jbatch = {k: jnp.asarray(v.float().numpy() if v.is_floating_point()
                             else v.numpy()).astype(
                                 jnp.bfloat16 if v.is_floating_point()
                                 else jnp.int32)
              for k, v in tbatch.items()}
    g = serve.lm_generate(tcfg, params, tbatch, 9, "cpu")
    want_logits, want_ids = _reference_generate(
        jcfg, jax.tree.map(jnp.asarray, tree), jbatch, 9)
    assert g.tokens.dtype == torch.int32 and g.tokens.shape == (2, 9)
    assert len(g.logits) == len(want_logits) == 9
    for step, (a, b) in enumerate(zip(g.logits, want_logits)):
        a, b = a.numpy(), np.asarray(b)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= REL, (step, err)
    np.testing.assert_array_equal(g.tokens.numpy(), want_ids)
    assert g.prefill_s > 0 and g.decode_s > 0


def test_lm_batch_is_seeded_and_device_independent():
    cfg = TC.get_smoke_config("internvl2-26b")
    a, b = serve.lm_batch(cfg, 3, 7, "cpu"), serve.lm_batch(cfg, 3, 7, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert int(a["tokens"].max()) < cfg.vocab
    assert a["vision_embeds"].shape == (3, cfg.vision_tokens, cfg.d_model)


# --------------------------------------------------------------------- CLI
def test_cli_arch_smoke_on_the_cpu(capsys):
    assert serve.main(["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: 2x8 in ") and "tok/s" in out[0]
    assert out[1].startswith("decode:  3 steps in ") and "tok/s" in out[1]
    assert out[2].startswith("sample token ids: [")
    assert len(eval(out[2].split(":", 1)[1])) == 4


def test_cli_arch_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "deepseek-7b", "--smoke"])


def test_cli_without_arch_or_demo_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as e:
        serve.main([])
    assert e.value.code == 2
    assert "--arch is required unless --overlay-demo is given" in \
        capsys.readouterr().err


def test_runtime_package_imports():
    assert importlib.import_module("repro_torch.runtime").__doc__
