"""The published Zamba2 (``repro_torch.configs.zamba2_7b_instruct``) on
the CPU at its smoke size, against the plain reference
``chipbench/reference/zamba2.py`` on the reference's seeded weights:

* the forward logits;
* prefill, then decoding through the hybrid cache (SSM and conv states
  beside the sites' K/V), at every position against the reference's
  full forward;
* each of three planted faults (one site's adapter dropped, the gated
  norm over the whole row, the attention scale hd^-0.5) fails;
* the reference against ``transformers``' ``Zamba2ForCausalLM`` with the
  same weights copied in, which ties it to the published code.
"""

import copy
import dataclasses
import functools
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench.drivers import zamba2_decode as ZD  # noqa: E402
from chipbench.reference import zamba2 as R  # noqa: E402
from repro_torch.configs import zamba2_7b_instruct as Z  # noqa: E402
from repro_torch.models import layers, model as M  # noqa: E402
from repro_torch.runtime.steps import (make_decode_step,  # noqa: E402
                                       make_prefill_step)

#: the published configuration's keys at the smoke config's sizes
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "attention_head_dim": 32,
        "attention_hidden_size": 128, "intermediate_size": 128,
        "ffn_hidden_size": 128, "vocab_size": 256, "mamba_d_state": 16,
        "n_mamba_heads": 8, "mamba_headdim": 16, "kv_channels": 16,
        "num_query_groups": 4, "adapter_rank": 8,
        "layers_block_type": ["mamba", "hybrid"] * 3 + ["mamba"],
        "hybrid_layer_ids": [1, 3, 5], "num_hidden_layers": 7}
#: positions of the test sequences; prefill takes the first P
S, P = 20, 12


def tiny_config() -> dict:
    cfg = json.loads((ROOT / "chipbench/configs/zamba2-7b-instruct.json")
                     .read_text())
    cfg.update(copy.deepcopy(TINY), name=Z.ARCH + "-smoke")
    return cfg


@pytest.fixture
def float32_port(monkeypatch):
    """The port computing in float32 (its weights are float32; the cast
    at each use then keeps them); caches stay bf16."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(M, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    d = R.dims(cfg)
    W = R.make_weights(d, 5, "cpu")
    tokens = torch.randint(1, d["vocab"], (2, S),
                           generator=torch.Generator().manual_seed(3))
    want = [R.logits_at(W, tokens[r], 0, d) for r in range(2)]
    return cfg, d, W, tokens, torch.stack(want)


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def test_the_tiny_published_config_is_the_smoke_config():
    assert ZD.model_config(tiny_config()) == Z.smoke_config()
    cfg = Z.smoke_config()
    assert [s % cfg.shared.n_blocks for s in range(len(cfg.shared.sites))] \
        == [0, 1, 0] and cfg.ssm.n_groups == 2


def test_the_port_draws_the_published_ssm_init():
    cfg = Z.smoke_config()
    assert cfg.ssm.dt_limits == Z.config().ssm.dt_limits
    p = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mixer = p["stacks"][0][0]["mixer"]
    H = cfg.ssm.n_heads
    assert torch.equal(mixer["A_log"][0], torch.log(torch.arange(
        1, H + 1, dtype=torch.float32)))
    dt = torch.nn.functional.softplus(mixer["dt_bias"])
    lo, hi, floor = cfg.ssm.dt_limits
    assert float(dt.min()) >= min(lo, floor) * (1 - 1e-5)
    assert float(dt.max()) <= hi * (1 + 1e-5)
    assert torch.equal(mixer["D"], torch.ones_like(mixer["D"]))


def _forward(cfg, d, W, tokens, edit=None):
    params = ZD.port_params(cfg, W)
    if edit is not None:
        params = edit(params)
    logits, _, _ = M.forward(cfg, params, tokens)
    return logits


def test_forward_logits(tiny, float32_port):
    cfg_file, d, W, tokens, want = tiny
    got = _forward(ZD.model_config(cfg_file), d, W, tokens)
    # float32 on both sides: the port's chunked SSD against the
    # reference's sequential recurrence, and other orders of the float32
    # sums (measured 2.8e-6 of the largest logit)
    assert _rel(got, want) < 1e-5


#: decode against the reference's full forward, relative to the largest
#: logit: with float32 caches the path is exact to float32's sums
#: (measured 3.1e-6); with the bf16 K/V and conv caches that serving
#: keeps, to bf16's grain, which compounds over the steps (measured
#: 1.1e-2 to 3.4e-2 over seven steps)
CACHE_TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 6e-2}


@pytest.mark.parametrize("cache_dtype", list(CACHE_TOLERANCE),
                         ids=["f32", "bf16"])
def test_prefill_then_decode_through_the_hybrid_cache(tiny, float32_port,
                                                      monkeypatch,
                                                      cache_dtype):
    cfg_file, d, W, tokens, want = tiny
    cfg = ZD.model_config(cfg_file)
    params = ZD.port_params(cfg, W)
    monkeypatch.setattr(M, "init_caches", functools.partial(
        M.init_caches, dtype=cache_dtype))
    logits, caches = make_prefill_step(cfg, cache_len=S)(
        params, {"tokens": tokens[:, :P]})
    n_sites = len(cfg.shared.sites)
    assert len(caches) == 2 and caches[1]["k"].shape[:2] == (n_sites, 2)
    assert caches[1]["k"].dtype == cache_dtype
    assert caches[0][0]["ssm"].dtype == torch.float32
    got = [logits]
    decode = make_decode_step(cfg)
    for i in range(P, S - 1):
        lg, _, caches = decode(params, caches, tokens[:, i:i + 1], i)
        got.append(lg)
    got = torch.stack(got, 1)
    assert _rel(got, want[:, P - 1:S - 1]) < CACHE_TOLERANCE[cache_dtype]


def _drop_adapter(params):
    params = copy.copy(params)
    params["shared"] = copy.deepcopy(params["shared"])
    params["shared"]["sites"]["adapter"]["w"][1].zero_()
    return params


@pytest.mark.parametrize("fault", ["adapter_dropped", "norm_whole_row",
                                   "scale_hd"])
def test_each_planted_fault_fails(tiny, float32_port, fault):
    """Each fault moves the forward logits by far more than the decode
    test's bf16 tolerance (6e-2): measured 0.63 (adapter), 0.91 (norm)
    and 0.55 (scale) of the largest logit."""
    cfg_file, d, W, tokens, want = tiny
    cfg = ZD.model_config(cfg_file)
    edit = None
    if fault == "adapter_dropped":
        edit = _drop_adapter
    elif fault == "norm_whole_row":
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, group_norm=False))
    else:
        cfg = dataclasses.replace(cfg, shared=dataclasses.replace(
            cfg.shared, attn_scale=None))
    assert _rel(_forward(cfg, d, W, tokens, edit), want) > 0.1


def _hf_model(cfg_file, d, W):
    """``Zamba2ForCausalLM`` of the tiny configuration holding ``W``."""
    tr = pytest.importorskip("transformers")
    keys = ("hidden_size", "num_attention_heads", "num_key_value_heads",
            "intermediate_size", "vocab_size", "mamba_d_state",
            "mamba_d_conv", "mamba_expand", "mamba_ngroups", "n_mamba_heads",
            "num_mem_blocks", "adapter_rank", "use_mem_rope", "rope_theta",
            "rms_norm_eps", "time_step_min", "time_step_max",
            "time_step_floor", "use_conv_bias", "add_bias_linear",
            "hidden_act", "use_shared_attention_adapter", "chunk_size",
            "layers_block_type", "max_position_embeddings")
    hc = tr.Zamba2Config(**{k: cfg_file[k] for k in keys},
                         num_hidden_layers=len(cfg_file["layers_block_type"]))
    hc._attn_implementation = "eager"
    m = tr.Zamba2ForCausalLM(hc).eval()
    sites = {layer: s for s, layer in enumerate(d["sites"])}

    def put(param, value):
        assert param.shape == value.shape, (param.shape, value.shape)
        param.data.copy_(value)

    net = m.model
    put(net.embed_tokens.weight, W["embed"])
    put(m.lm_head.weight, W["embed"])
    put(net.final_layernorm.weight, W["final_norm"])
    for i, layer in enumerate(net.layers):
        mamba = layer.mamba_decoder if i in sites else layer
        mx = mamba.mamba
        put(mamba.input_layernorm.weight, W["ln"][i])
        put(mx.in_proj.weight, W["in_proj"][i].t())
        put(mx.conv1d.weight, W["conv_w"][i].t()[:, None, :])
        put(mx.conv1d.bias, W["conv_b"][i])
        for n in ("A_log", "dt_bias", "D"):
            put(getattr(mx, n), W[n][i])
        put(mx.norm.weight, W["norm"][i])
        put(mx.out_proj.weight, W["out_proj"][i].t())
        if i not in sites:
            continue
        s = sites[i]
        b = s % d["n_blocks"]
        put(layer.linear.weight, W["linear"][s].t())
        st = layer.shared_transformer
        assert st.block_id == b
        put(st.input_layernorm.weight, W["ln1"][b])
        put(st.pre_ff_layernorm.weight, W["ln2"][b])
        for n in ("q", "k", "v", "o"):
            put(getattr(st.self_attn, f"{n}_proj").weight,
                W[f"w{n}"][b].t())
        ff = st.feed_forward
        put(ff.gate_up_proj.weight, torch.cat([W["gate"][b], W["up"][b]],
                                              1).t())
        put(ff.down_proj.weight, W["down"][b].t())
        ad = ff.gate_up_proj_adapter_list[s]
        put(ad[0].weight, W["adapter"][s].t())
        put(ad[1].weight, torch.cat([W["adapter_gate"][s],
                                     W["adapter_up"][s]], 1).t())
    return m


def test_the_reference_is_the_published_model(tiny):
    cfg_file, d, W, tokens, want = tiny
    m = _hf_model(cfg_file, d, W)
    with torch.no_grad(), R.exact_float32():
        got = m(input_ids=tokens, use_cache=False).logits
    # float32 on both sides: Hugging Face's chunked SSD (its plain path
    # on the CPU) against the sequential recurrence, and other orders of
    # the float32 sums (measured 2.7e-6 of the largest logit)
    assert _rel(got, want) < 1e-5
