"""The Zamba2 cell's pieces on the CPU: its configuration file builds the
port's published configuration, its arithmetic against hand counts, its
readers (None where a run has nothing to read), one tiny run through the
harness, and a program without shared blocks refused before any weight
is made."""

import copy
import sys
from types import SimpleNamespace

import pytest

from chipbench.lib.spec import load_benchmark, load_module, resolve
from chipbench.metrics import _zamba2_arith as Z
from chipbench.tests.support import ROOT, run_tiny

CELL = "zamba2-7b-instruct.decode"
#: the published keys at the port's smoke size (``zamba2_7b_instruct.
#: smoke_config``)
TINY = {"hidden_size": 64, "num_attention_heads": 4,
        "num_key_value_heads": 4, "attention_head_dim": 32,
        "attention_hidden_size": 128, "intermediate_size": 128,
        "ffn_hidden_size": 128, "vocab_size": 256, "mamba_d_state": 16,
        "n_mamba_heads": 8, "mamba_headdim": 16, "adapter_rank": 8,
        "layers_block_type": ["mamba", "hybrid"] * 3 + ["mamba"],
        "hybrid_layer_ids": [1, 3, 5], "num_hidden_layers": 7}
#: the tiny cell's limit, set as the full-size one is: above the
#: program's readings (at most 0.027 over seeds 1..6 and 2**31 + 3),
#: below the float8 control's (0.17 and more) and the three planted
#: faults' (0.15 and more) on the same seeds
TINY_LIMIT = 0.08


def tiny_cell():
    cell = resolve(load_benchmark(ROOT), CELL, ROOT)
    cell.config = copy.deepcopy(cell.config)
    cell.config.update(copy.deepcopy(TINY))
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic.update(batch=4, prompt_len=16, gen_len=6, prefill_rows=2,
                        check_rows=2, warmup_steps=2,
                        limits={"served_logit_gap": TINY_LIMIT})
    return cell


def test_the_file_builds_the_published_config():
    from chipbench.drivers.zamba2_decode import model_config
    from repro_torch.configs import zamba2_7b_instruct as P
    cell = resolve(load_benchmark(ROOT), CELL, ROOT)
    assert model_config(cell.config) == P.config()
    assert cell.config["hybrid_layer_ids"] == list(P.config().shared.sites)
    assert cell.config["reduced"] == []


def test_the_arithmetic_by_hand():
    d = load_module(ROOT / "chipbench/reference/zamba2.py").dims(
        tiny_cell().config)
    # a Mamba layer: ln 64; in_proj 64 x (2*128 + 2*2*16 + 8) = 64 x 328;
    # conv 4 x 192 + 192; A_log, dt_bias, D 3 x 8; norm 128; out 128 x 64
    mamba = 64 + 64 * 328 + 4 * 192 + 192 + 24 + 128 + 128 * 64
    assert Z.mamba_weight_elements(d) == mamba == 30_360
    # a block: ln1 128 + ln2 64; q, k, v 128 x 128; o 128 x 64; MLP 3 x
    # 64 x 128
    block = 128 + 3 * 128 * 128 + 128 * 64 + 64 + 3 * 64 * 128
    assert Z.block_weight_elements(d) == block == 82_112
    site = 64 * 8 + 2 * 8 * 128 + 64 * 64
    assert Z.site_weight_elements(d) == site == 6_656
    weights = 7 * mamba + 2 * block + 3 * site + 64 + 256 * 64
    assert Z.weight_elements(d) == weights
    from chipbench.drivers.zamba2_decode import model_config
    assert model_config(tiny_cell().config).param_count() == weights
    # FLOPs a token: a layer's projections, conv and SSM (5 H P N)
    f_mamba = 2 * 64 * 328 + 2 * 128 * 64 + 2 * 4 * 192 + 5 * 8 * 16 * 16
    # a site over 10 keys: q, k, v from 128, o, scores and AV, MLP,
    # adapter and linear
    f_site = 2 * 128 * 384 + 2 * 128 * 64 + 4 * 128 * 10 + 6 * 64 * 128 \
        + 2 * 64 * 8 + 2 * 8 * 256 + 2 * 64 * 64
    assert Z.decode_step_flops(d, 4, 9) == \
        4 * (7 * f_mamba + 3 * f_site + 2 * 64 * 256)
    # bytes: bf16 weights and 4 embedding rows; 3 sites' K/V of 9
    # positions read and one written; f32 SSM (8 x 16 x 16) and bf16 conv
    # (3 x 192) states of 7 layers, read and written
    kv = 2 * 2 * 4 * 32
    states = 2 * 7 * 4 * (4 * 8 * 16 * 16 + 2 * 3 * 192)
    assert Z.decode_step_bytes(d, 4, 9) == \
        2 * (weights + 4 * 64) + 3 * 4 * kv * 10 + states
    assert Z.ssm_step_bytes(d, 4) == 2 * 7 * mamba + states
    assert Z.attn_core_bytes(d, 4, 9) == 3 * 4 * 10 * kv


def test_the_published_sizes():
    d = load_module(ROOT / "chipbench/reference/zamba2.py").dims(
        resolve(load_benchmark(ROOT), CELL, ROOT).config)
    from repro_torch.configs import zamba2_7b_instruct as P
    assert Z.weight_elements(d) == P.config().param_count() == 7_356_749_648
    # the cell's K/V: 13 sites x 1280 positions x 2 x 32 x 224 bf16 a row
    assert Z.kv_row_bytes(d) * 13 * 1280 * 16 == 7_633_633_280


def _reader(name):
    return load_module(ROOT / "chipbench" / "metrics" / f"{name}.py").read


def _record(ranges: dict, **counters):
    trace = {"window_s": 3.0, "busy_s": 2.4,
             "range_s": {k: s for k, (s, _) in ranges.items()},
             "range_n": {k: n for k, (_, n) in ranges.items()}}
    return SimpleNamespace(trace=trace, counters=counters)


SOUND = {"decode.ssm_step": (0.6, 81 * 60), "decode.shared_block": (0.9,
                                                                     13 * 60),
         "decode.attn_core": (0.15, 13 * 60),
         "decode.cache_write": (0.06, 13 * 60),
         "decode.cache_stack": (0.3, 60), "weights.cast": (1.2, 306 * 60)}
COUNTERS = {"steps": 60, "window_s": 3.0, "flops": 4.0e13,
            "bytes": 2.0e12, "ssm_step_bytes": 6.7e9,
            "attn_kv_bytes": 4.0e11, "step_ms_p95": 52.5}
#: metric, the range it needs (None: counters only), its value by hand:
#: the cell's own readers, then the decode metrics it shares with
#: ``deepseek-7b.decode``, read from this cell's counters and ranges
READERS = [("zamba2.ssm_step_ms", "decode.ssm_step", 10.0),
           ("zamba2.shared_block_ms", "decode.shared_block", 15.0),
           ("zamba2.ssm_step_roofline", "decode.ssm_step",
            100 * 6.7e9 / 3.35e12 / 0.010),
           ("zamba2.attn_core_roofline", "decode.attn_core",
            100 * 4.0e11 / 3.35e12 / 0.15),
           ("decode.mfu", None, 100 * 4.0e13 / 3.0 / 989e12),
           ("decode_step_roofline", None, 100 * 2.0e12 / 3.35e12 / 3.0),
           ("device.idle_share.decode", None, 20.0),
           ("decode.attn_core_ms", "decode.attn_core", 2.5),
           ("decode.weight_cast_ms", "weights.cast", 20.0),
           ("decode.cache_copy_ms", "decode.cache_stack", 6.0),
           ("decode.step_ms_p95", None, 52.5)]


def test_the_cell_is_listed_on_the_decode_metrics_it_reports():
    """Every per-layer metric with a reader above lists this cell."""
    spec = load_benchmark(ROOT)
    listed = {m["name"] for m in spec["per_layer"]
              if CELL in m.get("workloads", ())}
    assert listed == {name for name, _, _ in READERS}


@pytest.mark.parametrize("name,needs,want", READERS,
                         ids=[r[0] for r in READERS])
def test_each_reader(name, needs, want):
    read = _reader(name)
    assert read(_record(SOUND, **COUNTERS)) == pytest.approx(want)
    assert read(SimpleNamespace(trace=None, counters={})) is None
    if needs is not None:
        # a program without the range: nothing to read
        rest = {k: v for k, v in SOUND.items() if k != needs}
        assert read(_record(rest, **COUNTERS)) is None


def test_a_tiny_run_through_the_harness():
    rec = run_tiny(tiny_cell())
    assert rec.correct, rec.checks
    assert rec.checks["served_logit_gap"]["limit"] == TINY_LIMIT
    c = rec.counters
    assert c["steps"] >= 1 and c["flops"] > 0 and c["attn_kv_bytes"] > 0


def test_a_program_without_shared_blocks_stops_before_any_weight(
        monkeypatch):
    """A port without the published Zamba2 (no
    ``configs/zamba2_7b_instruct.py``): the cell's driver raises at once,
    before the reference makes a weight."""
    from chipbench.drivers import zamba2_decode as D
    cell = tiny_cell()
    made = []
    ref = load_module(cell.reference_path)
    monkeypatch.setattr(ref, "make_weights",
                        lambda *a: made.append(a) or {})
    monkeypatch.setitem(sys.modules,
                        "repro_torch.configs.zamba2_7b_instruct", None)
    import torch
    with pytest.raises(ImportError):
        D.Program(cell, 1, torch.device("cpu"))
    assert made == []
