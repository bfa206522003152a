"""The frozen arithmetic of the per-layer metrics against hand counts."""

from chipbench.metrics import _arith

DEEPSEEK_10 = {"d_model": 4096, "n_heads": 32, "n_kv_heads": 32,
               "head_dim": 128, "d_ff": 11008, "vocab": 102400,
               "n_layers": 10}


def test_dfg_bytes_by_hand():
    # chebyshev: 1 input, 1 output; 32768 lanes, 256 tiles of ids
    assert _arith.dfg_request_bytes(1, 1, 32768, 128) == \
        4 * 32768 + 4 * 32768 + 4 * 256 == 263168
    # gradient: 5 inputs, 1 output
    assert _arith.dfg_request_bytes(5, 1, 32768, 128) == \
        5 * 131072 + 131072 + 1024 == 787456
    # chebyshev's context: 7 op nodes, a word each
    assert _arith.dfg_context_bytes(7) == 28


def test_dense_block_flops_by_hand():
    # q, k, v: 2 x 4096 x 4096 each; o: the same; MLP: 3 x 2 x 4096 x 11008
    proj = 4 * 2 * 4096 * 4096
    mlp = 3 * 2 * 4096 * 11008
    assert proj + mlp == 404_750_336
    assert _arith.dense_block_flops(4096, 32, 32, 128, 11008, 0) == \
        404_750_336
    # scores and AV: 2 x 2 x 32 x 128 a key
    assert _arith.dense_block_flops(4096, 32, 32, 128, 11008, 1000) - \
        404_750_336 == 16384 * 1000


def test_train_step_flops_by_hand():
    per_token = 10 * (404_750_336 + 16384 * 2048) + 2 * 4096 * 102400
    assert per_token == 5_221_908_480
    assert _arith.train_step_flops(DEEPSEEK_10, 2, 4096) == \
        3 * per_token * 2 * 4095


def test_decode_step_by_hand():
    per_token = 10 * (404_750_336 + 16384 * 2049) + 2 * 4096 * 102400
    assert _arith.decode_step_flops(DEEPSEEK_10, 32, 2048) == 32 * per_token
    # weights: 202,383,360 a layer (projections, MLP, two gains), the
    # final gain and the head; 32 embedding rows
    layer = 4 * 4096 * 4096 + 3 * 4096 * 11008 + 2 * 4096
    assert layer == 202_383_360
    weights = 10 * layer + 4096 + 4096 * 102400
    assert _arith.dense_weight_elements(DEEPSEEK_10) == weights
    cache_read = 2 * 10 * 32 * 2048 * 32 * 128 * 2
    cache_write = 2 * 10 * 32 * 32 * 128 * 2
    assert _arith.decode_step_bytes(DEEPSEEK_10, 32, 2048) == \
        2 * (weights + 32 * 4096) + cache_read + cache_write
