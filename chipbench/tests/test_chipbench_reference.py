"""The plain references agree with the port on the CPU at small sizes:
the nine DFGs with the port's plain executor, bit for bit, and the
dense LM with the port's model in float32."""

import pytest
import torch

from chipbench.tests.support import tiny_cell


def test_nine_dfgs_bit_for_bit():
    from chipbench.drivers import overlay_common as C
    from chipbench.reference import dfg as R
    from repro_torch.core import vm
    from repro_torch.core.overlay import Overlay
    cfg = tiny_cell("tmfu-paper9.bulk").config
    kernels = C.build_kernels(cfg)
    pools = C.input_pools(cfg, 5, 1, 384)
    ov = Overlay(device="cpu")
    bank = ov.load_many(kernels, capacity=len(kernels))
    outs = ov.dispatch(bank, [(k, pools[i][0])
                              for i, k in enumerate(kernels)])
    for i, (k, name) in enumerate(zip(kernels, cfg["kernel_order"])):
        want = R.evaluate(cfg["kernels"][name], pools[i][0])
        ctx = ov.load(k)
        plain = vm.vm_exec(ctx.tree(), ctx.out_idx, vm.pad_inputs(
            [torch.from_numpy(x) for x in pools[i][0]], device="cpu"))
        for got, p, w in zip(outs[i], plain, want):
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert R.ulp_distance(got, w) == 0, name
            assert R.ulp_distance(p.numpy(), w) == 0, name
        # the control rounds every node to bfloat16 and is far off
        ctl = R.evaluate(cfg["kernels"][name], pools[i][0], R.to_bfloat16)
        assert R.ulp_distance(ctl[0], want[0]) > 1000


@pytest.fixture
def float32_port(monkeypatch):
    """The port's model computing in float32 (its weights are float32;
    the cast at each use then keeps them)."""
    from repro_torch.models import layers, model
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(model, "COMPUTE_DTYPE", torch.float32)


def _tiny():
    from chipbench.drivers import lm_common as L
    from chipbench.reference import dense_lm as R
    cfg = tiny_cell("deepseek-7b.decode").config
    d = R.dims(cfg)
    W = R.make_weights(d, 9, "cpu")
    params = L.port_params(L.model_config(cfg), W)
    tokens = torch.from_numpy(L.token_rows(9, 1, 2, 24, d["vocab"], {
        "median": 8, "sigma": 1.0, "min_len": 2, "max_len": 64,
        "zipf": 1.1}))
    return L, R, cfg, d, W, params, tokens


def test_dense_lm_forward_and_loss(float32_port):
    from repro_torch.models import model as M
    L, R, cfg, d, W, params, tokens = _tiny()
    mcfg = L.model_config(cfg)
    logits, _, _ = M.forward(mcfg, params, tokens)
    with R.exact_float32():
        want = R.hidden(W, tokens, d, R.matmul("float32")) @ W["head"]
    scale = want.abs().max()
    assert float((logits - want).abs().max() / scale) < 1e-5
    got = M.loss_fn(mcfg, params, {"tokens": tokens})
    ref = R.loss(W, tokens, d, R.matmul("float32"))
    assert abs(float(got) - float(ref)) < 1e-5 * float(ref)


def test_dense_lm_decode_through_the_cache(float32_port):
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    L, R, cfg, d, W, params, tokens = _tiny()
    mcfg = L.model_config(cfg)
    P, G = 16, 4
    logits, caches = make_prefill_step(mcfg, cache_len=P + G)(
        params, {"tokens": tokens[:, :P]})
    got = [logits]
    decode = make_decode_step(mcfg)
    for i in range(G):
        lg, _, caches = decode(params, caches, tokens[:, P + i:P + i + 1],
                               P + i)
        got.append(lg)
    got = torch.stack(got, 1)
    for r in range(tokens.shape[0]):
        want = R.logits_at(W, tokens[r, :P + G], P - 1, d)
        # the caches stay bfloat16, so decode agrees to bf16's grain
        assert float((got[r] - want).abs().max()
                     / want.abs().max()) < 2e-2
