"""The Mamba2 decode-step kernels (``repro_torch.kernels.ssm_decode``).

On the CPU: the decode step takes its plain version and builds nothing;
the input check refuses what the kernels do not take.

On a card (``cuda`` marker, skipped without one): the step kernel and the
norm kernel against their plain versions (``models.ssm._step_plain``,
``models.layers.rms_norm``) run on the same inputs, the activations
widened to float32 (the conv state keeps its type, in which the conv
runs), within ``kernel.tolerance``, at Zamba2-7B's widths (two SSM groups, the
gated norm per group, dt floored) and mamba2-2.7b's (one group, N 128,
the norm over the row), with bf16 and float32 activations and caches; the
new conv state is the plain version's bit for bit.
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels.ssm_decode import kernel as K
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

#: Zamba2-7B's mixer, and mamba2-2.7b's
DIMS = {"zamba2": S.SSMDims(d_model=3584, d_state=64, n_groups=2,
                            group_norm=True, dt_limits=(0.001, 0.1, 1e-4)),
        "mamba2": S.SSMDims(d_model=2560, d_state=128)}
#: their models' ``norm_eps``, which the gated norm takes
EPS = {"zamba2": 1e-5, "mamba2": 1e-6}


def inputs(dims, B, act, cache, seed=0, device="cpu"):
    """A mixer's params (the published init where ``dt_limits`` is set,
    random conv weights and gains), one token's in-projection and a
    layer's caches."""
    g = torch.Generator().manual_seed(seed)
    init = L.Init.torch(g, torch.device("cpu"))
    p = S.init_mamba2(init, (), dims)
    p["conv_b"] = torch.randn(p["conv_b"].shape, generator=g) * 0.1
    p["norm"]["g"] = 1 + 0.1 * torch.randn(p["norm"]["g"].shape,
                                           generator=g)
    din, N, G, H = dims.d_inner, dims.d_state, dims.n_groups, dims.n_heads
    C = din + 2 * G * N
    proj = torch.randn(B, din + C + H, generator=g).to(act)
    conv = torch.randn(B, dims.d_conv - 1, C, generator=g).to(cache)
    ssm = torch.randn(B, H, N, dims.head_dim, generator=g)
    p = {k: v.to(device) if torch.is_tensor(v) else
         {kk: vv.to(device) for kk, vv in v.items()} for k, v in p.items()}
    return p, proj.to(device), conv.to(device), ssm.to(device)


def test_a_cpu_step_takes_the_plain_version():
    dims = dataclasses.replace(DIMS["zamba2"], d_model=64, d_state=16,
                               head_dim=16)
    p, proj, conv, ssm = inputs(dims, 2, torch.bfloat16, torch.bfloat16)
    K.reset_launch_counts()
    got = S._step(p, proj, conv, ssm, dims, torch.bfloat16, 1e-5)
    want = S._step_plain(p, proj, conv, ssm, dims, torch.bfloat16, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert K.launch_counts == {"ssm_decode_step": 0, "rms_norm": 0}
    assert K._lib is None or torch.cuda.is_available()


@pytest.mark.parametrize("bad", ["proj_width", "ssm_type", "conv_w_shape"])
def test_the_check_refuses_what_the_kernel_does_not_take(bad):
    dims = dataclasses.replace(DIMS["zamba2"], d_model=64, d_state=16,
                               head_dim=16)
    p, proj, conv, ssm = inputs(dims, 2, torch.bfloat16, torch.bfloat16)
    if bad == "proj_width":
        proj = proj[:, 1:]
    elif bad == "ssm_type":
        ssm = ssm.to(torch.bfloat16)
    else:
        p["conv_w"] = p["conv_w"][1:]
    with pytest.raises((ValueError, TypeError)):
        K.check_step(p, proj, conv, ssm, dims)


# ------------------------------------------------------------------ on a GPU
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("types", ["bf16_bf16", "f32_bf16", "f32_f32"])
@pytest.mark.parametrize("model", list(DIMS))
def test_cuda_step_matches_plain(cuda_device, model, types):
    act, cache = (torch.bfloat16 if t == "bf16" else torch.float32
                  for t in types.split("_"))
    dims, eps = DIMS[model], EPS[model]
    p, proj, conv, ssm = inputs(dims, 16, act, cache, seed=3,
                                device=cuda_device)
    K.reset_launch_counts()
    y, conv_new, ssm_new = S._step(p, proj, conv, ssm, dims, act, eps)
    torch.cuda.synchronize()
    assert K.launch_counts["ssm_decode_step"] == 1
    # the activations widened; the conv state keeps its type, in which
    # the conv runs
    want_y, _, want_ssm = S._step_plain(
        p, proj.float(), conv, ssm, dims, torch.float32, eps)
    assert y.dtype == act and conv_new.dtype == cache
    torch.testing.assert_close(y.float(), want_y, **K.tolerance(act, want_y))
    # the shifted conv state, the new input cast to the cache's type
    want_conv = S._step_plain(p, proj, conv, ssm, dims, act, eps)[1]
    assert torch.equal(conv_new, want_conv)
    torch.testing.assert_close(ssm_new, want_ssm,
                               **K.tolerance(torch.float32, want_ssm))
    # the caches it was given are as they were
    assert torch.equal(ssm, inputs(dims, 16, act, cache, seed=3,
                                   device=cuda_device)[3])


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("act", [torch.bfloat16, torch.float32])
def test_cuda_rms_norm_matches_plain(cuda_device, act, extra):
    g = torch.Generator(cuda_device).manual_seed(5)
    x = torch.randn(16, 1, 3584, generator=g, device=cuda_device).to(act)
    e = torch.randn(16, 1, 3584, generator=g, device=cuda_device).to(act) \
        if extra else None
    gain = 1 + 0.1 * torch.randn(3584, generator=g, device=cuda_device)
    got = K.rms_norm(x, gain, 1e-5, e)
    xf = x.float() if e is None else x.float() + e.float()
    want = L.rms_norm({"g": gain}, xf, 1e-5)
    assert got.dtype == act and got.shape == x.shape
    torch.testing.assert_close(got.float(), want, **K.tolerance(act, want))


@pytest.mark.cuda
def test_cuda_stack_decode_is_the_layer_by_layer_decode(cuda_device,
                                                        monkeypatch):
    """Zamba2 at its smoke size on the card: a decode step whose Mamba
    stack runs ``MambaStack`` (two launches a layer beside the
    projections, the states written into the stacked caches) gives the
    logits and caches of the layer-by-layer path (``block_decode`` with
    the kernels a layer)."""
    from repro_torch.configs import zamba2_7b_instruct
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.models.blocks import tree_leaves
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    cfg = zamba2_7b_instruct.smoke_config()
    params = M.init_params(cfg, torch.Generator(cuda_device).manual_seed(0),
                           device=cuda_device)
    tokens = torch.randint(1, cfg.vocab, (4, 10), device=cuda_device,
                           generator=torch.Generator(cuda_device)
                           .manual_seed(1))
    _, caches = make_prefill_step(cfg, cache_len=16)(
        params, {"tokens": tokens})
    decode = make_decode_step(cfg)
    K.reset_launch_counts()
    fused, _, fused_caches = decode(params, caches, tokens[:, -1:], 10)
    torch.cuda.synchronize()
    # a norm a Mamba layer, and the shared block's two at each site
    assert K.launch_counts == {
        "ssm_decode_step": cfg.n_layers,
        "rms_norm": cfg.n_layers + 2 * len(cfg.shared.sites)}
    monkeypatch.setattr(blocks, "_stack_decode_fused", lambda *a: False)
    want, _, want_caches = decode(params, caches, tokens[:, -1:], 10)
    torch.testing.assert_close(fused.float(), want.float(),
                               **K.tolerance(fused.dtype, want.float()))
    for a, b in zip(tree_leaves(fused_caches), tree_leaves(want_caches)):
        torch.testing.assert_close(a.float(), b.float(),
                                   **K.tolerance(a.dtype, b.float()))
