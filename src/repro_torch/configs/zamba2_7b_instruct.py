"""Zamba2-7B-Instruct [hybrid] as published: 81 Mamba2 layers, and two
SHARED transformer blocks re-applied in turn at 13 of them (weights
time-multiplexed over 13 call sites — the paper's TM-FU idea at the
scale of a model).  [https://huggingface.co/Zyphra/Zamba2-7B-Instruct
config.json; arXiv:2411.15242]

81L d_model=3584; Mamba2 d_inner=7168, 112 heads of 64, d_state=64,
n_groups=2 (gated norm per group), d_conv=4 with bias; shared blocks on
concat(h, embedding) (7168 wide): 32 heads of 224 (kv 32), softmax scale
(224/2)^-0.5, RoPE, GELU-gated MLP 14336 with a per-site rank-128
adapter on gate and up, and a per-site 3584x3584 ``linear``; vocab 32000,
head tied to the embedding, embedding unscaled, rms_norm_eps 1e-5.

Not in the registry (``configs.ARCHS`` is held equal to the JAX
reference's): ``zamba2-7b`` there is the reference's stand-in.
"""

from repro_torch.models import (BlockSpec, ModelConfig, SharedBlocks,
                                SSMDims, StackSpec)

ARCH = "zamba2-7b-instruct"
FAMILY = "hybrid"

#: the published ``layers_block_type``: a shared block runs before the
#: Mamba layer of each "hybrid" entry
LAYERS_BLOCK_TYPE = (["mamba"] * 6 + ["hybrid"] + ["mamba"] * 4
                     + (["hybrid"] + ["mamba"] * 5) * 11 + ["hybrid"]
                     + ["mamba"] * 3)
#: ``time_step_min``, ``time_step_max``, ``time_step_floor``
DT_LIMITS = (0.001, 0.1, 1e-4)


def hybrid_model(name: str, layers_block_type, *, d_model: int,
                 n_heads: int, d_ff: int, vocab: int, d_state: int,
                 ssm_head_dim: int, n_groups: int, n_blocks: int,
                 adapter_rank: int, norm_eps: float = 1e-5,
                 rope_theta: float = 10000.0) -> ModelConfig:
    """A Zamba2 model: one Mamba2 layer an entry of ``layers_block_type``,
    a shared block before each "hybrid" one; attention head dim
    ``2 d_model / n_heads``, its logits scaled by ``(hd / 2)^-0.5``."""
    hd = 2 * d_model // n_heads
    sites = tuple(i for i, t in enumerate(layers_block_type)
                  if t == "hybrid")
    return ModelConfig(
        name=name, d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=d_ff, vocab=vocab, head_dim=hd,
        stacks=(StackSpec(len(layers_block_type), (BlockSpec("mamba"),)),),
        rope_theta=rope_theta, norm_eps=norm_eps,
        ssm=SSMDims(d_model=d_model, d_state=d_state, d_conv=4, expand=2,
                    head_dim=ssm_head_dim, n_groups=n_groups,
                    group_norm=True, dt_limits=DT_LIMITS),
        shared=SharedBlocks(sites=sites, n_blocks=n_blocks,
                            adapter_rank=adapter_rank,
                            attn_scale=(hd / 2) ** -0.5),
        tie_embed=True, embed_scale=False, full_attention=False)


def config() -> ModelConfig:
    return hybrid_model(ARCH, LAYERS_BLOCK_TYPE, d_model=3584, n_heads=32,
                        d_ff=14336, vocab=32000, d_state=64,
                        ssm_head_dim=64, n_groups=2, n_blocks=2,
                        adapter_rank=128)


def smoke_config() -> ModelConfig:
    """Three sites (blocks 0, 1, 0: both blocks, and one block at two
    sites with two adapters), two SSM groups, every mechanism on."""
    return hybrid_model(ARCH + "-smoke", ["mamba", "hybrid"] * 3 + ["mamba"],
                        d_model=64, n_heads=4, d_ff=128, vocab=256,
                        d_state=16, ssm_head_dim=16, n_groups=2,
                        n_blocks=2, adapter_rank=8)
