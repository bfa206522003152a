"""zamba2-7b [hybrid]: 81 Mamba2 layers + a SHARED attention block applied
every 6th position (weights time-multiplexed across 13 call sites — the
paper's TM-FU idea at the weight level).  [arXiv:2411.15242; unverified]

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.

This is the JAX reference's stand-in, held equal to it by the parity
tests: one shared block on the residual, head dim 112, one SSM group, no
adapters.  The published model (two shared blocks on concat(h,
embedding), head dim 224, per-site adapters and linears, two groups) is
``configs/zamba2_7b_instruct.py``, kept out of the registry.
"""

from repro_torch.models import (BlockSpec, ModelConfig, SSMDims,
                                StackSpec)

ARCH = "zamba2-7b"
FAMILY = "hybrid"
SKIP_SHAPES: dict[str, str] = {}   # sub-quadratic: long_500k runs


def config() -> ModelConfig:
    shared_attn = BlockSpec("attn", shared=True)
    mamba = BlockSpec("mamba")
    return ModelConfig(
        name=ARCH,
        d_model=3584, n_heads=32, n_kv_heads=32, d_ff=14336,
        vocab=32000, head_dim=112,
        ssm=SSMDims(d_model=3584, d_state=64, d_conv=4, expand=2,
                    head_dim=64, n_groups=1),
        stacks=(
            StackSpec(13, (shared_attn,) + (mamba,) * 6),  # 78 mamba
            StackSpec(1, (mamba,) * 3),                    # 81 total
        ),
        full_attention=False,
    )


def smoke_config() -> ModelConfig:
    shared_attn = BlockSpec("attn", shared=True)
    mamba = BlockSpec("mamba")
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, head_dim=16,
        ssm=SSMDims(d_model=64, d_state=16, d_conv=4, expand=2,
                    head_dim=16, n_groups=1),
        stacks=(StackSpec(2, (shared_attn,) + (mamba,) * 2),
                StackSpec(1, (mamba,))),
        full_attention=False,
    )
