"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

O(1) decode state => long_500k runs trivially.
"""

from repro_torch.models import (BlockSpec, ModelConfig, SSMDims,
                                StackSpec)

ARCH = "mamba2-2.7b"
FAMILY = "ssm"
SKIP_SHAPES: dict[str, str] = {}


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=50280, head_dim=1,
        ssm=SSMDims(d_model=2560, d_state=128, d_conv=4, expand=2,
                    head_dim=64, n_groups=1),
        stacks=(StackSpec(64, (BlockSpec("mamba"),)),),
        full_attention=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=256, head_dim=1,
        ssm=SSMDims(d_model=64, d_state=16, d_conv=4, expand=2,
                    head_dim=16, n_groups=1),
        stacks=(StackSpec(3, (BlockSpec("mamba"),)),),
        full_attention=False,
    )
