"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.models import BlockSpec, ModelConfig, StackSpec

ARCH = "phi3.5-moe-42b-a6.6b"
FAMILY = "moe"
SKIP_SHAPES = {"long_500k": "full attention (quadratic); needs "
                            "sub-quadratic attention per assignment"}


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
        vocab=32064, head_dim=128,
        n_experts=16, top_k=2, expert_d_ff=6400,
        stacks=(StackSpec(32, (BlockSpec("attn", moe=True),)),),
        full_attention=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16,
        n_experts=4, top_k=2, expert_d_ff=64,
        stacks=(StackSpec(2, (BlockSpec("attn", moe=True),)),),
        full_attention=True,
    )
