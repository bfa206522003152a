"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from repro_torch.models import BlockSpec, ModelConfig, StackSpec

ARCH = "qwen2-moe-a2.7b"
FAMILY = "moe"
SKIP_SHAPES = {"long_500k": "full attention (quadratic); needs "
                            "sub-quadratic attention per assignment"}


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
        vocab=151936, head_dim=128,
        n_experts=60, top_k=4, expert_d_ff=1408,
        n_shared_experts=4, shared_expert_d_ff=4 * 1408,
        stacks=(StackSpec(24, (BlockSpec("attn", moe=True),)),),
        full_attention=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
        vocab=256, head_dim=16,
        n_experts=6, top_k=2, expert_d_ff=32,
        n_shared_experts=2, shared_expert_d_ff=64,
        stacks=(StackSpec(2, (BlockSpec("attn", moe=True),)),),
        full_attention=True,
    )
