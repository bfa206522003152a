"""codeqwen1.5-7b [dense]: 32L d_model=4096 32H (GQA kv=32) d_ff=13440
vocab=92416 — qwen1.5 architecture.  [hf:Qwen/CodeQwen1.5-7B; hf]
"""

from repro_torch.models import ModelConfig, dense_stacks

ARCH = "codeqwen1.5-7b"
FAMILY = "dense"
SKIP_SHAPES = {"long_500k": "full attention (quadratic); needs "
                            "sub-quadratic attention per assignment"}


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
        vocab=92416, head_dim=128,
        stacks=dense_stacks(32),
        full_attention=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, head_dim=16,
        stacks=dense_stacks(2),
        full_attention=True,
    )
