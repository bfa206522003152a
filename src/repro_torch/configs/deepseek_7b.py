"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama architecture.  [arXiv:2401.02954; hf]
"""

from repro_torch.models import ModelConfig, dense_stacks

ARCH = "deepseek-7b"
FAMILY = "dense"
SKIP_SHAPES = {"long_500k": "full attention (quadratic); needs "
                            "sub-quadratic attention per assignment"}


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
        vocab=102400, head_dim=128,
        stacks=dense_stacks(30),
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
