"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned nemotron.  [arXiv:2407.14679; hf]
"""

from repro_torch.models import ModelConfig, dense_stacks

ARCH = "minitron-8b"
FAMILY = "dense"
SKIP_SHAPES = {"long_500k": "full attention (quadratic); needs "
                            "sub-quadratic attention per assignment"}


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
        vocab=256000, head_dim=128,
        stacks=dense_stacks(32),
        full_attention=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16,
        stacks=dense_stacks(2),
        full_attention=True,
    )
