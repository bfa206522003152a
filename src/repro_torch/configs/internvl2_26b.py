"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2 backbone.  [arXiv:2404.16821; hf]

The InternViT frontend is a STUB: input_specs() provides precomputed patch
embeddings [B, vision_tokens, d_model] prepended to the text sequence.
"""

from repro_torch.models import ModelConfig, dense_stacks

ARCH = "internvl2-26b"
FAMILY = "vlm"
SKIP_SHAPES = {"long_500k": "full attention (quadratic); needs "
                            "sub-quadratic attention per assignment"}
VISION_TOKENS = 1024


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab=92553, head_dim=128,
        stacks=dense_stacks(48),
        vision_tokens=VISION_TOKENS,
        full_attention=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=16,
        stacks=dense_stacks(2),
        vision_tokens=8,
        full_attention=True,
    )
