"""whisper-base [audio]: 6L enc + 6L dec, d_model=512 8H (kv=8) d_ff=2048
vocab=51865.  Enc-dec; the conv frontend is a STUB — input_specs() provides
precomputed frame embeddings [B, S, d_model].  [arXiv:2212.04356; unverified]
"""

from repro_torch.models import (BlockSpec, EncoderSpec, ModelConfig,
                                StackSpec)

ARCH = "whisper-base"
FAMILY = "audio"
SKIP_SHAPES = {"long_500k": "full attention enc-dec (quadratic); needs "
                            "sub-quadratic attention per assignment"}


def config() -> ModelConfig:
    enc = BlockSpec("attn", causal=False, use_rope=False)
    dec = BlockSpec("attn", causal=True, use_rope=False, cross=True)
    return ModelConfig(
        name=ARCH,
        d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab=51865, head_dim=64,
        stacks=(StackSpec(6, (dec,)),),
        encoder=EncoderSpec(stacks=(StackSpec(6, (enc,)),), frame_dim=512),
        use_abs_pos=True,
        full_attention=True,
    )


def smoke_config() -> ModelConfig:
    enc = BlockSpec("attn", causal=False, use_rope=False)
    dec = BlockSpec("attn", causal=True, use_rope=False, cross=True)
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, head_dim=16,
        stacks=(StackSpec(2, (dec,)),),
        encoder=EncoderSpec(stacks=(StackSpec(2, (enc,)),), frame_dim=64),
        use_abs_pos=True,
        full_attention=True,
    )
