"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local(sliding-window 1024):global interleave, 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]

long_500k runs: 28/34 layers are sliding-window (O(S*w)); the 6 global
layers decode against a sequence-sharded KV cache.
"""

from repro_torch.models import BlockSpec, ModelConfig, StackSpec

ARCH = "gemma3-4b"
FAMILY = "dense"
SKIP_SHAPES: dict[str, str] = {}
WINDOW = 1024


def config() -> ModelConfig:
    local = BlockSpec("attn", window=WINDOW)
    glob = BlockSpec("attn")
    return ModelConfig(
        name=ARCH,
        d_model=2560, n_heads=8, n_kv_heads=4, d_ff=10240,
        vocab=262144, head_dim=256,
        rope_theta=1_000_000.0,
        stacks=(
            StackSpec(5, (local,) * 5 + (glob,)),   # 30 layers
            StackSpec(1, (local,) * 4),             # 34 total
        ),
        full_attention=False,   # majority sliding-window
    )


def smoke_config() -> ModelConfig:
    local = BlockSpec("attn", window=16)
    glob = BlockSpec("attn")
    return ModelConfig(
        name=ARCH + "-smoke",
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, head_dim=32,
        stacks=(StackSpec(1, (local, local, glob)),
                StackSpec(1, (local,))),
        full_attention=False,
    )
