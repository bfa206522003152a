from repro_torch.kernels.attn_decode.kernel import (attn_decode,
                                                    attn_decode_plain,
                                                    slot_positions)

__all__ = ["attn_decode", "attn_decode_plain", "slot_positions"]
