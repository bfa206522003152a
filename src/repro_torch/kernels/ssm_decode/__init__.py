from repro_torch.kernels.ssm_decode.kernel import (MambaStack, rms_norm,
                                                   ssm_step)

__all__ = ["MambaStack", "rms_norm", "ssm_step"]
