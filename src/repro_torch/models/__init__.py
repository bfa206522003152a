from repro_torch.models.blocks import BlockSpec, SharedBlocks, StackSpec
from repro_torch.models.model import (EncoderSpec, ModelConfig, decode_step,
                                      dense_stacks, forward, init_caches,
                                      init_params, loss_fn, numpy_params,
                                      params_from_numpy, prefill)
from repro_torch.models.ssm import SSMDims

__all__ = ["BlockSpec", "StackSpec", "SharedBlocks", "EncoderSpec",
           "ModelConfig", "SSMDims", "dense_stacks", "forward", "init_params", "loss_fn",
           "prefill", "decode_step", "init_caches", "numpy_params",
           "params_from_numpy"]
