from repro_torch.kernels.tmfu.ops import tmfu_pipeline, tmfu_pipeline_multi
from repro_torch.kernels.tmfu.kernel import (tmfu_pipeline_rf,
                                             tmfu_pipeline_rf_multi,
                                             tmfu_pipeline_rf_multi_donated)
from repro_torch.kernels.tmfu.ref import tmfu_ref

__all__ = ["tmfu_pipeline", "tmfu_pipeline_multi", "tmfu_pipeline_rf",
           "tmfu_pipeline_rf_multi", "tmfu_pipeline_rf_multi_donated",
           "tmfu_ref"]
