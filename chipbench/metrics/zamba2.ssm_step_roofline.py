"""The Mamba mixers' share of their HBM bound: a step's bf16 mixer
weights once and its SSM and conv states read and written once
(``_zamba2_arith.ssm_step_bytes``) at the HBM peak, over the device time
a step under the range ``decode.ssm_step``."""

from chipbench.metrics import _arith
from chipbench.metrics._ranges import range_ms


def read(rec):
    ms, need = range_ms(rec, ("decode.ssm_step",), "steps"), \
        rec.counters.get("ssm_step_bytes")
    if not ms or not need:
        return None
    return 100.0 * need / _arith.PEAK_HBM_BYTES / (ms / 1e3)
