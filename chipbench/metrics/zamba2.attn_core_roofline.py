"""The hd-224 decode-attention kernel's share of its byte bound: the
visible K and V rows of every site over the window's steps
(``_zamba2_arith.attn_core_bytes``) at the HBM peak, over the device time
under the range ``decode.attn_core``."""

from chipbench.metrics import _arith


def read(rec):
    t, need = rec.trace, rec.counters.get("attn_kv_bytes")
    if not t or not need or not t["range_n"].get("decode.attn_core"):
        return None
    dev = t["range_s"]["decode.attn_core"]
    if dev <= 0:
        return None
    return 100.0 * need / _arith.PEAK_HBM_BYTES / dev
