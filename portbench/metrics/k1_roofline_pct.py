"""K1 (csrc/roi.cu `roi_kernel`) against its bandwidth bound: the bytes a
call needs (patches written once, covered pyramid pixels and sample
coordinates read once; the driver's `k1_bytes_per_call`) at 3.35 TB/s,
over K1's device time a call."""

from portbench.metrics._ops import kernel_s
from portbench.peaks import roofline_pct


def _is_k1(name: str) -> bool:
    return "roi_kernel" in name and "roi_scales_kernel" not in name


def read(rec):
    t, n = kernel_s(rec, _is_k1)
    calls = rec.get("calls", 0)
    if not n or not calls or not rec.get("k1_bytes_per_call"):
        return None
    return roofline_pct(rec["k1_bytes_per_call"], t / calls)
