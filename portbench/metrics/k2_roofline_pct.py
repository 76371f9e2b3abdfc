"""K2 (csrc/auction.cu `auction_kernel`) against its bandwidth bound:
every benefit matrix read once and the assignment and round counts written
once (the driver's `k2_bytes_per_call`) at 3.35 TB/s, over K2's device
time a call."""

from portbench.metrics._ops import kernel_s
from portbench.peaks import roofline_pct


def read(rec):
    t, n = kernel_s(rec, lambda name: "auction_kernel" in name)
    calls = rec.get("calls", 0)
    if not n or not calls or not rec.get("k2_bytes_per_call"):
        return None
    return roofline_pct(rec["k2_bytes_per_call"], t / calls)
