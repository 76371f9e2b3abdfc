"""The whole step's share of the card's float32 peak: the FLOPs a call
needs (the driver's `step_flops_per_call`: yolov3-tiny's convolutions, 2
x multiply-adds from its layer shapes, for every frame detected) x the
calls of the traced stretch, over its seconds x 67 TFLOP/s (float32, TF32
off, as the program runs).  A driver that runs no model reports no FLOPs,
and the metric is left out.  A kernel's roofline
can rise while this does not: a claim on one kernel stands only while the
whole step's share bounds it."""

from portbench.peaks import F32_FLOPS


def read(rec):
    flops = rec.get("step_flops_per_call")
    if not flops or not rec.get("calls") or not rec.get("window_s"):
        return None
    return flops * rec["calls"] / (rec["window_s"] * F32_FLOPS) * 100.0
