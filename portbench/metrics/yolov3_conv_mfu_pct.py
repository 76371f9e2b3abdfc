"""YOLOv3's convolutions against the card's float32 peak: their FLOPs a
call (the driver's `conv_flops_per_call`, 2 x multiply-adds of the 75
convs from reference/yolov3's layer list, gray input) over the device
time of the conv kernels a call (`_yolov3.is_conv`) x 67 TFLOP/s."""

from portbench.metrics._yolov3 import split_s
from portbench.peaks import F32_FLOPS


def read(rec):
    flops = rec.get("conv_flops_per_call")
    conv, _ = split_s(rec)
    calls = rec.get("calls", 0)
    if not flops or not calls or conv <= 0:
        return None
    return flops * calls / (conv * F32_FLOPS) * 100.0
