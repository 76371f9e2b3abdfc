"""YOLOv4's convolutions against the card's float32 peak: their FLOPs a
call (the driver's `conv_flops_per_call`, 2 x multiply-adds of the 110
convs from reference/yolov4's layer list, gray input) over the device time
of the conv kernels a call (`_yolov3.is_conv`: models/yolo's kernels that
are not PyTorch's own) x 67 TFLOP/s."""

from portbench.metrics.yolov3_conv_mfu_pct import read  # noqa: F401
