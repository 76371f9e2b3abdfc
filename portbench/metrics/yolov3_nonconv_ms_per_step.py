"""Device milliseconds a step of the detector layer's operations outside
YOLOv3's convolutions (`_yolov3.is_conv`): BatchNorm, leaky ReLU and the
shortcut adds of models/yolo, upsample and concat, decode, NMS."""

from portbench.metrics._ops import steps
from portbench.metrics._yolov3 import split_s


def read(rec):
    n = steps(rec)
    conv, other = split_s(rec)
    if not n or conv <= 0 or other <= 0:
        return None
    return other / n * 1e3
