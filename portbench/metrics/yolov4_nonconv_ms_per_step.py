"""Device milliseconds a step of the detector layer's operations outside
YOLOv4's convolutions (`_yolov3.split_s`): K7 with leaky ReLU and Mish,
the SPP pools, the route concats, upsample, decode, NMS."""

from portbench.metrics.yolov3_nonconv_ms_per_step import read  # noqa: F401
