"""The split of the detector layer's device time that the yolov3 readers
share: the convolutions are the kernels that models/yolo launched and
that are not PyTorch's own (`at::native` in the name), i.e. cuDNN's and
CUTLASS's conv and layout kernels; everything else the detector layer
ran (BatchNorm, leaky ReLU, shortcut adds, upsample and concat, decode,
NMS, copies) is outside it."""

from portbench.tracing import layer


def is_conv(op: dict) -> bool:
    return (op["module"] == "models/yolo" and op.get("cat") == "kernel"
            and "at::native" not in op["name"])


def split_s(rec: dict) -> tuple[float, float]:
    """(conv seconds, other detector seconds) of the traced stretch."""
    conv = other = 0.0
    for o in rec.get("ops", []):
        if is_conv(o):
            conv += o["s"]
        elif layer(o["module"]) == "detector":
            other += o["s"]
    return conv, other
