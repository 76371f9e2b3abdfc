"""Device milliseconds of the operations launched by the detector's
modules (models/detector, models/yolo, ops/nms), per step."""

from portbench.metrics._ops import device_s, steps


def read(rec):
    n = steps(rec)
    t = device_s(rec, "detector")
    if not n or t <= 0:
        return None
    return t / n * 1e3
