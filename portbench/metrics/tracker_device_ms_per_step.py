"""Device milliseconds of the operations launched by the tracker's
modules (tracker/, ops/ but ops/nms, kernels/), per step."""

from portbench.metrics._ops import device_s, steps


def read(rec):
    n = steps(rec)
    t = device_s(rec, "tracker")
    if not n or t <= 0:
        return None
    return t / n * 1e3
