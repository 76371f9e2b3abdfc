"""Device operations (kernels, copies, sets) launched inside the serving
call, per step: the host's dispatch work."""

from portbench.metrics._ops import steps


def read(rec):
    n = steps(rec)
    if not n or not rec.get("launches"):
        return None
    return rec["launches"] / n
