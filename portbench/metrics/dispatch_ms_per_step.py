"""Host milliseconds inside the serving call (the benchmark's span around
it), per step: the time the host takes to dispatch a step."""

from portbench.metrics._ops import steps


def read(rec):
    n = steps(rec)
    if not n or not rec.get("call_host_s"):
        return None
    return sum(rec["call_host_s"]) / n * 1e3
