"""Shared arithmetic of the readers over the traced records."""

from portbench.tracing import layer


def steps(rec: dict) -> int:
    """Steps traced: a call steps every stream once."""
    return rec.get("calls", 0)


def device_s(rec: dict, want_layer: str) -> float:
    """Device seconds of the ops that a layer's modules launched."""
    return sum(o["s"] for o in rec.get("ops", [])
               if layer(o["module"]) == want_layer)


def kernel_s(rec: dict, match) -> tuple[float, int]:
    """Device seconds and count of the kernels whose name `match` accepts."""
    hit = [o["s"] for o in rec.get("ops", [])
           if o.get("cat") == "kernel" and match(o["name"])]
    return sum(hit), len(hit)
