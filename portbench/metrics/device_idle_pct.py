"""Share of the traced window in which no kernel, copy or set ran on the
card."""


def read(rec):
    w = rec.get("window_s")
    if not w or rec.get("busy_s") is None or not rec.get("ops"):
        return None
    return (1.0 - rec["busy_s"] / w) * 100.0
