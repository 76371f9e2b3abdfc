"""Published peaks of the card the cells run on, and the operation counts
the per-layer shares divide by them.

NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 67 TFLOP/s
float32 outside the tensor cores (the program runs float32 with TF32
off), 3.35 TB/s of HBM bandwidth.
"""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def roofline_pct(bytes_moved: float, seconds: float) -> float | None:
    """Share of the bandwidth bound: the time the bytes need at peak over
    the time taken, in %."""
    if not seconds or seconds <= 0 or not bytes_moved:
        return None
    return bytes_moved / HBM_BYTES_PER_S / seconds * 100.0
