"""K7 (models/epilogue, csrc/epilogue.cu `epilogue_kernel`) against its
bandwidth bound in the YOLOv4 cell: the bytes its launches need a call
(the driver's `epilogue_bytes_per_call`: every BatchNorm conv's output
read and written once, every shortcut operand read once, from
reference/yolov4's layer list) at 3.35 TB/s, over K7's device time a
call.  Nothing where K7 did not run."""

from portbench.metrics._ops import kernel_s
from portbench.peaks import roofline_pct


def _is_k7(name: str) -> bool:
    return "epilogue_kernel" in name


def read(rec):
    t, n = kernel_s(rec, _is_k7)
    calls = rec.get("calls", 0)
    if not n or not calls or not rec.get("epilogue_bytes_per_call"):
        return None
    return roofline_pct(rec["epilogue_bytes_per_call"], t / calls)
