"""The whole step's share of the card's float32 peak in the YOLOv4 cell:
`step_mfu_pct`'s arithmetic over the driver's `step_flops_per_call`
(YOLOv4-608's 110 convs on a gray frame, 127.96 GFLOP, x the streams)."""

from portbench.metrics.step_mfu_pct import read  # noqa: F401
