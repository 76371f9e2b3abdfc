"""The whole step's share of the card's float32 peak in the YOLOv3 cell:
`step_mfu_pct`'s arithmetic over the driver's `step_flops_per_call`
(YOLOv3-608's 75 convs on a gray frame, 140.27 GFLOP, x the streams)."""

from portbench.metrics.step_mfu_pct import read  # noqa: F401
