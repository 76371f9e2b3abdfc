"""Pairwise IoU and the gated association cost (counterpart of
tpu_mot/ops/iou.py).  Boxes are (cx, cy, w, h)."""

from __future__ import annotations

import torch


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix [..., T, D] between box sets a [..., T, 4] and
    b [..., D, 4] (leading axes broadcast: a batch of frames)."""
    ax1 = a[..., 0] - a[..., 2] / 2
    ay1 = a[..., 1] - a[..., 3] / 2
    ax2 = a[..., 0] + a[..., 2] / 2
    ay2 = a[..., 1] + a[..., 3] / 2
    bx1 = b[..., 0] - b[..., 2] / 2
    by1 = b[..., 1] - b[..., 3] / 2
    bx2 = b[..., 0] + b[..., 2] / 2
    by2 = b[..., 1] + b[..., 3] / 2
    iw = torch.clamp_min(torch.minimum(ax2[..., :, None], bx2[..., None, :])
                         - torch.maximum(ax1[..., :, None],
                                         bx1[..., None, :]), 0.0)
    ih = torch.clamp_min(torch.minimum(ay2[..., :, None], by2[..., None, :])
                         - torch.maximum(ay1[..., :, None],
                                         by1[..., None, :]), 0.0)
    inter = iw * ih
    area_a = (a[..., 2] * a[..., 3])[..., :, None]
    area_b = (b[..., 2] * b[..., 3])[..., None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, 0.0)


def association_cost(track_boxes: torch.Tensor, det_boxes: torch.Tensor,
                     track_valid: torch.Tensor, det_valid: torch.Tensor,
                     iou_gate: float, infeasible: float,
                     appearance: torch.Tensor | None = None,
                     appearance_weight: float = 0.0,
                     class_gate: torch.Tensor | None = None,
                     track_boxes_alt: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """Gated cost matrix [..., T, D]: (1 - w)(1 - IoU) + w (1 - appearance),
    or `infeasible` for pairs below the IoU gate or involving a dead track
    slot / padded detection.  Leading axes (serving: one per stream) run
    through every argument: track_boxes [..., T, 4], det_boxes [..., D, 4],
    track_valid [..., T], det_valid [..., D].

    appearance      : optional [..., T, D] similarity, clipped to [0, 1]
                      (the KCF response of track t's model at detection d).
    class_gate      : optional [..., T, D] bool; False pairs are
                      infeasible.
    track_boxes_alt : optional second box per track; each pair scores the
                      better of the two IoUs, and the gate tests that one.
    """
    iou = pairwise_iou(track_boxes, det_boxes)
    if track_boxes_alt is not None:
        iou = torch.maximum(iou, pairwise_iou(track_boxes_alt, det_boxes))
    cost = 1.0 - iou
    if appearance is not None and appearance_weight > 0.0:
        cost = ((1.0 - appearance_weight) * cost
                + appearance_weight * (1.0 - appearance.clamp(0.0, 1.0)))
    feasible = ((iou >= iou_gate)
                & track_valid[..., :, None] & det_valid[..., None, :])
    if class_gate is not None:
        feasible = feasible & class_gate
    return torch.where(feasible, cost, infeasible)
