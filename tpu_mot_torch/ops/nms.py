"""Non-maximum suppression with static shapes (counterpart of
tpu_mot/ops/nms.py), over a batch of frames at once.

Every function takes boxes [..., N, 4] (cx, cy, w, h) and scores [..., N]
with any leading axes (a batch of frames; none for one frame) and returns
(indices [..., max_out] int32, -1 where invalid; valid [..., max_out]
bool), index for index what the JAX functions return per frame.  The
greedy loop runs `max_out` slots in Python with no host read: each slot is
a handful of launches over the whole batch.
"""

from __future__ import annotations

import torch

from tpu_mot_torch.ops.iou import pairwise_iou


def _top_k(scores: torch.Tensor, k: int):
    """The k largest scores [B, k] and their indices, the lower index first
    among equal scores (jax.lax.top_k's order; torch.topk promises none)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return scores.gather(-1, order), order


def _flat(boxes, scores):
    lead = scores.shape[:-1]
    return (lead, boxes.reshape(-1, boxes.shape[-2], 4),
            scores.reshape(-1, scores.shape[-1]))


def nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
        iou_thr: float = 0.45, score_thr: float = 0.0,
        pre_top_k: int | None = None):
    """Greedy NMS over max_out output slots.

    Candidates are first cut to the `pre_top_k` best scores (default
    8*max_out, capped at N) before the [K, K] IoU.  Each slot takes the
    first maximum over the live scores, keeps it if it is > score_thr,
    suppresses its neighbours at IoU >= iou_thr and kills it.  Exact
    against unfiltered greedy NMS unless greedy suppresses more than
    K - max_out of the top K (tpu_mot.ops.nms.nms states the contract);
    pre_top_k >= N makes it exact always."""
    lead, boxes, scores = _flat(boxes, scores)
    n = boxes.shape[1]
    k = min(n, pre_top_k if pre_top_k is not None else 8 * max_out)
    top_idx = None
    if k < n:
        scores, top_idx = _top_k(scores, k)
        boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    iou = pairwise_iou(boxes, boxes)                    # [B, K, K]
    live = scores > score_thr
    rows = torch.arange(scores.shape[0], device=scores.device)
    dead = torch.full_like(scores, -1.0)
    out_idx, out_valid = [], []
    for _ in range(max_out):
        s = torch.where(live, scores, dead)
        best = torch.argmax(s, dim=-1)                  # [B], first max
        ok = s[rows, best] > score_thr
        suppress = iou[rows, best] >= iou_thr           # [B, K]
        live = live & ~(suppress & ok[:, None])
        live[rows, best] = False
        out_idx.append(torch.where(ok, best, -1))
        out_valid.append(ok)
    out_idx = torch.stack(out_idx, dim=-1)
    out_valid = torch.stack(out_valid, dim=-1)
    if top_idx is not None:
        out_idx = torch.where(out_valid,
                              top_idx.gather(1, out_idx.clamp(0, k - 1)), -1)
    return (out_idx.to(torch.int32).reshape(lead + (max_out,)),
            out_valid.reshape(lead + (max_out,)))


def fast_nms(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
             iou_thr: float = 0.45, score_thr: float = 0.0,
             pre_top_k: int | None = None):
    """Parallel NMS (YOLACT's Fast NMS): a candidate is suppressed if ANY
    higher-scored candidate overlaps it at iou_thr, kept or not.  The kept
    set is mutually non-overlapping and a subset of greedy's; kept boxes
    fill the slots in score order.  Same interface as nms()."""
    lead, boxes, scores = _flat(boxes, scores)
    b, n = scores.shape
    k = min(n, pre_top_k if pre_top_k is not None else 8 * max_out)
    top_scores, top_idx = _top_k(scores, k)             # score-descending
    cand = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    iou = pairwise_iou(cand, cand)                      # [B, K, K]
    pos = torch.arange(k, device=scores.device)
    higher = pos[None, :] < pos[:, None]                # j < i
    sup = torch.where(higher, iou, 0.0).amax(dim=-1)    # [B, K]
    keep = (sup < iou_thr) & (top_scores > score_thr)
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    # slot max_out is a spill column, dropped below (JAX's mode="drop")
    slot = torch.where(keep & (rank < max_out), rank, max_out).long()
    out_idx = torch.full((b, max_out + 1), -1, dtype=torch.int32,
                         device=scores.device).scatter_(
                             1, slot, top_idx.to(torch.int32))
    valid = torch.zeros((b, max_out + 1), dtype=torch.bool,
                        device=scores.device).scatter_(
                            1, slot, torch.ones_like(keep))
    return (out_idx[:, :max_out].reshape(lead + (max_out,)),
            valid[:, :max_out].reshape(lead + (max_out,)))


def nms_classwise(boxes: torch.Tensor, scores: torch.Tensor,
                  classes: torch.Tensor, max_out: int,
                  iou_thr: float = 0.45, score_thr: float = 0.0,
                  impl: str = "greedy", pre_top_k: int | None = None):
    """Class-aware NMS: boxes of different classes never suppress each
    other.  Each centre x is shifted by class * 1e5 in float32, as the JAX
    package does (the shift's rounding, ~0.008 px at 1e5, is part of the
    result).  impl: "greedy" (nms) or "fast" (fast_nms)."""
    shifted = boxes.clone()
    shifted[..., 0] += classes.to(torch.float32) * 1e5
    fn = fast_nms if impl == "fast" else nms
    return fn(shifted, scores, max_out, iou_thr, score_thr,
              pre_top_k=pre_top_k)
