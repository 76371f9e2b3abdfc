"""Tracking and detection metrics, host side (a copy of
tpu_mot/utils/metrics.py: NumPy and SciPy only).

Per-frame inputs are sequences of (ids [N], boxes [N, 4]) with boxes as
(cx, cy, w, h).  `clear_mot` matches ground truth to hypotheses per frame at
an IoU threshold, keeping earlier pairings (CLEAR rules), and adds IDF1;
`hota` is Luiten et al.'s two-pass HOTA; `otb_precision` is the
single-object protocol (centre-error precision, mean IoU) and
`detection_map` the detector's VOC mean average precision.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ax1, ay1 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax2, ay2 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx1, by1 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx2, by2 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.maximum(0, np.minimum(ax2[:, None], bx2) - np.maximum(ax1[:, None], bx1))
    ih = np.maximum(0, np.minimum(ay2[:, None], by2) - np.maximum(ay1[:, None], by1))
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + b[:, 2] * b[:, 3] - inter
    return np.where(union > 0, inter / union, 0.0)


def otb_precision(gt_boxes, pred_boxes, thresholds=(20.0,)) -> dict:
    """OTB single-object metrics: center-error precision at pixel
    thresholds and mean IoU (success proxy) — the published KCF numbers'
    protocol (arXiv:1404.7584 Table 1, 'mean precision @20px').

    gt_boxes / pred_boxes: [N, 4] (cx, cy, w, h) per frame.
    """
    gt = np.asarray(gt_boxes, float)
    pr = np.asarray(pred_boxes, float)
    err = np.hypot(gt[:, 0] - pr[:, 0], gt[:, 1] - pr[:, 1])
    # Per-frame IoU elementwise: O(N), not the diagonal of an [N, N] matrix.
    gl, gr = gt[:, :2] - gt[:, 2:] / 2, gt[:, :2] + gt[:, 2:] / 2
    pl_, pr_ = pr[:, :2] - pr[:, 2:] / 2, pr[:, :2] + pr[:, 2:] / 2
    inter = np.prod(np.clip(np.minimum(gr, pr_) - np.maximum(gl, pl_),
                            0.0, None), axis=1)
    union = (np.prod(gt[:, 2:], 1) + np.prod(pr[:, 2:], 1) - inter)
    ious = inter / np.maximum(union, 1e-9)
    out = {f"precision@{int(t)}px": float((err <= t).mean())
           for t in thresholds}
    out["mean_center_error"] = float(err.mean())
    out["mean_iou"] = float(ious.mean())
    out["success@0.5"] = float((ious >= 0.5).mean())
    return out


def detection_map(pred_frames, gt_frames, num_classes: int,
                  iou_thr: float = 0.5) -> dict:
    """VOC-style mean average precision, the detector-quality signal that
    training needs beyond its loss.

    pred_frames : per-image (boxes [N, 4] cxcywh, scores [N], classes [N])
    gt_frames   : per-image (boxes [M, 4] cxcywh, classes [M])
    Returns {"map": float, "ap_per_class": [C]}.  AP is the area under the
    monotone precision envelope (continuous VOC-2010 protocol); each GT box
    matches at most one detection, greedily by descending score.
    """
    aps = []
    for c in range(num_classes):
        # Flatten class-c detections across images with image indices.
        recs = []
        n_gt = 0
        gt_c = []
        for img, (gb, gc) in enumerate(gt_frames):
            gb = np.asarray(gb, float).reshape(-1, 4)
            gc = np.asarray(gc)
            sel = np.where(gc == c)[0]
            gt_c.append(gb[sel])
            n_gt += len(sel)
        for img, (pb, ps, pc) in enumerate(pred_frames):
            pb = np.asarray(pb, float).reshape(-1, 4)
            ps = np.asarray(ps, float).reshape(-1)
            pc = np.asarray(pc).reshape(-1)
            for i in np.where(pc == c)[0]:
                recs.append((float(ps[i]), img, pb[i]))
        if n_gt == 0:
            continue                       # class absent from GT: skip
        recs.sort(key=lambda r: -r[0])
        taken = [np.zeros(len(g), bool) for g in gt_c]
        tp = np.zeros(len(recs))
        for k, (_, img, box) in enumerate(recs):
            g = gt_c[img]
            if len(g) == 0:
                continue
            ious = _iou_matrix(box[None], g)[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thr and not taken[img][j]:
                taken[img][j] = True
                tp[k] = 1.0
        cum_tp = np.cumsum(tp)
        recall = cum_tp / n_gt
        precision = cum_tp / np.arange(1, len(recs) + 1)
        # Monotone precision envelope, integrated over recall.
        ap = 0.0
        if len(recs):
            for k in range(len(precision) - 2, -1, -1):
                precision[k] = max(precision[k], precision[k + 1])
            prev_r = 0.0
            for k in range(len(recs)):
                ap += (recall[k] - prev_r) * precision[k]
                prev_r = recall[k]
        aps.append(ap)
    return {"map": float(np.mean(aps)) if aps else 0.0,
            "ap_per_class": [float(a) for a in aps]}


def clear_mot(gt_frames, hyp_frames, iou_thr: float = 0.5) -> dict:
    """Compute CLEAR-MOT + identity metrics.

    gt_frames / hyp_frames: per-frame sequences of (ids [N], boxes [N, 4]).
    Returns dict with mota, motp, idf1, fp, fn, idsw, n_gt, precision,
    recall, mostly_tracked/mostly_lost fractions.
    """
    assert len(gt_frames) == len(hyp_frames)
    fp = fn = idsw = n_gt_total = n_matches = 0
    sum_iou = 0.0
    last_hyp_for_gt: dict = {}
    cooc: dict = {}
    gt_len: dict = {}
    hyp_len: dict = {}
    gt_tracked_frames: dict = {}

    for (gids, gboxes), (hids, hboxes) in zip(gt_frames, hyp_frames):
        gids = np.asarray(gids)
        hids = np.asarray(hids)
        gboxes = np.asarray(gboxes, float).reshape(len(gids), 4)
        hboxes = np.asarray(hboxes, float).reshape(len(hids), 4)
        n_gt_total += len(gids)
        for g in gids:
            gt_len[g] = gt_len.get(g, 0) + 1
        for h in hids:
            hyp_len[h] = hyp_len.get(h, 0) + 1

        iou = _iou_matrix(gboxes, hboxes)
        matched_g = np.zeros(len(gids), bool)
        matched_h = np.zeros(len(hids), bool)
        matches = []

        # 1. Persist previous pairings still above the threshold (CLEAR).
        hid_index = {h: j for j, h in enumerate(hids)}
        for i, g in enumerate(gids):
            prev = last_hyp_for_gt.get(g)
            if prev is not None and prev in hid_index:
                j = hid_index[prev]
                if iou[i, j] >= iou_thr and not matched_h[j]:
                    matches.append((i, j))
                    matched_g[i] = matched_h[j] = True

        # 2. Hungarian on the remainder.
        free_g = np.where(~matched_g)[0]
        free_h = np.where(~matched_h)[0]
        if len(free_g) and len(free_h):
            sub = 1.0 - iou[np.ix_(free_g, free_h)]
            ri, ci = linear_sum_assignment(sub)
            for r, c in zip(ri, ci):
                i, j = free_g[r], free_h[c]
                if iou[i, j] >= iou_thr:
                    matches.append((i, j))
                    matched_g[i] = matched_h[j] = True

        for i, j in matches:
            g, h = gids[i], hids[j]
            if g in last_hyp_for_gt and last_hyp_for_gt[g] != h:
                idsw += 1
            last_hyp_for_gt[g] = h
            cooc[(g, h)] = cooc.get((g, h), 0) + 1
            gt_tracked_frames[g] = gt_tracked_frames.get(g, 0) + 1
            sum_iou += iou[i, j]
        n_matches += len(matches)
        fn += int((~matched_g).sum())
        fp += int((~matched_h).sum())

    mota = 1.0 - (fn + fp + idsw) / max(n_gt_total, 1)
    motp = sum_iou / max(n_matches, 1)

    # IDF1: global bipartite match of GT ids to hyp ids on co-occurrence.
    gt_ids = sorted(gt_len)
    hyp_ids = sorted(hyp_len)
    if gt_ids and hyp_ids:
        mat = np.zeros((len(gt_ids), len(hyp_ids)))
        for (g, h), c in cooc.items():
            mat[gt_ids.index(g), hyp_ids.index(h)] = c
        ri, ci = linear_sum_assignment(-mat)
        idtp = mat[ri, ci].sum()
    else:
        idtp = 0.0
    total_len = sum(gt_len.values()) + sum(hyp_len.values())
    idf1 = 2.0 * idtp / max(total_len, 1)

    ratios = [gt_tracked_frames.get(g, 0) / gt_len[g] for g in gt_ids]
    mostly_tracked = (np.mean([r >= 0.8 for r in ratios]) if ratios else 0.0)
    mostly_lost = (np.mean([r < 0.2 for r in ratios]) if ratios else 0.0)
    n_hyp_total = sum(hyp_len.values())
    return {
        "mota": mota, "motp": motp, "idf1": idf1,
        "fp": fp, "fn": fn, "idsw": idsw,
        "n_gt": n_gt_total, "n_hyp": n_hyp_total,
        "recall": n_matches / max(n_gt_total, 1),
        "precision": n_matches / max(n_hyp_total, 1),
        "mostly_tracked": float(mostly_tracked),
        "mostly_lost": float(mostly_lost),
    }


def hota(gt_frames, hyp_frames, alphas=None) -> dict:
    """HOTA (Higher Order Tracking Accuracy, Luiten et al., IJCV 2020) —
    the modern MOT metric decomposing into detection and association
    accuracy: HOTA_a = sqrt(DetA_a * AssA_a), averaged over localization
    thresholds a.  Follows the published two-pass algorithm (the one the
    official TrackEval scorer implements): a global alignment score from
    accumulated per-pair similarity first, then per-a Hungarian matching
    that maximizes alignment*similarity so association quality breaks
    detection-level ties.

    The reference predates HOTA and scores CLEAR-MOT only (SURVEY.md §4);
    this extension lets users score both from the same
    (ids, boxes)-per-frame outputs.  Inputs exactly as clear_mot.
    Returns {hota, deta, assa, loca, hota_alpha: [A], alphas: [A]}.
    """
    if alphas is None:
        alphas = np.arange(0.05, 0.96, 0.05)
    alphas = np.asarray(alphas, float)
    assert len(gt_frames) == len(hyp_frames)

    # Index the id spaces.
    gt_ids = sorted({int(g) for gids, _ in gt_frames
                     for g in np.asarray(gids).tolist()})
    hyp_ids = sorted({int(h) for hids, _ in hyp_frames
                      for h in np.asarray(hids).tolist()})
    gmap = {g: i for i, g in enumerate(gt_ids)}
    hmap = {h: i for i, h in enumerate(hyp_ids)}
    ng, nh = len(gt_ids), len(hyp_ids)
    if ng == 0 or nh == 0:
        z = np.zeros_like(alphas)
        empty = ng == 0 and nh == 0
        val = 1.0 if empty else 0.0
        return {"hota": val, "deta": val, "assa": val, "loca": val,
                "hota_alpha": z + val, "alphas": alphas}

    # Pass 1: per-frame IoU + global potential-match accumulation.
    frames = []                      # (g_idx [N], h_idx [M], iou [N, M])
    potential = np.zeros((ng, nh))
    gt_count = np.zeros(ng)
    hyp_count = np.zeros(nh)
    for (gids, gboxes), (hids, hboxes) in zip(gt_frames, hyp_frames):
        gi = np.asarray([gmap[int(g)] for g in np.asarray(gids).tolist()],
                        int)
        hi = np.asarray([hmap[int(h)] for h in np.asarray(hids).tolist()],
                        int)
        iou = _iou_matrix(
            np.asarray(gboxes, float).reshape(len(gi), 4),
            np.asarray(hboxes, float).reshape(len(hi), 4))
        frames.append((gi, hi, iou))
        gt_count[gi] += 1
        hyp_count[hi] += 1
        if len(gi) and len(hi):
            denom = iou.sum(0)[None, :] + iou.sum(1)[:, None] - iou
            sim = np.divide(iou, denom, out=np.zeros_like(iou),
                            where=denom > 0)
            potential[np.ix_(gi, hi)] += sim
    align = potential / np.maximum(
        gt_count[:, None] + hyp_count[None, :] - potential, 1e-12)

    # Pass 2: per-alpha matching and association accumulation.
    eps = 1e-9
    n_alpha = len(alphas)
    tp = np.zeros(n_alpha)
    fn = np.zeros(n_alpha)
    fp = np.zeros(n_alpha)
    loc = np.zeros(n_alpha)
    match_count = np.zeros((n_alpha, ng, nh))
    for gi, hi, iou in frames:
        if len(gi) == 0 or len(hi) == 0:
            fn += len(gi)
            fp += len(hi)
            continue
        score = align[np.ix_(gi, hi)] * iou
        for a, alpha in enumerate(alphas):
            ok = iou >= alpha - eps
            ri, ci = linear_sum_assignment(-(score * ok))
            keep = ok[ri, ci]
            ri, ci = ri[keep], ci[keep]
            tp[a] += len(ri)
            fn[a] += len(gi) - len(ri)
            fp[a] += len(hi) - len(ri)
            loc[a] += iou[ri, ci].sum()
            match_count[a][gi[ri], hi[ci]] += 1

    ass_alpha = np.zeros(n_alpha)
    for a in range(n_alpha):
        union = np.maximum(
            gt_count[:, None] + hyp_count[None, :] - match_count[a], 1e-12)
        ass_alpha[a] = (match_count[a] * (match_count[a] / union)).sum() \
            / max(tp[a], 1e-12)
    det_alpha = tp / np.maximum(tp + fn + fp, 1e-12)
    hota_alpha = np.sqrt(det_alpha * ass_alpha)
    return {
        "hota": float(hota_alpha.mean()),
        "deta": float(det_alpha.mean()),
        "assa": float(ass_alpha.mean()),
        "loca": float((loc / np.maximum(tp, 1e-12)).mean()),
        "hota_alpha": hota_alpha,
        "alphas": alphas,
    }
