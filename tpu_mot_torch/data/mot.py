"""MOT16/MOTChallenge data plumbing: det/gt readers, result writer (a copy
of tpu_mot/data/mot.py: NumPy, and OpenCV imported by
load_image_sequence alone).

Load precomputed detections from `det.txt` (frame, id, x, y, w, h, conf,
...) for the detector-free config (BASELINE.json configs[0]), and write
MOT-format result files an external MOTA scorer consumes.

MOT files are 1-indexed, top-left (x, y) + (w, h); the framework uses
center (cx, cy, w, h) — conversion happens here at the boundary.
"""

from __future__ import annotations

import os

import numpy as np


def tlwh_to_cxcywh(b: np.ndarray) -> np.ndarray:
    out = np.array(b, np.float32, copy=True)
    out[..., 0] += out[..., 2] / 2.0
    out[..., 1] += out[..., 3] / 2.0
    return out


def cxcywh_to_tlwh(b: np.ndarray) -> np.ndarray:
    out = np.array(b, np.float32, copy=True)
    out[..., 0] -= out[..., 2] / 2.0
    out[..., 1] -= out[..., 3] / 2.0
    return out


def load_mot_dets(path: str, score_min: float = -1e9):
    """Parse a MOT det.txt → list over frames of [D_f, 5] (cx, cy, w, h,
    score) arrays.  Frames with no detections get empty arrays; the list is
    dense from frame 1 to the max frame present."""
    raw = np.loadtxt(path, delimiter=",", ndmin=2)
    if raw.size == 0:
        return []
    frames = raw[:, 0].astype(int)
    n_frames = frames.max()
    out = [np.zeros((0, 5), np.float32) for _ in range(n_frames)]
    for f in range(1, n_frames + 1):
        rows = raw[frames == f]
        if len(rows) == 0:
            continue
        boxes = tlwh_to_cxcywh(rows[:, 2:6])
        scores = rows[:, 6:7].astype(np.float32) if raw.shape[1] > 6 else \
            np.ones((len(rows), 1), np.float32)
        keep = scores[:, 0] >= score_min
        out[f - 1] = np.concatenate([boxes[keep], scores[keep]],
                                    axis=1).astype(np.float32)
    return out


def load_mot_gt(path: str, min_visibility: float = 0.0,
                pedestrian_only: bool = True,
                n_frames: int | None = None):
    """Parse gt.txt → list over frames of (ids [N], boxes [N, 4] cxcywh).

    MOT16 gt columns: frame, id, x, y, w, h, active, class, visibility.
    n_frames: pad/extend to exactly this many frames — gt.txt is only
    dense up to its LAST annotated frame, so a clip whose objects all
    exit early would otherwise come back shorter than the image sequence
    and crash clear_mot's length assertion.
    """
    raw = np.loadtxt(path, delimiter=",", ndmin=2)
    frames = raw[:, 0].astype(int)
    n_frames = n_frames or frames.max()
    out = []
    for f in range(1, n_frames + 1):
        rows = raw[frames == f]
        if len(rows) and raw.shape[1] >= 9:
            keep = rows[:, 6] > 0
            if pedestrian_only:
                keep &= np.isin(rows[:, 7], (1, 2, 7))
            keep &= rows[:, 8] >= min_visibility
            rows = rows[keep]
        ids = rows[:, 1].astype(np.int64) if len(rows) else np.zeros(0, int)
        boxes = (tlwh_to_cxcywh(rows[:, 2:6]) if len(rows)
                 else np.zeros((0, 4), np.float32))
        out.append((ids, boxes))
    return out


def write_mot_results(path: str, tracks_per_frame) -> None:
    """Write tracker output in MOT result format for external scoring.

    tracks_per_frame: list over frames of [(id, (cx, cy, w, h), score)].
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for fi, tracks in enumerate(tracks_per_frame, start=1):
            for tid, box, score in tracks:
                x = box[0] - box[2] / 2.0
                y = box[1] - box[3] / 2.0
                f.write(f"{fi},{tid},{x:.2f},{y:.2f},{box[2]:.2f},"
                        f"{box[3]:.2f},{score:.3f},-1,-1,-1\n")


def load_image_sequence(img_dir: str, gray: bool = True, limit=None):
    """Read an image-sequence directory (MOT16 img1/, OTB img/) into a
    [N, H, W] (gray) or [N, H, W, 3] uint8 stack via OpenCV."""
    import cv2

    names = sorted(os.listdir(img_dir))
    names = [n for n in names if n.lower().endswith((".jpg", ".png", ".bmp"))]
    if limit:
        names = names[:limit]
    frames = []
    for n in names:
        img = cv2.imread(os.path.join(img_dir, n),
                         cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        frames.append(img)
    return np.stack(frames) if frames else np.zeros((0, 0, 0), np.uint8)
