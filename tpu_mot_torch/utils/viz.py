"""Visualization and video output (a copy of tpu_mot/utils/viz.py): draw
boxes and ids on frames, write annotated videos.  Host-side OpenCV,
imported inside the functions that draw."""

from __future__ import annotations

import numpy as np

_PALETTE = [(66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
            (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
            (92, 107, 192), (240, 98, 146), (0, 121, 107), (93, 64, 55)]


def id_color(tid: int):
    return _PALETTE[tid % len(_PALETTE)]


def draw_tracks(frame: np.ndarray, tracks, thickness: int = 2):
    """Draw tracks onto a uint8 frame (gray / RGB); returns an RGB uint8
    copy.  Each track is (id, (cx, cy, w, h), score) with an optional
    4th element — the detector class id (cfg.class_aware streams) —
    rendered as "id:cls" in the label."""
    import cv2

    img = np.asarray(frame)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    else:
        img = img.copy()
    for trk in tracks:
        tid, box, score = trk[0], trk[1], trk[2]
        label = (f"{int(tid)}:{int(trk[3])}" if len(trk) > 3
                 and trk[3] is not None and int(trk[3]) >= 0
                 else f"{int(tid)}")
        cx, cy, w, h = box
        p1 = (int(cx - w / 2), int(cy - h / 2))
        p2 = (int(cx + w / 2), int(cy + h / 2))
        color = id_color(int(tid))
        cv2.rectangle(img, p1, p2, color, thickness)
        cv2.putText(img, label, (p1[0], max(p1[1] - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    return img


def write_video(path: str, frames_tracks, fps: float = 30.0):
    """Write an annotated video: iterable of (frame, tracks) pairs."""
    import cv2

    writer = None
    for frame, tracks in frames_tracks:
        img = draw_tracks(frame, tracks)
        if writer is None:
            writer = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                (img.shape[1], img.shape[0]))
        writer.write(img)
    if writer is not None:
        writer.release()
