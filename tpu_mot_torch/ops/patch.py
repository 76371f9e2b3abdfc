"""Batched ROI patch extraction (counterpart of tpu_mot/ops/patch.py).

`extract_patches` is the gather path: every track's context window is
bilinearly sampled straight from the full-resolution frame.  It is what
the CPU reference and both goldens use (roi_impl="xla").  The pyramid +
kernel path lives in tpu_mot_torch/kernels/roi.py.

Boxes are (cx, cy, w, h) in pixels, float32.
"""

from __future__ import annotations

import torch

from tpu_mot_torch.kernels import roi


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor,
                    frame: torch.Tensor | None = None) -> torch.Tensor:
    """Sample img [H, W] at float coords ys, xs [T, S] -> [T, S, S]; with
    S frames img [S, H, W] and frame [T] (each row's frame index), row t
    samples img[frame[t]].

    Coordinates are clamped to the frame (border replication).  The
    arithmetic follows the JAX version step for step: lerp whole rows in
    y, then gather the two columns within each row block and lerp in x.
    """
    h, w = img.shape[-2:]
    ys = ys.clamp(0.0, h - 1.0)
    xs = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = (ys - y0)[:, :, None]                       # [T, S, 1]
    fx = (xs - x0)[:, None, :]                       # [T, 1, S]
    y0 = y0.long()
    x0 = x0.long()
    y1 = torch.clamp_max(y0 + 1, h - 1)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    if frame is not None:
        f = frame[:, None]
        rows = img[f, y0] * (1.0 - fy) + img[f, y1] * fy   # [T, S, W]
    else:
        rows = img[y0] * (1.0 - fy) + img[y1] * fy         # [T, S, W]
    idx_shape = rows.shape[:2] + (x0.shape[1],)
    c0 = rows.gather(2, x0[:, None, :].expand(idx_shape))
    c1 = rows.gather(2, x1[:, None, :].expand(idx_shape))
    return c0 * (1.0 - fx) + c1 * fx


def extract_patches(img: torch.Tensor, boxes: torch.Tensor, padding: float,
                    size: int, scales: torch.Tensor | None = None,
                    frame: torch.Tensor | None = None) -> torch.Tensor:
    """Per-track context windows (padding * box, times an optional [T]
    per-track scale) resized to [size, size].

    img [H, W] float32 (or S frames [S, H, W] with `frame` [T], each box's
    frame index), boxes [T, 4] -> [T, size, size] float32.  Degenerate
    boxes (w or h <= 0) are clamped to 1 px.
    """
    cx, cy, w, h = boxes.unbind(1)
    w = torch.clamp_min(w, 1.0)
    h = torch.clamp_min(h, 1.0)
    if scales is not None:
        w = w * scales
        h = h * scales
    win_w = w * padding
    win_h = h * padding
    u = (torch.arange(size, dtype=torch.float32, device=boxes.device)
         + 0.5) / size - 0.5
    ys = cy[:, None] + u[None, :] * win_h[:, None]
    xs = cx[:, None] + u[None, :] * win_w[:, None]
    return bilinear_sample(img, ys, xs, frame)


def extract_patches_auto(img: torch.Tensor, boxes: torch.Tensor,
                         padding: float, size: int,
                         scales: torch.Tensor | None = None,
                         impl: str = "auto", levels=None,
                         frame_hw=None,
                         frame: torch.Tensor | None = None) -> torch.Tensor:
    """ROI extraction with implementation dispatch.

    impl: "pallas" (pyramid + the ROI kernel wrapper, which launches the
    CUDA kernel for a CUDA frame and runs its plain version on the CPU),
    "xla" (the gather path), or "auto" ("pallas" for a CUDA frame, "xla"
    on the CPU — the split tpu_mot/ops/patch.py makes between TPU and
    CPU).  S frames [S, H, W]: the gather path reads each box's frame from
    `frame` [T]; the pyramid path takes stream-major boxes (T/S a
    frame)."""
    if impl == "auto":
        impl = "pallas" if img.is_cuda else "xla"
    if impl == "pallas":
        return roi.extract_patches(img, boxes, padding, size,
                                   levels=levels, frame_hw=frame_hw,
                                   scales=scales)
    return extract_patches(img, boxes, padding, size, scales, frame)


def to_gray(frame: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """Frame [H, W] / [H, W, 1] / [H, W, 3] (uint8 or float) -> [H, W]
    float32 in [0, 1] (BT.601 luma for RGB); batched: frames [S, H, W(, C)]
    -> [S, H, W]."""
    f = frame.to(torch.float32)
    if f.ndim == 3 + batched:
        if f.shape[-1] == 3:
            f = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        else:
            f = f[..., 0]
    if frame.dtype == torch.uint8:
        f = f / 255.0
    return f
