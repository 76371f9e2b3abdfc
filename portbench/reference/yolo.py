"""Plain PyTorch reference of the yolov3-tiny detector the detect cells
serve, from its published topology (pjreddie/darknet cfg/yolov3-tiny.cfg;
Redmon & Farhadi, arXiv:1804.02767), imported from nowhere in the program.

Input: u8 gray frames, scaled to [0, 1] and resized to 416 x 416
(bilinear, antialiased); the gray channel feeds the first conv, whose
kernel is summed over its three input channels (equal to feeding the gray
value in all three).  Trunk: 3x3 convs of 16, 32, 64, 128, 256 channels
each followed by a 2x2 max pool of stride 2, a 3x3 conv of 512, a 2x2 max
pool of stride 1 (padded right and bottom), 3x3 of 1024, 1x1 of 256
(route 13); head 0: 3x3 of 512 then the 1x1 linear head (255 = 3 anchors
x 85) at stride 32; head 1: 1x1 of 128 on route 13, nearest x2 upsample,
concatenated with the 256-channel stride-16 map, 3x3 of 256, linear head.
Every conv but the heads: BatchNorm (running statistics, eps 1e-5) and
leaky ReLU 0.1.  Decode: sigmoid xy plus the cell, times the stride;
anchor x exp(clip(wh, -10, 8)); score = sigmoid objectness x the largest
class sigmoid, the class its first maximum.  Class-wise greedy NMS over
the 512 best candidates, IoU 0.45, score > 0.3, 64 outputs.

`precision="tf32"` is the control: the convolutions in TF32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ANCHORS = (((81, 82), (135, 169), (344, 319)),
           ((10, 14), (23, 27), (37, 58)))
STRIDES = (32, 16)
INPUT = 416


def _block(p, name, x, stride_pool=None, act=True):
    w = p[f"{name}.conv.weight"]
    if x.shape[1] == 1 and w.shape[1] != 1:
        w = w.sum(dim=1, keepdim=True)
    bias = p.get(f"{name}.conv.bias")
    k = w.shape[-1]
    y = F.conv2d(x, w, bias, 1, k // 2)
    if f"{name}.bn.weight" in p:
        mul = torch.rsqrt(p[f"{name}.bn.running_var"] + 1e-5) * p[
            f"{name}.bn.weight"]
        c = (slice(None), None, None)
        y = (y - p[f"{name}.bn.running_mean"][c]) * mul[c] + p[
            f"{name}.bn.bias"][c]
    if act:
        y = F.leaky_relu(y, 0.1)
    return y


def _pool(x, stride):
    if stride == 1:
        x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
    return F.max_pool2d(x, 2, stride)


def heads(p: dict, frames: torch.Tensor, size: int = INPUT) -> tuple:
    """Raw heads [B, Hg, Wg, 255] of u8 frames [B, H, W]."""
    x = (frames.to(torch.float32) / 255.0)[:, None]
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    for i in range(4):
        x = _pool(_block(p, f"ConvBlock_{i}", x), 2)
    route8 = x = _block(p, "ConvBlock_4", x)
    x = _pool(_block(p, "ConvBlock_5", _pool(x, 2)), 1)
    x = _block(p, "ConvBlock_6", x)
    route13 = _block(p, "ConvBlock_7", x)
    y0 = _block(p, "head0", _block(p, "ConvBlock_8", route13), act=False)
    u = F.interpolate(_block(p, "ConvBlock_9", route13), scale_factor=2,
                      mode="nearest")
    y1 = _block(p, "head1",
                _block(p, "ConvBlock_10", torch.cat([u, route8], dim=1)),
                act=False)
    return tuple(h.permute(0, 2, 3, 1) for h in (y0, y1))


def decode(raw, anchors, stride, frame_hw, size: int = INPUT):
    """Candidates of one head: boxes [B, N, 4] (frame pixels), scores
    [B, N], classes [B, N]; N in (row, col, anchor) order."""
    b, hg, wg, _ = raw.shape
    a = len(anchors)
    raw = raw.reshape(b, hg, wg, a, -1)
    dev = raw.device
    gy = torch.arange(hg, dtype=torch.float32, device=dev)[:, None, None]
    gx = torch.arange(wg, dtype=torch.float32, device=dev)[None, :, None]
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)
    xy = torch.sigmoid(raw[..., :2])
    cx = (gx + xy[..., 0]) * stride
    cy = (gy + xy[..., 1]) * stride
    wh = torch.exp(raw[..., 2:4].clamp(-10.0, 8.0)) * anc
    cls_p = torch.sigmoid(raw[..., 5:])
    score = torch.sigmoid(raw[..., 4]) * cls_p.amax(dim=-1)
    cls = cls_p.argmax(dim=-1)
    h, w = frame_hw
    scale = torch.tensor([w / size, h / size, w / size, h / size],
                         device=dev)
    boxes = torch.stack([cx, cy, wh[..., 0], wh[..., 1]], -1).reshape(
        b, -1, 4) * scale
    return boxes, score.reshape(b, -1), cls.reshape(b, -1)


def iou(a, b):
    ax1, ay1 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax2, ay2 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx1, by1 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx2, by2 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = (torch.minimum(ax2[..., :, None], bx2[..., None, :])
          - torch.maximum(ax1[..., :, None], bx1[..., None, :])).clamp_min(0)
    ih = (torch.minimum(ay2[..., :, None], by2[..., None, :])
          - torch.maximum(ay1[..., :, None], by1[..., None, :])).clamp_min(0)
    inter = iw * ih
    union = ((a[..., 2] * a[..., 3])[..., :, None]
             + (b[..., 2] * b[..., 3])[..., None, :] - inter)
    return torch.where(union > 0, inter / union, 0.0)


def nms(boxes, scores, classes, max_out=64, iou_thr=0.45, score_thr=0.3,
        pre_top=512):
    """Class-wise greedy NMS (boxes of another class never suppress; each
    centre x shifted by class x 1e5) over the `pre_top` best candidates ->
    dets [B, max_out, 5], valid [B, max_out], classes [B, max_out]."""
    shifted = boxes.clone()
    shifted[..., 0] += classes.to(torch.float32) * 1e5
    k = min(pre_top, scores.shape[1])
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    top = order[:, :k]
    s = scores.gather(1, top)
    bx = shifted.gather(1, top[..., None].expand(-1, -1, 4))
    ov = iou(bx, bx)
    live = s > score_thr
    rows = torch.arange(s.shape[0], device=s.device)
    picks, oks = [], []
    for _ in range(max_out):
        cur = torch.where(live, s, -1.0)
        best = cur.argmax(dim=-1)
        ok = cur[rows, best] > score_thr
        live = live & ~((ov[rows, best] >= iou_thr) & ok[:, None])
        live[rows, best] = False
        picks.append(best)
        oks.append(ok)
    pick = top.gather(1, torch.stack(picks, -1))
    valid = torch.stack(oks, -1)
    out_boxes = boxes.gather(1, pick[..., None].expand(-1, -1, 4))
    out_scores = torch.where(valid, scores.gather(1, pick), 0.0)
    out_cls = torch.where(valid, classes.gather(1, pick), -1)
    return (torch.cat([out_boxes, out_scores[..., None]], -1), valid,
            out_cls)


def detect(p: dict, frames: torch.Tensor, frame_hw, max_out=64,
           precision: str = "float32", size: int = INPUT):
    """Detections of u8 frames [B, H, W]: (dets [B, D, 5], valid [B, D],
    classes [B, D])."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    low = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    try:
        raws = heads(p, frames, size)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    parts = [decode(r, a, s, frame_hw, size) for r, a, s in
             zip(raws, ANCHORS, STRIDES)]
    boxes, scores, classes = (torch.cat(x, 1) for x in zip(*parts))
    return nms(boxes, scores, classes, max_out)
