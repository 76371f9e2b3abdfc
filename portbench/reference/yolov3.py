"""Plain PyTorch reference of full YOLOv3 at 608 x 608, the detector of
the `yolov3-608` cells, from its published topology (pjreddie/darknet
cfg/yolov3.cfg; Redmon & Farhadi, arXiv:1804.02767, YOLOv3-608), imported
from nowhere in the program.

Input: u8 gray (or RGB) frames, scaled to [0, 1] and resized to 608 x 608
(bilinear, antialiased); a gray channel feeds the first conv, whose kernel
is summed over its three input channels (equal to feeding the gray value
in all three).  Darknet-53: a 3x3 conv of 32, then five stages, each
a 3x3 conv of stride 2 (64, 128, 256, 512, 1024 channels) and 1, 2, 8, 8, 4
residual units: a 1x1 conv to half the width, a 3x3 conv back to the full
width, added to the unit's input (darknet's linear shortcut).  Every conv
pads k // 2 on both sides, at stride 2 too (darknet's `pad=1`).  Heads at
strides 32, 16, 8: head 0 on the last stage; heads 1 and 2 start with a 1x1
conv (256, 128) on the previous head's conv set, a nearest x2 upsample and
a concat with the stride-16 or stride-8 stage's output (upsampled first).
Each head: a conv set of 1x1 / 3x3 / 1x1 / 3x3 / 1x1 (f, 2f, f, 2f, f with
f = 512, 256, 128), a 3x3 conv of 2f and the linear 1x1 head of 255 = 3
anchors x (5 + 80).  Every conv but the heads: BatchNorm (running
statistics, eps 1e-5, the program's; darknet adds 1e-6 to the standard
deviation instead) and leaky ReLU 0.1.  75 convs in all.  Decode, score
and NMS are `reference/yolo.py`'s (sigmoid xy plus the cell times the
stride, anchor x exp(clip(wh, -10, 8)), objectness x the largest class
sigmoid; class-wise greedy NMS over the 512 best candidates, IoU 0.45,
score > 0.3), with the published anchors in input pixels.

The weights are handed over under the program's state-dict names
(`ConvBlock_<i>` in cfg order, `head0..2`).  `heads(..., calibrate=True)`
sets every BatchNorm's running mean and variance to its conv output's
statistics over the frames given, as training leaves them (the driver
does so once, on a few of the seed's frames).

`precision="tf32"` is the control: the convolutions in TF32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.reference.yolo import decode, nms

ANCHORS = (((116, 90), (156, 198), (373, 326)),
           ((30, 61), (62, 45), (59, 119)),
           ((10, 13), (16, 30), (33, 23)))
STRIDES = (32, 16, 8)
INPUT = 608
STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))
HEAD_WIDTHS = (512, 256, 128)
N_OUT = 3 * (5 + 80)


def conv_layers(size: int = INPUT, gray: bool = True) -> list[tuple]:
    """(cin, cout, k, output grid) of each of the 75 convs in cfg order at
    input `size`; the first conv reads one channel for a gray frame."""
    out = [(1 if gray else 3, 32, 3, size)]
    g, c, grids = size, 32, []
    for f, n_res in STAGES:
        g = (g + 1) // 2
        out.append((c, f, 3, g))
        out += [(f, f // 2, 1, g), (f // 2, f, 3, g)] * n_res
        grids.append(g)
        c = f
    cin = c
    for head, f in enumerate(HEAD_WIDTHS):
        g = grids[4 - head]
        if head:
            # the upsample conv on the previous head's set, then the route
            out.append((2 * f, f, 1, grids[5 - head]))
            cin = f + STAGES[4 - head][0]
        for k in (1, 3, 1, 3, 1):
            out.append((cin, f if k == 1 else 2 * f, k, g))
            cin = f if k == 1 else 2 * f
        out += [(f, 2 * f, 3, g), (2 * f, N_OUT, 1, g)]
    return out


def conv_flops(size: int = INPUT, gray: bool = True) -> float:
    """2 x multiply-adds of the 75 convs on one frame at `size`."""
    return sum(2.0 * ci * co * k * k * g * g
               for ci, co, k, g in conv_layers(size, gray))


def _block(p, name, x, stride=1, act=True, calibrate=False):
    w = p[f"{name}.conv.weight"]
    if x.shape[1] == 1 and w.shape[1] != 1:
        w = w.sum(dim=1, keepdim=True)
    y = F.conv2d(x, w, p.get(f"{name}.conv.bias"), stride, w.shape[-1] // 2)
    if f"{name}.bn.weight" in p:
        if calibrate:
            p[f"{name}.bn.running_mean"] = y.mean(dim=(0, 2, 3))
            p[f"{name}.bn.running_var"] = y.var(dim=(0, 2, 3),
                                                unbiased=False)
        mul = torch.rsqrt(p[f"{name}.bn.running_var"] + 1e-5) * p[
            f"{name}.bn.weight"]
        c = (slice(None), None, None)
        y = (y - p[f"{name}.bn.running_mean"][c]) * mul[c] + p[
            f"{name}.bn.bias"][c]
    if act:
        y = F.leaky_relu(y, 0.1)
    return y


def heads(p: dict, frames: torch.Tensor, size: int = INPUT,
          calibrate: bool = False) -> tuple:
    """Raw heads [B, Hg, Wg, 255] of u8 frames [B, H, W] (gray) or
    [B, H, W, 3], strides 32, 16, 8."""
    names = iter(f"ConvBlock_{i}" for i in range(72))

    def conv(x, stride=1):
        return _block(p, next(names), x, stride, calibrate=calibrate)

    x = frames.to(torch.float32) / 255.0
    x = x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    x = conv(x)
    routes = []
    for _, n_res in STAGES:
        x = conv(x, 2)
        for _ in range(n_res):
            x = x + conv(conv(x))
        routes.append(x)
    out, branch = [], x
    for head, route in enumerate((None, routes[3], routes[2])):
        if route is not None:
            up = F.interpolate(conv(branch), scale_factor=2, mode="nearest")
            branch = torch.cat([up, route], dim=1)
        for _ in range(5):
            branch = conv(branch)
        out.append(_block(p, f"head{head}", conv(branch), act=False))
    return tuple(h.permute(0, 2, 3, 1) for h in out)


@contextlib.contextmanager
def _precision(precision: str):
    """TF32 on for "tf32" (the control), else off, restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    low = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def calibrate(p: dict, frames: torch.Tensor, size: int = INPUT) -> dict:
    """Set every BatchNorm's running statistics from u8 frames [B, H, W]
    (float32, TF32 off); returns p."""
    with _precision("float32"), torch.no_grad():
        heads(p, frames, size, calibrate=True)
    return p


def candidates(p: dict, frames: torch.Tensor, frame_hw, size: int = INPUT,
               precision: str = "float32"):
    """Every candidate before NMS: boxes [B, N, 4] in frame pixels, scores
    [B, N], classes [B, N]; N = 3 x (19^2 + 38^2 + 76^2) at 608."""
    with _precision(precision):
        raws = heads(p, frames, size)
    parts = [decode(r, a, s, frame_hw, size) for r, a, s in
             zip(raws, ANCHORS, STRIDES)]
    return tuple(torch.cat(x, 1) for x in zip(*parts))


def detect(p: dict, frames: torch.Tensor, frame_hw, max_out=64,
           precision: str = "float32", size: int = INPUT, block: int = 32):
    """Detections of u8 frames [B, H, W], `block` frames at a time: (dets
    [B, D, 5], valid [B, D], classes [B, D])."""
    outs = []
    for lo in range(0, frames.shape[0], block):
        c = candidates(p, frames[lo:lo + block], frame_hw, size, precision)
        outs.append(nms(*c, max_out))
    return tuple(torch.cat(x, 0) for x in zip(*outs))
