"""Plain PyTorch reference of full YOLOv4 at 608 x 608, the detector of
the `yolov4-608` cell, from its published topology (AlexeyAB/darknet
cfg/yolov4.cfg; Bochkovskiy, Wang & Liao, arXiv:2004.10934, YOLOv4-608),
imported from nowhere in the program.

Input: u8 gray (or RGB) frames, scaled to [0, 1] and resized to 608 x 608
(bilinear, antialiased); a gray channel feeds the first conv, whose kernel
is summed over its three input channels (equal to feeding the gray value
in all three).  Every conv pads k // 2 on both sides, at stride 2 too
(darknet's `pad=1`).  By cfg layer:

  0        3x3 conv of 32, Mish.
  1-104    CSPDarknet53, Mish: five CSP stages of (width f, residual
           units) (64, 1), (128, 2), (256, 8), (512, 8), (1024, 4).  A
           stage: a stride-2 3x3 conv to f; a 1x1 conv of h on it (part 2;
           h = f in stage 1, else f / 2); `route -2`, a 1x1 conv of h on the
           downsample (the main branch); the units (a 1x1 conv of f / 2, a
           3x3 conv of h, `shortcut -3`: the unit's input plus its output,
           linear); a 1x1 conv of h; `route -1,-k`: concat [main, part 2];
           a 1x1 transition conv of f.  Stage 3's transition is layer 54,
           stage 4's layer 85, stage 5's layer 104.
  105-116  The SPP neck, leaky ReLU 0.1 from here on: 1x1 512, 3x3 1024,
           1x1 512 (107); max pools of 5, 9 and 13 at stride 1, padded
           k // 2 with -FLT_MAX (108, 110, 112); `route -1,-3,-5,-6`: concat
           [pool 13, pool 9, pool 5, layer 107] (2048 channels); 1x1 512,
           3x3 1024, 1x1 512 (116).
  117-136  PANet's top-down path: 1x1 256 on 116, nearest x2 upsample
           (118); `route 85`, 1x1 256 (120, the lateral); concat
           [lateral, upsampled]; 1x1 / 3x3 / 1x1 / 3x3 / 1x1 of 256 / 512
           (122-126).  The same at stride 8: 1x1 128 on 126, upsample,
           1x1 128 on layer 54, concat, the set of 128 / 256 (132-136).
  137-139  3x3 256 on 136, the linear 1x1 head of 255 = 3 x (5 + 80)
           (138), [yolo] at stride 8 (head 2).
  140-150  Bottom-up: a stride-2 3x3 conv of 256 on 136 (141), concat
           [it, layer 126], the set of 256 / 512 (143-147), 3x3 512, the
           linear head (149), [yolo] at stride 16 (head 1).
  151-161  A stride-2 3x3 conv of 512 on 147 (152), concat [it, layer
           116], the set of 512 / 1024 (154-158), 3x3 1024, the linear
           head (160), [yolo] at stride 32 (head 0).

110 convs: 72 Mish (the backbone), 35 leaky, 3 linear heads; 23 shortcut
adds.  Every conv but the heads: BatchNorm (running statistics, eps 1e-5,
the program's; darknet adds 1e-6 to the standard deviation instead).
Mish is darknet's x * tanh(softplus(x)), computed as torch's F.mish does,
x * tanh(log1p(exp(x))).  Darknet's softplus has threshold 20: it returns
x above 20, where tanh of x and of log1p(exp(x)) both round to 1 in
float32, and exp(x) below -20, which equals log1p(exp(x)) in float32
(exp(x) < 2.1e-9 is below half an ulp of 1); so the threshold changes no
float32 result and is not written out.

Decode (each [yolo] layer): with s = scale_x_y (1.05, 1.1, 1.2 at strides
32, 16, 8), the centre is (cell + sigmoid(t) * s - (s - 1) / 2) x the
stride; the size anchor x exp(clip(wh, -10, 8)) with the published anchors
in input pixels; the score the objectness sigmoid x the largest class
sigmoid.  NMS is `reference/yolo.py`'s (class-wise greedy over the 512
best candidates, IoU 0.45, score > 0.3).

The weights are handed over under the program's state-dict names
(`ConvBlock_<i>` for the 107 BatchNorm convs in cfg order, `head0..2`).
`calibrate` sets every BatchNorm's running mean and variance to its conv
output's statistics over the frames given, as training leaves them (the
driver does so once, on the first frame of a few streams).

`precision="tf32"` is the control: the convolutions in TF32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.reference.yolo import nms

ANCHORS = (((142, 110), (192, 243), (459, 401)),
           ((36, 75), (76, 55), (72, 146)),
           ((12, 16), (19, 36), (40, 28)))
STRIDES = (32, 16, 8)
SCALE_X_Y = (1.05, 1.1, 1.2)
INPUT = 608
STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))
SPP_POOLS = (13, 9, 5)
N_OUT = 3 * (5 + 80)


def conv_layers(size: int = INPUT, gray: bool = True) -> list[tuple]:
    """(cin, cout, k, output grid, activation, takes a skip) of each of the
    110 convs in cfg order at input `size`; the activation is "mish",
    "leaky" or "linear"; the first conv reads one channel for a gray
    frame."""
    out = [(1 if gray else 3, 32, 3, size, "mish", False)]
    g, c, grids = size, 32, []
    for stage, (f, n_res) in enumerate(STAGES):
        h = f if stage == 0 else f // 2
        g = (g + 1) // 2
        out += [(c, f, 3, g, "mish", False), (f, h, 1, g, "mish", False),
                (f, h, 1, g, "mish", False)]
        out += [(h, f // 2, 1, g, "mish", False),
                (f // 2, h, 3, g, "mish", True)] * n_res
        out += [(h, h, 1, g, "mish", False), (2 * h, f, 1, g, "mish", False)]
        grids.append(g)
        c = f
    g8, g16, g32 = grids[2], grids[3], grids[4]

    def leaky(ci, co, k, grid):
        out.append((ci, co, k, grid, "leaky", False))

    def conv_set(ci, f, grid):
        for k in (1, 3, 1, 3, 1):
            leaky(ci, f if k == 1 else 2 * f, k, grid)
            ci = f if k == 1 else 2 * f

    for ci, co, k in ((1024, 512, 1), (512, 1024, 3), (1024, 512, 1),
                      (2048, 512, 1), (512, 1024, 3), (1024, 512, 1)):
        leaky(ci, co, k, g32)                           # 105-116
    for f, g_in, g_out in ((256, g32, g16), (128, g16, g8)):
        leaky(2 * f, f, 1, g_in)                        # 117, 127
        leaky(2 * f, f, 1, g_out)                       # 120, 130
        conv_set(2 * f, f, g_out)
    leaky(128, 256, 3, g8)                              # 137
    out.append((256, N_OUT, 1, g8, "linear", False))    # 138, head 2
    for f, g_out in ((256, g16), (512, g32)):
        leaky(f // 2, f, 3, g_out)                      # 141, 152 (stride 2)
        conv_set(2 * f, f, g_out)
        leaky(f, 2 * f, 3, g_out)                       # 148, 159
        out.append((2 * f, N_OUT, 1, g_out, "linear", False))
    return out


def conv_flops(size: int = INPUT, gray: bool = True) -> float:
    """2 x multiply-adds of the 110 convs on one frame at `size`."""
    return sum(2.0 * ci * co * k * k * g * g
               for ci, co, k, g, _, _ in conv_layers(size, gray))


def other_flops(size: int = INPUT) -> float:
    """What darknet counts besides the convs: its max pools (k^2 x the
    output elements) and its shortcuts (an operation an element)."""
    g32 = conv_layers(size)[-1][3]
    pools = sum(k * k * 512 * g32 * g32 for k in SPP_POOLS)
    adds = sum(co * g * g for _, co, _, g, _, skip in conv_layers(size)
               if skip)
    return float(pools + adds)


def epilogue_bytes(size: int = INPUT) -> float:
    """Bytes of one frame's BatchNorm epilogues at their bound: every
    BatchNorm conv's output read and written once (8 bytes an element),
    every shortcut operand read once (4)."""
    return float(sum(co * g * g * (12 if skip else 8)
                     for _, co, _, g, act, skip in conv_layers(size)
                     if act != "linear"))


def _block(p, name, x, stride=1, act="leaky", skip=None, calibrate=False):
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
    if act == "mish":
        y = F.mish(y)
    elif act == "leaky":
        y = F.leaky_relu(y, 0.1)
    return y if skip is None else skip + y


def heads(p: dict, frames: torch.Tensor, size: int = INPUT,
          calibrate: bool = False) -> tuple:
    """Raw heads [B, Hg, Wg, 255] of u8 frames [B, H, W] (gray) or
    [B, H, W, 3], strides 32, 16, 8."""
    names = iter(f"ConvBlock_{i}" for i in range(107))

    def conv(x, stride=1, act="leaky", skip=None):
        return _block(p, next(names), x, stride, act, skip, calibrate)

    def conv_set(x):
        for _ in range(5):
            x = conv(x)
        return x

    x = frames.to(torch.float32) / 255.0
    x = x[:, None] if x.ndim == 3 else x.permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    x = conv(x, act="mish")                                     # 0
    layer = {}
    for stage, (_, n_res) in enumerate(STAGES):
        down = conv(x, 2, "mish")
        part2 = conv(down, act="mish")
        x = conv(down, act="mish")
        for _ in range(n_res):
            x = conv(conv(x, act="mish"), act="mish", skip=x)
        main = conv(x, act="mish")
        x = conv(torch.cat([main, part2], 1), act="mish")       # transition
        layer[stage] = x
    x = conv(conv(conv(x)))                                     # 105-107
    x = torch.cat([F.max_pool2d(x, k, 1, k // 2) for k in SPP_POOLS] + [x],
                  1)
    l116 = x = conv(conv(conv(x)))                              # 114-116
    up = F.interpolate(conv(x), scale_factor=2, mode="nearest")  # 117-118
    l126 = x = conv_set(torch.cat([conv(layer[3]), up], 1))     # 120-126
    up = F.interpolate(conv(x), scale_factor=2, mode="nearest")  # 127-128
    l136 = conv_set(torch.cat([conv(layer[2]), up], 1))         # 130-136
    h2 = _block(p, "head2", conv(l136), act="linear")           # 137-138
    x = conv_set(torch.cat([conv(l136, 2), l126], 1))           # 141-147
    h1 = _block(p, "head1", conv(x), act="linear")              # 148-149
    x = conv_set(torch.cat([conv(x, 2), l116], 1))              # 152-158
    h0 = _block(p, "head0", conv(x), act="linear")              # 159-160
    return tuple(h.permute(0, 2, 3, 1) for h in (h0, h1, h2))


def decode(raw, anchors, stride, scale_x_y, frame_hw, size: int = INPUT):
    """Candidates of one head: boxes [B, N, 4] (frame pixels), scores
    [B, N], classes [B, N]; N in (row, col, anchor) order."""
    b, hg, wg, _ = raw.shape
    raw = raw.reshape(b, hg, wg, len(anchors), -1)
    dev = raw.device
    gy = torch.arange(hg, dtype=torch.float32, device=dev)[:, None, None]
    gx = torch.arange(wg, dtype=torch.float32, device=dev)[None, :, None]
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)
    xy = torch.sigmoid(raw[..., :2]) * scale_x_y - 0.5 * (scale_x_y - 1.0)
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
    """Set every BatchNorm's running statistics from u8 frames [B, H, W],
    in cfg order (float32, TF32 off); returns p."""
    with _precision("float32"), torch.no_grad():
        heads(p, frames, size, calibrate=True)
    return p


def candidates(p: dict, frames: torch.Tensor, frame_hw, size: int = INPUT,
               precision: str = "float32"):
    """Every candidate before NMS: boxes [B, N, 4] in frame pixels, scores
    [B, N], classes [B, N]; N = 3 x (19^2 + 38^2 + 76^2) at 608."""
    with _precision(precision):
        raws = heads(p, frames, size)
    parts = [decode(r, a, s, sxy, frame_hw, size) for r, a, s, sxy in
             zip(raws, ANCHORS, STRIDES, SCALE_X_Y)]
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
