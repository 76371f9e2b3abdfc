"""The YOLO detector family (counterpart of tpu_mot/models/yolo.py):
yolov3, yolov3-tiny, yolov2 and yolov2-tiny as `nn.Module`s over NCHW.

Each net builds its blocks in the JAX package's construction order, so
block i is the flax module `ConvBlock_{i}` and the heads are `head0..2`
(`interop.yolo_params_from_jax` maps the flax tree onto the state dict by
those names; the darknet loader relies on the order).  The heads return
float32 in NHWC, as the JAX nets do, so `decode_head` reads them the same
way.

The space-to-depth stem of the JAX package (`stem="s2d4"`, the default at
inference through `stem="auto"`) is an exact rewrite of the direct
composition that exists for the TPU's lane padding; the port runs the
direct composition for every `stem` value and keeps the knob and
`resolved_stem`'s answers so that a spec means the same in both packages.
A gray frame feeds the first conv as one channel with the kernel summed
over its input channels (exact for replicated channels, a third of the
work).

In eval mode BatchNorm uses its running statistics; in train mode it
normalises with the batch statistics and updates the running ones in
flax's convention (see `ConvBlock`), which is what parallel/train.py runs.
Compute dtypes follow `spec.dtype`: "float32", "bfloat16" (input and
kernel cast to bfloat16, BatchNorm in float32 rounded to bfloat16, as flax
does), or "int8" (dynamic post-training quantization with exact integer
sums, inference only; see `_quant_conv`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_mot_torch.models import epilogue
from tpu_mot_torch.utils.profiling import span

# Residual shortcut adds run by YoloV3 forwards (23 a forward), read by
# tests and the benchmark's traced runs, as kernels/kcf counts launches.
shortcuts = 0

# Canonical anchor sets (pixels at the native 416x416 input), public YOLO
# releases.
YOLOV3_TINY_ANCHORS = (
    ((81, 82), (135, 169), (344, 319)),      # head 0, stride 32
    ((10, 14), (23, 27), (37, 58)),          # head 1, stride 16
)
YOLOV2_TINY_ANCHORS = (
    ((18.3, 21.6), (59.9, 66.0), (106.8, 175.5), (252.2, 112.9),
     (312.2, 293.4)),                        # single head, stride 32
)
# Full v2 shares the v2 anchor set (darknet publishes them in grid units;
# these are the same values scaled by stride 32 into input pixels).
YOLOV2_ANCHORS = YOLOV2_TINY_ANCHORS
YOLOV3_ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),     # head 0, stride 32
    ((30, 61), (62, 45), (59, 119)),         # head 1, stride 16
    ((10, 13), (16, 30), (33, 23)),          # head 2, stride 8
)

_CANONICAL_ANCHORS = {
    "yolov3": YOLOV3_ANCHORS,
    "yolov3-tiny": YOLOV3_TINY_ANCHORS,
    "yolov2": YOLOV2_ANCHORS,
    "yolov2-tiny": YOLOV2_TINY_ANCHORS,
}


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    """A copy of tpu_mot.models.yolo.YoloSpec: the same fields, defaults and
    validation (tests/test_torch_yolo.py holds them equal)."""

    name: str
    num_classes: int = 80
    input_size: int = 416
    # None -> the variant's canonical anchor set; or a per-head
    # tuple-of-tuples.
    anchors: tuple | None = None
    # Conv compute dtype: "float32", "bfloat16" or "int8".
    dtype: str = "float32"
    # BatchNorm running-statistics momentum in flax's convention (0.99 =
    # torch momentum 0.01); only training reads it (ConvBlock).
    bn_momentum: float = 0.99
    # "auto", "direct" or "s2d4"; the port computes the direct composition
    # for every value (see the module docstring).
    stem: str = "auto"

    def __post_init__(self):
        if self.stem not in ("auto", "direct", "s2d4"):
            raise ValueError(f"unknown stem {self.stem!r}; "
                             "have ('auto', 'direct', 's2d4')")
        if self.stem == "s2d4":
            if self.name == "yolov3":
                raise ValueError("yolov3's strided-conv stem has no pools "
                                 "to collapse; stem='s2d4' supports the "
                                 "pooled variants (yolov3-tiny, yolov2, "
                                 "yolov2-tiny)")
            if self.dtype == "int8":
                raise ValueError("stem='s2d4' is implemented for the "
                                 "f32/bf16 conv path (int8 serves the "
                                 "direct stem)")
        if self.anchors is None:
            if self.name not in _CANONICAL_ANCHORS:
                raise ValueError(
                    f"unknown yolo variant {self.name!r}; have "
                    f"{sorted(_CANONICAL_ANCHORS)} (or pass anchors=)")
            object.__setattr__(self, "anchors",
                               _CANONICAL_ANCHORS[self.name])

    @property
    def strides(self) -> tuple:
        return (32, 16, 8)[: len(self.anchors)]

    @property
    def cls_activation(self) -> str:
        """v3 heads score classes with independent sigmoids, v2 heads with
        a softmax."""
        return "sigmoid" if self.name.startswith("yolov3") else "softmax"


def resolved_stem(spec: YoloSpec, train: bool = False, hw=None) -> str:
    """The stem the JAX package would run for one apply (its
    `resolved_stem`, same answers): s2d4 for the pooled variants at
    inference on f32/bf16 with H, W divisible by 4, else direct; an
    explicit value passes through.  The port computes the direct
    composition whatever this says."""
    if spec.stem != "auto":
        return spec.stem
    if train or spec.dtype == "int8" or spec.name == "yolov3":
        return "direct"
    if hw is not None and (hw[0] % 4 or hw[1] % 4):
        return "direct"
    return "s2d4"


def _quant_conv(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
                fold_gray: bool) -> torch.Tensor:
    """int8 conv (tpu_mot.models.yolo._QuantConv): weights quantised per
    output channel (max |w| over kh, kw, Cin over 127), activations per
    SAMPLE (max |x| over C, H, W over 127: a bright frame must not
    coarsen its batchmates' grid), round half to even, clip to +-127, the
    integer sums exact, then both scales applied in float32.

    The sums run as a float64 conv on integer values: 127 * 127 * 9 * 1024
    ~ 1.5e8 is past float32's 2^24 but exact in float64 (F.conv2d has no
    int8 path on CUDA).  fold_gray sums the QUANTISED kernel over Cin for a
    one-channel input, which equals the conv of the replicated channels
    exactly."""
    s_w = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) / 127.0, 1e-8)   # [O]
    wq = torch.clamp(torch.round(w / s_w[:, None, None, None]), -127, 127)
    if fold_gray:
        wq = wq.sum(dim=1, keepdim=True)
    x = x.float()
    s_x = torch.clamp_min(x.abs().amax(dim=(1, 2, 3), keepdim=True) / 127.0,
                          1e-8)                                  # [B,1,1,1]
    xq = torch.clamp(torch.round(x / s_x), -127, 127)
    y = F.conv2d(xq.double(), wq.double(), stride=stride, padding=pad)
    return y.float() * (s_x * s_w[None, :, None, None])


class ConvBlock(nn.Module):
    """Conv + BatchNorm + LeakyReLU(0.1), darknet's block.

    The conv pads k//2 on both sides at every stride (darknet's padding;
    XLA's SAME pads (0, 1) at stride 2); it has a bias only where there is
    no BatchNorm.  A one-channel input into a conv that expects more
    channels is a gray frame: the kernel is summed over its input channels.

    BatchNorm is flax's (nn.BatchNorm, epsilon 1e-5).  In train mode it
    normalises with the batch mean and the BIASED batch variance E[y^2] -
    E[y]^2 clipped at 0, reduced in float32 also under bfloat16 (flax's
    force_float32_reductions), and updates running = m * running + (1 - m)
    * batch with m = bn_momentum (flax's convention; torch's momentum is 1 -
    m, and torch's own update would take the unbiased variance).

    The batch statistics come from per-channel sums of y and y^2 over a
    count of elements.  `stats_over`, None or (sum_fn, images of the global
    batch), is set by the data-parallel train step (parallel/train.py) for
    its duration: sum_fn, a differentiable sum over the ranks, then turns
    the sums into the global batch's, so that the backward pass and the
    running statistics see the global values on every rank.

    `skip`, the operand of a YOLOv3 shortcut, is added last (skip + out).
    In eval mode, a block with BatchNorm and the activation whose conv
    output `epilogue.takes` (a contiguous float32 CUDA tensor that needs no
    gradient) runs BatchNorm, the activation and the add as one kernel in
    place (models/epilogue.fused, K7: bit for bit the chain below); every
    other BatchNorm block runs the chain and counts in
    `epilogue.chain_blocks`.
    """

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 use_bn: bool = True, act: bool = True,
                 dtype: str = "float32", bn_momentum: float = 0.99):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding=kernel // 2,
                              bias=not use_bn)
        self.bn = (nn.BatchNorm2d(cout, eps=1e-5, momentum=1.0 - bn_momentum)
                   if use_bn else None)
        self.bn_momentum = bn_momentum
        self.act = act
        self.dtype = dtype
        self.stats_over = None

    def _batch_stats(self, y: torch.Tensor):
        """Batch mean and biased variance of y [B, C, H, W] per channel, in
        float32; updates the running statistics (no gradient)."""
        if self.dtype == "int8":
            raise ValueError("spec.dtype='int8' is inference-only; train "
                             "in float32 or bfloat16")
        y = y.float()
        sums = torch.stack([y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3))])
        n_images = y.shape[0]
        if self.stats_over is not None:
            sum_fn, n_images = self.stats_over
            sums = sum_fn(sums)
        count = n_images * y.shape[2] * y.shape[3]
        mean = sums[0] / count
        var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        bn, m = self.bn, self.bn_momentum
        with torch.no_grad():
            bn.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            bn.running_var.mul_(m).add_(var, alpha=1.0 - m)
            bn.num_batches_tracked.add_(1)
        return mean, var

    def forward(self, x: torch.Tensor,
                skip: torch.Tensor | None = None) -> torch.Tensor:
        conv = self.conv
        w = conv.weight
        fold = x.shape[1] == 1 and w.shape[1] != 1
        if not fold and x.shape[1] != w.shape[1]:
            raise ValueError(f"input has {x.shape[1]} channels; the conv "
                             f"expects {w.shape[1]} (or 1, a gray frame)")
        if self.dtype == "int8":
            y = _quant_conv(x, w, conv.stride[0], conv.padding[0], fold)
            if conv.bias is not None:
                y = y + conv.bias[:, None, None]
            dt = torch.float32
        else:
            # float32 nets compute in their parameters' dtype (a .double()
            # net is a float64 reference)
            dt = torch.bfloat16 if self.dtype == "bfloat16" else w.dtype
            if fold:
                w = w.sum(dim=1, keepdim=True)
            bias = conv.bias.to(dt) if conv.bias is not None else None
            y = F.conv2d(x.to(dt), w.to(dt), bias, conv.stride, conv.padding)
        if self.bn is not None:
            bn = self.bn
            mean, var = ((bn.running_mean, bn.running_var)
                         if not self.training else self._batch_stats(y))
            mul = torch.rsqrt(var + bn.eps) * bn.weight
            if self.act and not self.training and epilogue.takes(y, skip):
                return epilogue.fused(y, mean, mul, bn.bias, skip)
            epilogue.chain_blocks += 1
            c = (slice(None), None, None)
            y = ((y - mean[c]) * mul[c] + bn.bias[c]).to(dt)
        if self.act:
            y = F.leaky_relu(y, 0.1)
        return y if skip is None else skip + y


def _maxpool(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """2x2 max pool with flax's "SAME" padding: -inf on the right and
    bottom where the windows overrun (always at stride 1, at stride 2 on
    an odd extent)."""
    def pads(n):
        total = max((-(-n // stride) - 1) * stride + 2 - n, 0)
        return total // 2, total - total // 2

    ph, pw = pads(x.shape[-2]), pads(x.shape[-1])
    if any(ph + pw):
        x = F.pad(x, (*pw, *ph), value=float("-inf"))
    return F.max_pool2d(x, 2, stride)


def _reorg(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """YOLOv2 passthrough, space to depth: [B, C, H, W] -> [B, s*s*C, H/s,
    W/s] with output channel k = (dy*s + dx)*C + c (block-position-major,
    as tpu_mot.models.yolo._reorg)."""
    b, c, h, w = x.shape
    s = stride
    x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, s * s * c, h // s, w // s)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 (jax.image.resize "nearest" at twice the size)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _YoloNet(nn.Module):
    """Holds the blocks: `_cb` adds ConvBlock_{i} in construction order,
    `_head` a named linear 1x1 head; forward takes the blocks back in the
    same order from `_blocks()` (one `next` per statement: Python
    evaluates a callee before its arguments)."""

    def __init__(self, spec: YoloSpec):
        super().__init__()
        self.spec = spec
        self._names = []

    def _cb(self, cin: int, cout: int, kernel: int = 3,
            stride: int = 1) -> int:
        name = f"ConvBlock_{len(self._names)}"
        self.add_module(name, ConvBlock(cin, cout, kernel, stride,
                                        dtype=self.spec.dtype,
                                        bn_momentum=self.spec.bn_momentum))
        self._names.append(name)
        return cout

    def _head(self, name: str, cin: int, head: int) -> None:
        n_out = len(self.spec.anchors[head]) * (5 + self.spec.num_classes)
        self.add_module(name, ConvBlock(cin, n_out, 1, use_bn=False,
                                        act=False, dtype=self.spec.dtype))

    def _blocks(self):
        return (getattr(self, n) for n in self._names)

    @staticmethod
    def _out(*heads: torch.Tensor) -> tuple:
        """float32 heads in NHWC, as the JAX nets return them."""
        return tuple(h.permute(0, 2, 3, 1).float() for h in heads)


class YoloV3Tiny(_YoloNet):
    """Two-head tiny YOLOv3 (13 convs), darknet topology."""

    def __init__(self, spec: YoloSpec):
        super().__init__(spec)
        c = 3
        for f in (16, 32, 64, 128, 256, 512, 1024):
            c = self._cb(c, f)                          # ConvBlock_0..6
        c = self._cb(c, 256, 1)                         # 7: route13
        self._head("head0", self._cb(c, 512), 0)        # 8, head0
        u = self._cb(256, 128, 1)                       # 9
        self._head("head1", self._cb(u + 256, 256), 1)  # 10, head1

    def forward(self, x: torch.Tensor) -> tuple:
        b = self._blocks()
        with span("detector.backbone"):
            for _ in range(4):
                x = _maxpool(next(b)(x))
            route8 = x = next(b)(x)
            x = _maxpool(next(b)(_maxpool(x)), stride=1)
            x = next(b)(x)
            route13 = next(b)(x)
        with span("detector.head0"):
            y0 = self.head0(next(b)(route13))
        with span("detector.head1"):
            u = _upsample2(next(b)(route13))
            y1 = self.head1(next(b)(torch.cat([u, route8], dim=1)))
        return self._out(y0, y1)


class YoloV2Tiny(_YoloNet):
    """Single-head tiny YOLOv2 (9 convs), darkflow-era topology."""

    def __init__(self, spec: YoloSpec):
        super().__init__(spec)
        c = 3
        for f in (16, 32, 64, 128, 256, 512, 1024, 512):
            c = self._cb(c, f)                          # ConvBlock_0..7
        self._head("head0", c, 0)

    def forward(self, x: torch.Tensor) -> tuple:
        b = self._blocks()
        with span("detector.backbone"):
            for _ in range(5):
                x = _maxpool(next(b)(x))
            x = _maxpool(next(b)(x), stride=1)
            x = next(b)(x)
            x = next(b)(x)
        with span("detector.head0"):
            y0 = self.head0(x)
        return self._out(y0)


class YoloV2(_YoloNet):
    """Full YOLOv2: darknet-19 and the passthrough (reorg) head, built in
    darknet cfg order (22 BN convs, then head0)."""

    # (features, kernel) of the backbone convs between pools; None = pool
    _BODY = ((32, 3), None, (64, 3), None, (128, 3), (64, 1), (128, 3), None,
             (256, 3), (128, 1), (256, 3), None, (512, 3), (256, 1),
             (512, 3), (256, 1), (512, 3), "route16", None, (1024, 3),
             (512, 1), (1024, 3), (512, 1), (1024, 3), (1024, 3), (1024, 3))

    def __init__(self, spec: YoloSpec):
        super().__init__(spec)
        c = 3
        for item in self._BODY:
            if isinstance(item, tuple):
                c = self._cb(c, *item)                  # ConvBlock_0..19
        p = self._cb(512, 64, 1)                        # 20, on route16
        self._head("head0", self._cb(4 * p + c, 1024), 0)   # 21, head0

    def forward(self, x: torch.Tensor) -> tuple:
        b = self._blocks()
        route16 = None
        with span("detector.backbone"):
            for item in self._BODY:
                if item is None:
                    x = _maxpool(x)
                elif item == "route16":
                    route16 = x
                else:
                    x = next(b)(x)
        with span("detector.head0"):
            p = _reorg(next(b)(route16))
            x = next(b)(torch.cat([p, x], dim=1))
            y0 = self.head0(x)
        return self._out(y0)


class YoloV3(_YoloNet):
    """Full YOLOv3: darknet-53 and three heads (stride 32/16/8), 75 convs
    in darknet cfg order (72 BN convs and the three heads)."""

    def __init__(self, spec: YoloSpec):
        super().__init__(spec)
        self._cb(3, 32)
        c = 32
        for f, n_res in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
            c = self._cb(c, f, stride=2)
            for _ in range(n_res):
                self._cb(f, f // 2, 1)
                self._cb(f // 2, f)
        cin = 1024
        for head, (f, route) in enumerate(((512, 0), (256, 512),
                                           (128, 256))):
            if head:
                cin = self._cb(2 * f, f, 1) + route     # upsample conv
            for k in (1, 3, 1, 3, 1):
                cin = self._cb(cin, f if k == 1 else 2 * f, k)
            self._head(f"head{head}", self._cb(f, 2 * f), head)

    def forward(self, x: torch.Tensor) -> tuple:
        global shortcuts
        b = self._blocks()
        routes = []
        with span("detector.backbone"):
            x = next(b)(x)
            for n_res in (1, 2, 8, 8, 4):
                x = next(b)(x)
                for _ in range(n_res):
                    y = next(b)(x)
                    x = next(b)(y, skip=x)
                    shortcuts += 1
                routes.append(x)
        route8, route16 = routes[2], routes[3]
        heads = []
        branch = x
        for head, route in enumerate((None, route16, route8)):
            with span(f"detector.head{head}"):
                if route is not None:
                    branch = torch.cat([_upsample2(next(b)(branch)), route],
                                       dim=1)
                for _ in range(5):
                    branch = next(b)(branch)
                heads.append(getattr(self, f"head{head}")(next(b)(branch)))
        return self._out(*heads)


_BUILDERS = {"yolov3": YoloV3, "yolov3-tiny": YoloV3Tiny,
             "yolov2": YoloV2, "yolov2-tiny": YoloV2Tiny}
_N_HEADS = {"yolov3": 3, "yolov3-tiny": 2, "yolov2": 1, "yolov2-tiny": 1}


def build_model(spec: YoloSpec) -> _YoloNet:
    """The net of `spec`, in eval mode (torch's default initialisation:
    load parameters with `load_state_dict`)."""
    if spec.name not in _BUILDERS:
        raise ValueError(f"unknown yolo variant {spec.name!r}")
    n_heads = _N_HEADS[spec.name]
    if len(spec.anchors) != n_heads:
        raise ValueError(
            f"{spec.name} has {n_heads} heads but spec carries "
            f"{len(spec.anchors)} anchor groups (leave anchors=None for "
            f"the canonical set)")
    return _BUILDERS[spec.name](spec).eval()


def layer_shapes(spec: YoloSpec) -> list[tuple[str, tuple, bool]]:
    """(module name, HWIO kernel shape, has BatchNorm) of every conv of the
    net, in construction order; built on the meta device, so nothing is
    allocated."""
    with torch.device("meta"):
        model = build_model(spec)
    out = []
    for name, blk in model.named_children():
        co, ci, kh, kw = blk.conv.weight.shape
        out.append((name, (kh, kw, ci, co), blk.bn is not None))
    return out


def decode_head(raw: torch.Tensor, anchors: Sequence, stride: int,
                num_classes: int, input_size: int,
                cls_act: str = "softmax"):
    """Raw head [B, Hg, Wg, A*(5+C)] -> (boxes [B, N, 4] cxcywh in input
    pixels, scores [B, N], classes [B, N] int64), N = Hg*Wg*A in (cy, cx,
    anchor)-major order.

    sigmoid xy + the grid, times the stride; anchor * exp(clip(wh, -10,
    8)); score = sigmoid objectness * the largest class probability
    (softmax for the v2 lineage, sigmoid for v3, 1 when num_classes <= 1);
    the class is the first maximum."""
    b, hg, wg, _ = raw.shape
    a = len(anchors)
    raw = raw.reshape(b, hg, wg, a, 5 + num_classes)
    dev = raw.device
    gy, gx = torch.meshgrid(torch.arange(hg, dtype=torch.float32, device=dev),
                            torch.arange(wg, dtype=torch.float32, device=dev),
                            indexing="ij")
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)   # [A, 2]

    xy = torch.sigmoid(raw[..., 0:2])
    cx = (gx[None, :, :, None] + xy[..., 0]) * stride
    cy = (gy[None, :, :, None] + xy[..., 1]) * stride
    wh = torch.exp(torch.clamp(raw[..., 2:4], -10.0, 8.0)) * anc
    obj = torch.sigmoid(raw[..., 4])
    if num_classes <= 1:
        cls_prob = torch.ones(raw.shape[:-1] + (1,), dtype=torch.float32,
                              device=dev)
    elif cls_act == "sigmoid":
        cls_prob = torch.sigmoid(raw[..., 5:])
    else:
        cls_prob = torch.softmax(raw[..., 5:], dim=-1)
    best_cls = torch.argmax(cls_prob, dim=-1)
    score = obj * cls_prob.amax(dim=-1)

    n = hg * wg * a
    boxes = torch.stack([cx, cy, wh[..., 0], wh[..., 1]],
                        dim=-1).reshape(b, n, 4)
    return boxes, score.reshape(b, n), best_cls.reshape(b, n)
