"""The detector (counterpart of tpu_mot/models/detector.py): preprocess ->
YOLO forward -> decode -> class-wise NMS over a batch of frames, all on the
frames' device, with the output padded to the tracker's detection
capacity; plus darknet .weights loading and checkpoints in the JAX
package's .npz layout, so a detector saved by either package loads in the
other.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

from tpu_mot_torch import interop
from tpu_mot_torch.models.yolo import (YoloSpec, build_model, decode_head,
                                       layer_shapes)
from tpu_mot_torch.ops.nms import nms_classwise
from tpu_mot_torch.tracker.bank import resolve_device
from tpu_mot_torch.utils.profiling import span

# Candidates decoded by decode_frames, B x sum of Hg x Wg x A a call (22,743
# a frame for yolov3 at 608), read by tests and the benchmark's traced runs.
candidates = 0


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear resize of [B, C, H, W] to size x size, antialiased where it
    shrinks: jax.image.resize(..., "bilinear") does the same.  The CPU has
    no bfloat16 antialiased resize; there it runs in float32 and the
    result is rounded to bfloat16."""
    dt = x.dtype
    if dt == torch.bfloat16 and x.device.type == "cpu":
        x = x.float()
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True).to(dt)


def _check_device(model, frames: torch.Tensor) -> None:
    dev = next(model.parameters()).device
    if dev != frames.device:
        raise ValueError(f"frames on {frames.device}, detector on {dev}: "
                         "the detector runs on the frames' device")


def preprocess(frames: torch.Tensor, spec: YoloSpec) -> torch.Tensor:
    """frames [B, H, W] (gray) or [B, H, W, 3], uint8 or float -> the net's
    input [B, 1|3, s, s] float32, s = spec.input_size: uint8 divided by
    255, then the antialiased bilinear resize, in bfloat16 when the net
    computes in it.  A gray frame stays one channel (the first conv sums
    its kernel over the input channels)."""
    pre = torch.bfloat16 if spec.dtype == "bfloat16" else torch.float32
    f = frames.to(pre)
    if frames.dtype == torch.uint8:
        f = f / 255.0
    x = f[:, None] if f.ndim == 3 else f.permute(0, 3, 1, 2)
    return _resize(x, spec.input_size).float()


@torch.no_grad()
def decode_frames(model, frames: torch.Tensor, frame_hw: tuple):
    """Every candidate of a frame batch before NMS: frames as preprocess()
    takes them -> (boxes [B, N, 4] cxcywh in FRAME pixels, scores [B, N],
    classes [B, N] int64) for the net `model` (models.yolo.build_model;
    its spec is model.spec)."""
    global candidates
    _check_device(model, frames)
    spec = model.spec
    s = spec.input_size
    with span("detector.preprocess"):
        x = preprocess(frames, spec)
    with span("detector.forward"):
        heads = model(x)
    with span("detector.decode"):
        parts = [decode_head(head, anchors, stride, spec.num_classes, s,
                             cls_act=spec.cls_activation)
                 for head, anchors, stride in zip(heads, spec.anchors,
                                                   spec.strides)]
        boxes, scores, classes = (torch.cat(p, dim=1) for p in zip(*parts))
        candidates += scores.numel()
        h, w = frame_hw
        scale = torch.tensor([w / s, h / s, w / s, h / s],
                             dtype=torch.float32, device=boxes.device)
        return boxes * scale, scores, classes


@torch.no_grad()
def detect_batch(model, frames: torch.Tensor, frame_hw: tuple,
                 max_out: int = 64, iou_thr: float = 0.45,
                 score_thr: float = 0.3, nms_impl: str = "greedy",
                 pre_top_k: int | None = None):
    """frames [B, H, W] or [B, H, W, 3] -> padded detections on the frames'
    device: (dets [B, max_out, 5] (cx, cy, w, h, score) in frame pixels,
    valid [B, max_out] bool, classes [B, max_out] int32, -1 where
    invalid).

    nms_impl: "greedy" (ops.nms.nms) or "fast" (ops.nms.fast_nms);
    pre_top_k: the NMS candidate cut (>= the anchor count for exact greedy
    NMS).  Invalid slots carry candidate 0's box with score 0, as in JAX."""
    with span("detector.detect"):
        boxes, scores, classes = decode_frames(model, frames, frame_hw)
        with span("detector.nms"):
            idx, valid = nms_classwise(boxes, scores, classes, max_out,
                                       iou_thr, score_thr, impl=nms_impl,
                                       pre_top_k=pre_top_k)
            safe = idx.long().clamp(0, boxes.shape[1] - 1)
            out_boxes = boxes.gather(1, safe[..., None].expand(-1, -1, 4))
            out_scores = torch.where(valid, scores.gather(1, safe), 0.0)
            dets = torch.cat([out_boxes, out_scores[..., None]], dim=-1)
            cls = torch.where(valid, classes.gather(1, safe),
                              -1).to(torch.int32)
            return dets, valid, cls


def dets_with_classes(dets: torch.Tensor,
                      classes: torch.Tensor) -> torch.Tensor:
    """[..., D, 5] detections + [..., D] class ids -> [..., D, 6], the form
    tracker.step takes under cfg.class_aware (ids < 2^24 are exact in
    float32)."""
    return torch.cat([dets, classes[..., None].to(dets.dtype)], dim=-1)


class YoloDetector:
    """Host-facing detector with the JAX package's surface; on the CUDA
    card unless `device` says otherwise.

    >>> det = YoloDetector.random_init(YoloSpec("yolov3-tiny"), seed=0)
    >>> dets, valid, classes = det.detect(frames)        # [B, H, W(,3)]

    params: the net's state dict (interop.yolo_params_from_jax converts a
    flax tree).
    """

    def __init__(self, spec: YoloSpec, params: dict, max_out: int = 64,
                 iou_thr: float = 0.45, score_thr: float = 0.3,
                 nms_impl: str = "greedy", device=None):
        self.spec = spec
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = build_model(spec)
        model.load_state_dict(params, assign=True)
        self.model = model.to(self.device)
        self.max_out = max_out
        self.iou_thr = iou_thr
        self.score_thr = score_thr
        self.nms_impl = nms_impl

    @classmethod
    def random_init(cls, spec: YoloSpec, seed: int = 0, **kw):
        """Weights from interop.numpy_yolo_params(spec, seed): the same
        seed gives the same weights on every device and in both
        packages."""
        return cls(spec, interop.yolo_params_from_jax(
            interop.numpy_yolo_params(spec, seed)), **kw)

    @classmethod
    def from_darknet(cls, spec: YoloSpec, weights_path: str, **kw):
        return cls(spec, load_darknet_weights(spec, weights_path), **kw)

    def detect(self, frames):
        """frames: one frame [H, W] / [H, W, 1|3] or a batch, NumPy or
        tensor -> NumPy (dets, valid, classes), without the batch axis for
        one frame."""
        frames = torch.as_tensor(frames, device=self.device)
        squeeze = frames.ndim == 2 or (frames.ndim == 3
                                       and frames.shape[-1] in (1, 3))
        if squeeze:
            frames = frames[None]
        if frames.ndim == 4 and frames.shape[-1] == 1:
            frames = frames[..., 0]
        hw = (int(frames.shape[1]), int(frames.shape[2]))
        out = detect_batch(self.model, frames, hw, self.max_out,
                           self.iou_thr, self.score_thr, self.nms_impl)
        out = [x.cpu().numpy() for x in out]
        return tuple(x[0] for x in out) if squeeze else tuple(out)

    # -- checkpoints, in the JAX package's .npz layout -----------------
    def save(self, path: str) -> None:
        """np.savez with jax.tree_util.keystr keys of the flax tree
        (e.g. "['params']['ConvBlock_0']['conv']['kernel']"), HWIO
        kernels: tpu_mot's YoloDetector.load reads it."""
        flat = {}

        def walk(prefix, node):
            for k, v in node.items():
                key = f"{prefix}[{k!r}]"
                if isinstance(v, dict):
                    walk(key, v)
                else:
                    flat[key] = v

        walk("", interop.yolo_params_to_jax(self.model.state_dict()))
        np.savez(path, **flat)

    @classmethod
    def load(cls, spec: YoloSpec, path: str, **kw):
        """A checkpoint written by save() here or by tpu_mot's
        YoloDetector.save."""
        tree = {}
        with np.load(path) as data:
            for key in data.files:
                parts = re.findall(r"\['([^']*)'\]", key)
                node = tree
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = data[key]
        return cls(spec, interop.yolo_params_from_jax(tree), **kw)


def _conv_layers_in_call_order(spec: YoloSpec):
    """The module names in darknet's .weights order, with their BatchNorm
    flags (tpu_mot.models.detector._conv_layers_in_call_order)."""
    if spec.name == "yolov3-tiny":
        # convs 16..1024 + 256 (1x1) are ConvBlock_0..7, then the 512 head
        # conv (ConvBlock_8), head0, 128 (1x1) (ConvBlock_9), 256
        # (ConvBlock_10), head1.
        order = ([f"ConvBlock_{i}" for i in range(9)]
                 + ["head0", "ConvBlock_9", "ConvBlock_10", "head1"])
        bn = [True] * 9 + [False, True, True, False]
        return list(zip(order, bn))
    if spec.name == "yolov2-tiny":
        names = [f"ConvBlock_{i}" for i in range(8)] + ["head0"]
        return list(zip(names, [True] * 8 + [False]))
    if spec.name == "yolov2":
        # darknet-19 (18 convs), detection convs 19/20, the 64-channel 1x1
        # passthrough conv, the post-concat 1024 conv, the linear head.
        names = [f"ConvBlock_{i}" for i in range(22)] + ["head0"]
        return list(zip(names, [True] * 22 + [False]))
    if spec.name == "yolov3":
        # darknet-53 (52 convs) + convset A (5) + the 1024 pre-head conv,
        # head0; the 256 upsample conv, convset B, the 512 pre-head conv,
        # head1; the 128 upsample conv, convset C, the 256 pre-head conv,
        # head2.
        return ([(f"ConvBlock_{i}", True) for i in range(58)]
                + [("head0", False)]
                + [(f"ConvBlock_{i}", True) for i in range(58, 65)]
                + [("head1", False)]
                + [(f"ConvBlock_{i}", True) for i in range(65, 72)]
                + [("head2", False)])
    raise ValueError(spec.name)


def load_darknet_weights(spec: YoloSpec, path: str) -> dict:
    """Parse a darknet .weights file -> the net's state dict.

    Format: int32 header (major, minor, revision), then `seen` as int64
    when major * 10 + minor >= 2 (else int32), then flat float32 arrays
    per conv layer: [bn_beta, bn_gamma, bn_mean, bn_var] (or the bias when
    there is no BatchNorm), then the kernel in OIHW order.  The file is
    parsed into the flax-layout tree and converted."""
    shapes = {name: shape for name, shape, _ in layer_shapes(spec)}
    with open(path, "rb") as f:
        major, minor, _rev = np.fromfile(f, np.int32, 3)
        if major * 10 + minor >= 2:
            np.fromfile(f, np.int64, 1)     # seen
        else:
            np.fromfile(f, np.int32, 1)
        data = np.fromfile(f, np.float32)

    pos = 0

    def take(n):
        nonlocal pos
        out = data[pos:pos + n]
        if len(out) != n:
            raise ValueError("darknet weight file truncated")
        pos += n
        return out

    params, stats = {}, {}
    for name, use_bn in _conv_layers_in_call_order(spec):
        kh, kw, ci, co = shapes[name]
        conv = params.setdefault(name, {}).setdefault("conv", {})
        if use_bn:
            bias, scale = take(co), take(co)
            params[name]["bn"] = {"bias": bias, "scale": scale}
            stats[name] = {"bn": {"mean": take(co), "var": take(co)}}
        else:
            conv["bias"] = take(co)
        w = take(kh * kw * ci * co).reshape(co, ci, kh, kw)
        conv["kernel"] = np.transpose(w, (2, 3, 1, 0))   # OIHW -> HWIO
    if pos != len(data):
        raise ValueError(f"darknet weight file has {len(data) - pos} "
                         "unconsumed floats — topology mismatch")
    return interop.yolo_params_from_jax({"params": params,
                                         "batch_stats": stats})
