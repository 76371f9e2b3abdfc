"""Detector training (counterpart of tpu_mot/parallel/train.py): the YOLO
loss, a train step over a torch optimizer, and the train state, on one
card.

The loss is standard YOLO supervision: objectness BCE over every anchor
cell, the responsible cells' box regression (sigmoid xy and raw log-wh,
squared error x5) and their class cross-entropy (softmax for the v2
lineage, per-class BCE for v3), summed over the heads.  BatchNorm trains on
batch statistics and keeps its running statistics in flax's convention
(models/yolo.ConvBlock), so a step here and a step of the JAX package from
the same state give the same loss, gradients and statistics.  The JAX step
is one jit over a batch-sharded mesh; here it is one eager step on one
device (no data parallelism).

Images come in NHWC float32, as in the JAX package; the net's NCHW
transpose happens inside `yolo_loss`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_mot_torch.models.yolo import YoloSpec, build_model, layer_shapes
from tpu_mot_torch.tracker.bank import resolve_device
from tpu_mot_torch.utils import checkpoint


class TrainState(NamedTuple):
    """The net (parameters and BatchNorm running statistics, the JAX
    package's params and batch_stats) and its optimizer (opt_state).  A
    torch optimizer is bound to the parameters it updates, so the state
    carries it, and the step needs nothing else."""
    model: nn.Module
    optimizer: torch.optim.Optimizer


def build_targets(spec: YoloSpec, gt_boxes, gt_classes, gt_valid):
    """Ground truth -> per-head dense target arrays (host side, NumPy; a
    copy of tpu_mot.parallel.train.build_targets).

    gt_boxes   : [B, M, 4] (cx, cy, w, h) in input_size pixels
    gt_classes : [B, M] int
    gt_valid   : [B, M] bool
    Returns a list over heads of tgt [B, Hg, Wg, A, 5+C]: the anchor of the
    closest area at the object's cell.  One fancy-index assignment per
    field: when two GTs fall on the same (cell, anchor) the later one wins
    the box and objectness fields and both class bits stay set.  Centres
    are clamped into the frame first, so a slightly off-frame GT cannot
    wrap to the opposite edge.
    """
    gt_boxes = np.asarray(gt_boxes, np.float32)
    gt_classes = np.asarray(gt_classes, np.int64)
    gt_valid = np.asarray(gt_valid, bool)
    s = spec.input_size
    b, _ = gt_valid.shape
    bi, mi = np.nonzero(gt_valid)
    cx = np.clip(gt_boxes[bi, mi, 0], 0.0, s - 1e-3)
    cy = np.clip(gt_boxes[bi, mi, 1], 0.0, s - 1e-3)
    w, h = gt_boxes[bi, mi, 2], gt_boxes[bi, mi, 3]
    cls = gt_classes[bi, mi]
    out = []
    for anchors, stride in zip(spec.anchors, spec.strides):
        hg = wg = s // stride
        anc = np.asarray(anchors, np.float32)          # [A, 2]
        areas = anc[:, 0] * anc[:, 1]
        tgt = np.zeros((b, hg, wg, len(anchors), 5 + spec.num_classes),
                       np.float32)
        gx = np.minimum((cx // stride).astype(np.int64), wg - 1)
        gy = np.minimum((cy // stride).astype(np.int64), hg - 1)
        ai = np.argmin(np.abs(areas[None, :] - (w * h)[:, None]), axis=1)
        tgt[bi, gy, gx, ai, 0] = cx / stride - gx
        tgt[bi, gy, gx, ai, 1] = cy / stride - gy
        tgt[bi, gy, gx, ai, 2] = np.log(np.maximum(w, 1.0) / anc[ai, 0])
        tgt[bi, gy, gx, ai, 3] = np.log(np.maximum(h, 1.0) / anc[ai, 1])
        tgt[bi, gy, gx, ai, 4] = 1.0
        tgt[bi, gy, gx, ai, 5 + cls] = 1.0
        out.append(tgt)
    return out


def yolo_loss(model: nn.Module, images: torch.Tensor, targets,
              spec: YoloSpec, train: bool = False) -> torch.Tensor:
    """Multi-head YOLO loss of `model` on images [B, s, s, 3] (NHWC float32)
    against build_targets' arrays (NumPy or tensors).

    train=True runs the net in train mode: BatchNorm normalises with the
    batch statistics and updates the running statistics in place (the JAX
    function's aux output); the net's mode is restored afterwards."""
    was_training = model.training
    model.train(train)
    try:
        heads = model(images.permute(0, 3, 1, 2))
    finally:
        model.train(was_training)
    total = 0.0
    for raw, tgt in zip(heads, targets):
        tgt = torch.as_tensor(tgt, device=raw.device)
        b, hg, wg, _ = raw.shape
        raw = raw.reshape(b, hg, wg, tgt.shape[3], -1)
        obj_tgt = tgt[..., 4]
        obj_loss = F.binary_cross_entropy_with_logits(raw[..., 4], obj_tgt)
        mask = obj_tgt[..., None]
        n_obj = mask.sum().clamp_min(1.0)
        xy_loss = ((torch.sigmoid(raw[..., 0:2]) - tgt[..., 0:2]).square()
                   * mask).sum() / n_obj
        wh_loss = ((raw[..., 2:4] - tgt[..., 2:4]).square()
                   * mask).sum() / n_obj
        cls_logits, cls_tgt = raw[..., 5:], tgt[..., 5:]
        # The class link function of decode (spec.cls_activation).
        if spec.cls_activation == "sigmoid":
            cls_ce = F.binary_cross_entropy_with_logits(
                cls_logits, cls_tgt, reduction="none").mean(-1)
        else:
            cls_ce = -(cls_tgt * F.log_softmax(cls_logits, dim=-1)).sum(-1)
        cls_loss = (cls_ce * obj_tgt).sum() / n_obj
        total = total + obj_loss + 5.0 * (xy_loss + wh_loss) + cls_loss
    return total


def make_train_step(spec: YoloSpec):
    """Returns train_step(state, images, targets) -> (state, loss): one
    gradient step of the state's optimizer on yolo_loss in train mode.  The
    state is updated in place and returned; loss is a detached 0-d tensor
    on the card (reading it waits for the step)."""
    def train_step(state: TrainState, images: torch.Tensor, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = yolo_loss(state.model, images, targets, spec, train=True)
        loss.backward()
        state.optimizer.step()
        return state, loss.detach()

    return train_step


def init_params(spec: YoloSpec, seed: int = 0) -> dict:
    """Fresh weights for `spec` as a state dict on the CPU, drawn from
    torch.Generator().manual_seed(seed) in flax's initialisation scheme:
    kernels lecun-normal (normal with variance 1/fan_in truncated at two
    standard deviations), conv biases 0, BatchNorm scale 1, bias 0, mean 0,
    variance 1.  The JAX package draws the same distributions from its own
    key, so the two packages start from different weights; to start both
    from one state use interop.numpy_yolo_params."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, (kh, kw, ci, co), has_bn in layer_shapes(spec):
        std = (1.0 / (kh * kw * ci)) ** 0.5 / 0.87962566103423978
        sd[f"{name}.conv.weight"] = nn.init.trunc_normal_(
            torch.empty((co, ci, kh, kw)), std=std, a=-2 * std, b=2 * std,
            generator=gen)
        if has_bn:
            sd[f"{name}.bn.weight"] = torch.ones(co)
            sd[f"{name}.bn.bias"] = torch.zeros(co)
            sd[f"{name}.bn.running_mean"] = torch.zeros(co)
            sd[f"{name}.bn.running_var"] = torch.ones(co)
            sd[f"{name}.bn.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
        else:
            sd[f"{name}.conv.bias"] = torch.zeros(co)
    return sd


def _refuse_int8(spec: YoloSpec) -> None:
    if spec.dtype == "int8":
        raise ValueError(
            "spec.dtype='int8' is an inference-only path (the "
            "quantization round() has zero gradient — training would "
            "silently learn nothing); train in float32/bfloat16 and "
            "serve the same params with dtype='int8'")


def train_state_from_params(spec: YoloSpec, make_optimizer: Callable,
                            params: dict, adam_state: dict | None = None,
                            device=None) -> TrainState:
    """A TrainState from a state dict: the net on `device` (the CUDA card
    unless it says otherwise), make_optimizer(model.parameters()) its
    optimizer.  adam_state, {parameter name: {"step", "exp_avg",
    "exp_avg_sq"}} (interop.yolo_train_state_from_jax), resumes an Adam
    run."""
    _refuse_int8(spec)
    device = resolve_device(device)
    with torch.device("meta"):
        model = build_model(spec)
    model = model.to_empty(device=device)
    model.load_state_dict(params)         # a copy: training never writes
    optimizer = make_optimizer(model.parameters())
    if adam_state is not None:
        for name, p in model.named_parameters():
            optimizer.state[p] = {k: v.to(p.device) if k != "step" else v
                                  for k, v in adam_state[name].items()}
    return TrainState(model, optimizer)


def init_train_state(spec: YoloSpec, make_optimizer: Callable,
                     seed: int = 0, device=None) -> TrainState:
    """A fresh TrainState: init_params(spec, seed) on `device` (the CUDA
    card unless it says otherwise) and make_optimizer(parameters), e.g.
    `lambda p: torch.optim.Adam(p, lr=1e-3)` (optax.adam(1e-3)).  int8 is
    refused, as in the JAX package."""
    return train_state_from_params(spec, make_optimizer,
                                   init_params(spec, seed), device=device)


def save_train_state(path: str, state: TrainState) -> None:
    """The net's state dict and the optimizer's into the directory `path`
    (utils.checkpoint.save_pytree)."""
    checkpoint.save_pytree(path, {"model": state.model.state_dict(),
                                  "optimizer": state.optimizer.state_dict()})


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Load what save_train_state wrote into `state` (a TrainState of the
    same spec and optimizer, e.g. a fresh init_train_state) and return it:
    the steps after it equal the steps of the run that saved it."""
    tree = checkpoint.load_pytree(path)
    state.model.load_state_dict(tree["model"])
    state.optimizer.load_state_dict(tree["optimizer"])
    return state
