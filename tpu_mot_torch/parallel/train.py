"""Detector training (counterpart of tpu_mot/parallel/train.py): the YOLO
loss, a train step over a torch optimizer, and the train state, on one
card.

The loss is standard YOLO supervision: objectness BCE over every anchor
cell, the responsible cells' box regression (sigmoid xy and raw log-wh,
squared error x5) and their class cross-entropy (softmax for the v2
lineage, per-class BCE for v3), summed over the heads.  BatchNorm trains on
batch statistics and keeps its running statistics in flax's convention
(models/yolo.ConvBlock), so a step here and a step of the JAX package from
the same state give the same loss, gradients and statistics.

Data parallelism: the JAX step is one jit over a "batch"-sharded mesh, so
GSPMD computes the step of the global batch: global BatchNorm statistics,
global loss normalisers, a gradient sum.  Here `make_train_step(spec,
mesh)` does the same over a "batch" mesh of ranks (parallel/mesh.py), each
rank holding B/n images of the global batch of B:
  * BatchNorm statistics come from per-channel sums all-reduced by a
    differentiable collective (batch_stats_over sets it on every
    models/yolo.ConvBlock), so the backward pass and the running statistics
    see the global values;
  * the loss is per-head sums over counts (anchor cells, responsible
    cells); under a mesh the counts are all-reduced, so each rank's loss is
    its share of the global loss and the shares sum to it;
  * the gradients are then summed over the ranks (all-reduce SUM, not
    DDP's average, which would need the shares scaled by n), and every
    rank takes the same optimizer step;
  * the state is replicated: init_train_state and train_state_from_params
    broadcast rank 0's parameters, buffers and optimizer state, and the
    ranks stay bit-identical.
No nn.SyncBatchNorm (torch's unbiased running variance and momentum) and
no DDP: flax's BatchNorm is computed by hand (models/yolo.ConvBlock).

Images come in NHWC float32, as in the JAX package; the net's NCHW
transpose happens inside `yolo_loss`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_mot_torch.models.yolo import (ConvBlock, YoloSpec, build_model,
                                       layer_shapes)
from tpu_mot_torch.parallel import mesh as mesh_mod
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


def _class_ce(cls_logits: torch.Tensor, cls_tgt: torch.Tensor,
              spec: YoloSpec) -> torch.Tensor:
    """Per-cell class cross-entropy through decode's class link function
    (spec.cls_activation): per-class BCE averaged (v3), softmax CE (v2)."""
    if spec.cls_activation == "sigmoid":
        return F.binary_cross_entropy_with_logits(
            cls_logits, cls_tgt, reduction="none").mean(-1)
    return -(cls_tgt * F.log_softmax(cls_logits, dim=-1)).sum(-1)


@contextlib.contextmanager
def batch_stats_over(model: nn.Module, mesh, n_images: int):
    """For the duration of the block, every ConvBlock of `model` in train
    mode normalises with the statistics of the global batch of n_images
    images spread over `mesh`'s ranks: its per-channel sums go through a
    differentiable all-reduce (ConvBlock.stats_over)."""
    blocks = [m for m in model.modules() if isinstance(m, ConvBlock)]
    for b in blocks:
        b.stats_over = (
            lambda t: mesh_mod.all_reduce_sum(t, mesh, grad=True), n_images)
    try:
        yield
    finally:
        for b in blocks:
            b.stats_over = None


def yolo_loss(model: nn.Module, images: torch.Tensor, targets,
              spec: YoloSpec, train: bool = False,
              mesh=None) -> torch.Tensor:
    """Multi-head YOLO loss of `model` on images [B, s, s, 3] (NHWC float32)
    against build_targets' arrays (NumPy or tensors): per head, the
    objectness BCE summed over the anchor cells over their count, and the
    box and class terms summed over the responsible cells over theirs.

    train=True runs the net in train mode: BatchNorm normalises with the
    batch statistics and updates the running statistics in place (the JAX
    function's aux output); the net's mode is restored afterwards.

    Over a "batch" mesh, images and targets are this rank's block of the
    global batch, and the result is this rank's share of the global loss:
    BatchNorm (train mode) normalises with the global batch's statistics
    and the counts are all-reduced, so the shares of all ranks sum to the
    one-process loss of the global batch."""
    was_training = model.training
    model.train(train)
    try:
        if mesh is not None and train:
            n_images = int(mesh_mod.all_reduce_sum(
                torch.tensor([images.shape[0]]), mesh))
            stats = batch_stats_over(model, mesh, n_images)
        else:
            stats = contextlib.nullcontext()
        with stats:
            heads = model(images.permute(0, 3, 1, 2))
    finally:
        model.train(was_training)
    sums, counts = [], []
    for raw, tgt in zip(heads, targets):
        tgt = torch.as_tensor(tgt, device=raw.device)
        b, hg, wg, _ = raw.shape
        raw = raw.reshape(b, hg, wg, tgt.shape[3], -1)
        obj_tgt = tgt[..., 4]
        mask = obj_tgt[..., None]
        sums.append((
            F.binary_cross_entropy_with_logits(raw[..., 4], obj_tgt,
                                               reduction="sum"),
            ((torch.sigmoid(raw[..., 0:2]) - tgt[..., 0:2]).square()
             * mask).sum(),
            ((raw[..., 2:4] - tgt[..., 2:4]).square() * mask).sum(),
            (_class_ce(raw[..., 5:], tgt[..., 5:], spec) * obj_tgt).sum()))
        counts += [obj_tgt.new_tensor(float(obj_tgt.numel())),
                   obj_tgt.sum()]
    counts = torch.stack(counts)
    if mesh is not None:
        counts = mesh_mod.all_reduce_sum(counts, mesh)
    total = 0.0
    for h, (obj, xy, wh, cls) in enumerate(sums):
        n_cells, n_obj = counts[2 * h], counts[2 * h + 1].clamp_min(1.0)
        total = (total + obj / n_cells + 5.0 * (xy / n_obj + wh / n_obj)
                 + cls / n_obj)
    return total


def _sum_gradients(model: nn.Module, mesh) -> None:
    """Every parameter's gradient summed over the mesh's ranks, in one
    all-reduce of the flattened gradients."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = mesh_mod.all_reduce_sum(
        torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def make_train_step(spec: YoloSpec, mesh=None):
    """Returns train_step(state, images, targets) -> (state, loss): one
    gradient step of the state's optimizer on yolo_loss in train mode.  The
    state is updated in place and returned; loss is a detached 0-d tensor
    on the card (reading it waits for the step).

    Over a "batch" mesh each rank passes its block of the global batch
    (images and targets) and its state built with the same mesh
    (replicated); the step is the one-process step of the global batch:
    global BatchNorm statistics, this rank's share of the loss, the
    gradients summed over the ranks.  The loss returned is the global
    one."""
    def train_step(state: TrainState, images: torch.Tensor, targets):
        state.optimizer.zero_grad(set_to_none=True)
        loss = yolo_loss(state.model, images, targets, spec, train=True,
                         mesh=mesh)
        loss.backward()
        if mesh is not None:
            _sum_gradients(state.model, mesh)
            loss = mesh_mod.all_reduce_sum(loss, mesh)
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
                            device=None, mesh=None) -> TrainState:
    """A TrainState from a state dict: the net on `device` (the CUDA card
    unless it says otherwise), make_optimizer(model.parameters()) its
    optimizer.  adam_state, {parameter name: {"step", "exp_avg",
    "exp_avg_sq"}} (interop.yolo_train_state_from_jax), resumes an Adam
    run.  With a "batch" mesh every rank gets rank 0's parameters, buffers
    and optimizer state (broadcast): the replicated state of
    make_train_step(spec, mesh)."""
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
    if mesh is not None:
        for t in model.state_dict().values():
            mesh_mod.broadcast_(t, mesh)
        for st in optimizer.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    mesh_mod.broadcast_(v, mesh)
    return TrainState(model, optimizer)


def init_train_state(spec: YoloSpec, make_optimizer: Callable,
                     seed: int = 0, device=None, mesh=None) -> TrainState:
    """A fresh TrainState: init_params(spec, seed) on `device` (the CUDA
    card unless it says otherwise) and make_optimizer(parameters), e.g.
    `lambda p: torch.optim.Adam(p, lr=1e-3)` (optax.adam(1e-3)); with a
    "batch" mesh, rank 0's on every rank.  int8 is refused, as in the JAX
    package."""
    return train_state_from_params(spec, make_optimizer,
                                   init_params(spec, seed), device=device,
                                   mesh=mesh)


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
