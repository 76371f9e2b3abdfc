"""Multi-stream serving on one card (counterpart of
tpu_mot/parallel/serve.py).

BASELINE.json configs[4] is "8 concurrent 1080p streams sharded across a
v5e-8, shared detector batch".  On one card the streams share the card:

  * the banks of S streams are one TrackBank whose every field has a
    leading [S] (`make_stream_banks`), and one step of all streams is one
    set of launches (`tracker.step.step_streams`: per-track math on
    [S*T] rows, the ROI kernels with a frame index, the auction kernel
    over a batch of S problems).  The JAX package gets the same from
    jax.vmap(step); stream s's results are those of the single-stream
    step on stream s.
  * the detector runs as ONE batched forward over all streams' frames.
    On one card there is nothing to gather: the JAX package's
    shared-detector mode (all-gather, one forward, scatter) and its
    per-shard data-parallel mode are the same single batched forward.
    Both names are kept (`shared_detector_detect`,
    `detect_then_track_step_shared`) so that a reader finds each
    counterpart.

There is no mesh: the JAX package's `mesh` arguments, `parallel/mesh.py`
and `dryrun_shared_detector` belong to its multi-chip contract.

detect_fn(model, frames [S, H, W]) -> (dets [S, D, 5], valid [S, D],
classes [S, D]); typically models.detector.detect_batch closed over its
arguments.
"""

from __future__ import annotations

import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.models.detector import dets_with_classes
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import step as step_mod


def make_stream_banks(n_streams: int, cfg: TrackerConfig,
                      device=None) -> bank_mod.TrackBank:
    """One empty TrackBank per stream, stacked on a leading [n_streams]
    axis, on `device` (default: the CUDA card; see bank.resolve_device)."""
    one = bank_mod.empty_bank(cfg, device=device)
    return bank_mod.map_bank(
        lambda x: x[None].expand((n_streams,) + x.shape).clone(), one)


def _fold_classes(dets, classes, cfg: TrackerConfig):
    """Append the detector class column under cfg.class_aware (the [.., 6]
    detection form the step's class gate consumes)."""
    if not cfg.class_aware:
        return dets
    return dets_with_classes(dets, classes)


def _stack(outs: list) -> step_mod.StepOutput:
    """Per-frame StepOutputs of S streams -> fields stacked [S, N, ...]."""
    return step_mod.StepOutput(*[torch.stack(xs, dim=1)
                                 for xs in zip(*outs)])


def multi_stream_step(banks: bank_mod.TrackBank, frames: torch.Tensor,
                      dets: torch.Tensor, det_valid: torch.Tensor,
                      cfg: TrackerConfig):
    """One tracking frame for every stream.

    banks     : TrackBank with a leading [S] axis (make_stream_banks).
    frames    : [S, H, W] (or [S, H, W, 3]).
    dets      : [S, D, 5|6], det_valid [S, D].
    Returns (banks, StepOutput with a leading [S])."""
    return step_mod.step_streams(banks, frames, dets, det_valid, cfg)


def multi_stream_sequence(banks: bank_mod.TrackBank, frames: torch.Tensor,
                          dets: torch.Tensor, det_valid: torch.Tensor,
                          cfg: TrackerConfig):
    """Track a clip per stream: frames [S, N, H, W], dets [S, N, D, 5|6],
    det_valid [S, N, D] -> (banks, StepOutput stacked [S, N, ...])."""
    outs = []
    for i in range(frames.shape[1]):
        banks, out = multi_stream_step(banks, frames[:, i], dets[:, i],
                                       det_valid[:, i], cfg)
        outs.append(out)
    return banks, _stack(outs)


def multi_stream_sequence_strided(model, banks: bank_mod.TrackBank,
                                  frames: torch.Tensor, cfg: TrackerConfig,
                                  detect_fn, stride: int):
    """Strided-detector serving over a chunk of multi-stream frames.

    frames [N, S, H, W] (time-major); the detector runs on the frames with
    i % stride == 0, one batched forward over that frame's S streams, and
    the steps in between get empty detections (the KCF correlation carries
    the tracks).  N must be a positive multiple of stride (serving chunks
    are sized by the caller), as in the JAX package's grouped lowering.
    Returns (banks, StepOutput stacked [S, N, ...]), the axis order of
    multi_stream_sequence, which it equals when fed the same detections.
    """
    n = frames.shape[0]
    if stride < 1 or n % stride:
        raise ValueError(
            f"chunk length {n} must be a positive multiple of "
            f"stride {stride}")
    s_streams = frames.shape[1]
    d_cap = cfg.max_detections
    empty_d = torch.zeros((s_streams, d_cap, 6 if cfg.class_aware else 5),
                          dtype=torch.float32, device=frames.device)
    empty_v = torch.zeros((s_streams, d_cap), dtype=torch.bool,
                          device=frames.device)
    outs = []
    for i in range(n):
        if i % stride == 0:
            d, v, c = detect_fn(model, frames[i])
            d = _fold_classes(d, c, cfg)
        else:
            d, v = empty_d, empty_v
        banks, out = multi_stream_step(banks, frames[i], d, v, cfg)
        outs.append(out)
    return banks, _stack(outs)


def detect_then_track_step(model, banks: bank_mod.TrackBank,
                           frames: torch.Tensor, cfg: TrackerConfig,
                           detect_fn):
    """The fused detect -> track serving step: one batched detector
    forward over the S streams' frames [S, H, W], then every stream's
    tracker on its own detections."""
    dets, valid, cls = detect_fn(model, frames)
    return multi_stream_step(banks, frames, _fold_classes(dets, cls, cfg),
                             valid, cfg)


def shared_detector_detect(model, frames: torch.Tensor, detect_fn,
                           with_classes: bool = False):
    """The shared detector batch of configs[4]: one batched forward over
    every stream's frames [S, H, W].  The JAX package gathers the frames of
    all chips first and scatters the detections back; on one card they
    are already together, so this is the data-parallel forward itself.
    Returns (dets [S, D, 5], valid [S, D]); with_classes appends the class
    column ([S, D, 6], the cfg.class_aware form)."""
    dets, valid, cls = detect_fn(model, frames)
    if with_classes:
        dets = dets_with_classes(dets, cls)
    return dets, valid


def detect_then_track_step_shared(model, banks: bank_mod.TrackBank,
                                  frames: torch.Tensor, cfg: TrackerConfig,
                                  detect_fn):
    """The fused serving step with the shared detector batch (on one card
    the same forward as detect_then_track_step)."""
    dets, valid = shared_detector_detect(model, frames, detect_fn,
                                         with_classes=cfg.class_aware)
    return multi_stream_step(banks, frames, dets, valid, cfg)
