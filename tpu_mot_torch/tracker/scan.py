"""Sequence-level tracking (counterpart of tpu_mot/tracker/scan.py): the
step run over a frame stack, carrying the TrackBank and stacking the
per-frame outputs.  PyTorch runs eagerly, so the JAX lax.scan is a Python
loop; on the card every frame's kernels are queued without a host sync.
`track_sequence` is the host convenience around it: NumPy frames and
per-frame detection lists in, per-frame track lists out, the clip moved to
the device chunk by chunk.  The strided scans put the detector in the loop,
run on every `stride`-th frame: frame by frame, or in one batched forward.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.models.detector import detect_batch, dets_with_classes
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import step as step_mod


def run_sequence(bank: bank_mod.TrackBank, frames: torch.Tensor,
                 dets: torch.Tensor, det_valid: torch.Tensor,
                 cfg: TrackerConfig, frame_valid: torch.Tensor | None = None
                 ) -> tuple[bank_mod.TrackBank, step_mod.StepOutput]:
    """Track a clip.

    bank        : TrackBank carry (tracker.bank.empty_bank to start).
    frames      : [N, H, W] (or [N, H, W, 3]) image stack.
    dets        : [N, D, 5|6] padded detections; det_valid [N, D] bool.
    frame_valid : optional [N] bool; a False frame is a no-op (the bank
                  carries through unchanged, its outputs are invalid), so a
                  short tail can be padded to a fixed length.
    Returns (final bank, StepOutput with every field stacked over N).
    """
    outs = []
    for i in range(frames.shape[0]):
        new_bank, out = step_mod.step(bank, frames[i], dets[i], det_valid[i],
                                      cfg)
        if frame_valid is not None:
            fv = frame_valid[i]
            new_bank = bank_mod.zip_banks(
                lambda a, b: torch.where(fv, a, b), new_bank, bank)
            out = out._replace(valid=out.valid & fv)
        bank = new_bank
        outs.append(out)
    return bank, _stack(outs)


def _stack(outs: list) -> step_mod.StepOutput:
    return step_mod.StepOutput(*[torch.stack(xs) for xs in zip(*outs)])


def _detect(model, frames, cfg, iou_thr, score_thr, nms_impl):
    """detect_batch at the tracker's capacity and frame size; under
    cfg.class_aware the class ids ride as a 6th column."""
    d, v, c = detect_batch(model, frames, (cfg.frame_height, cfg.frame_width),
                           cfg.max_detections, iou_thr, score_thr,
                           nms_impl=nms_impl)
    return (dets_with_classes(d, c) if cfg.class_aware else d), v


def run_sequence_strided_detector(bank: bank_mod.TrackBank,
                                  frames: torch.Tensor, model,
                                  cfg: TrackerConfig, stride: int,
                                  iou_thr: float = 0.45,
                                  score_thr: float = 0.3,
                                  nms_impl: str = "greedy"):
    """Detect and track a clip with the detector run on frames where
    i % stride == 0, one frame at a time (streaming arrival); the steps in
    between get no detections and the KCF correlation carries the tracks.

    model : a YOLO net (models.yolo.build_model, YoloDetector.model) on the
            frames' device.
    Both JAX lowerings (groups of `stride` frames when N divides, a
    lax.cond per frame otherwise) are this one loop.  Contract: equal to
    run_sequence fed the detections of the stride frames and none
    elsewhere.  Returns (final bank, StepOutput stacked over N)."""
    w_cols = 6 if cfg.class_aware else 5
    empty_d = torch.zeros((cfg.max_detections, w_cols), dtype=torch.float32,
                          device=frames.device)
    empty_v = torch.zeros((cfg.max_detections,), dtype=torch.bool,
                          device=frames.device)
    outs = []
    for i in range(frames.shape[0]):
        if i % stride == 0:
            d, v = _detect(model, frames[i:i + 1], cfg, iou_thr, score_thr,
                           nms_impl)
            d, v = d[0], v[0]
        else:
            d, v = empty_d, empty_v
        bank, out = step_mod.step(bank, frames[i], d, v, cfg)
        outs.append(out)
    return bank, _stack(outs)


def run_sequence_strided_batched(bank: bank_mod.TrackBank,
                                 frames: torch.Tensor, model,
                                 cfg: TrackerConfig, stride: int,
                                 iou_thr: float = 0.45,
                                 score_thr: float = 0.3,
                                 nms_impl: str = "greedy"):
    """run_sequence_strided_detector for a chunk that is all there: the
    detector frames (i % stride == 0) run as ONE batched forward, their
    detections are scattered into a zeroed [N, D, 5|6] buffer, and
    run_sequence tracks the chunk.  The same result up to float noise (the
    forward is per sample at inference), at the batched forward's cost."""
    n = frames.shape[0]
    d, v = _detect(model, frames[::stride], cfg, iou_thr, score_thr,
                   nms_impl)
    dets = torch.zeros((n,) + tuple(d.shape[1:]), dtype=torch.float32,
                       device=frames.device)
    valid = torch.zeros((n, cfg.max_detections), dtype=torch.bool,
                        device=frames.device)
    dets[::stride] = d
    valid[::stride] = v
    return run_sequence(bank, frames, dets, valid, cfg)


def track_sequence(frames, detections, cfg: TrackerConfig | None = None,
                   bank: bank_mod.TrackBank | None = None,
                   chunk: int | None = None, device=None):
    """NumPy frames + per-frame detection lists -> tracks.

    detections: sequence of [D_f, 4|5|6] arrays; a 6th column anywhere in
    the clip (a detector class id, cfg.class_aware) widens the whole buffer
    (5-column frames then carry class 0).
    chunk: frames moved to the device and tracked at a time (bounds device
    memory for long clips); a short last chunk is padded to the chunk
    length with masked no-op frames, as in the JAX package.
    device: where it runs when no bank is given: the CUDA card unless it
    says otherwise (device="cpu" for the CPU); with a bank, the bank's.
    Returns (final bank, list over frames of [(id, (cx, cy, w, h), score)],
    StepOutput of NumPy arrays stacked over the frames; None for an empty
    clip).
    """
    from tpu_mot_torch.tracker.api import pad_detections

    cfg = cfg or TrackerConfig()
    if bank is None:
        bank = bank_mod.empty_bank(cfg, device=device)
    dev = bank.state.device
    n = len(frames)
    if n == 0:
        return bank, [], None
    w_cols = max((np.asarray(detections[f]).shape[-1] for f in range(n)
                  if np.asarray(detections[f]).ndim == 2
                  and len(detections[f])), default=5)
    w_cols = 6 if w_cols >= 6 else 5
    d = np.zeros((n, cfg.max_detections, w_cols), np.float32)
    v = np.zeros((n, cfg.max_detections), bool)
    for f in range(n):
        df, v[f] = pad_detections(detections[f], cfg.max_detections)
        d[f, :, : df.shape[-1]] = df

    outs = []
    chunk = chunk or n
    frames = np.asarray(frames)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        pad = chunk - (hi - lo)
        fv = None
        f_c, d_c, v_c = frames[lo:hi], d[lo:hi], v[lo:hi]
        if pad:
            fv = torch.arange(chunk, device=dev) < hi - lo
            f_c, d_c, v_c = (np.concatenate(
                [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
                for a in (f_c, d_c, v_c))
        bank, out = run_sequence(
            bank, torch.as_tensor(f_c, device=dev),
            torch.as_tensor(d_c, device=dev),
            torch.as_tensor(v_c, device=dev), cfg, frame_valid=fv)
        outs.append([x[: hi - lo].cpu().numpy() for x in out])
    stacked = step_mod.StepOutput(*[np.concatenate(xs, 0)
                                    for xs in zip(*outs)])
    return bank, unpack_outputs(stacked, n), stacked


def unpack_outputs(stacked: step_mod.StepOutput, n: int):
    """Stacked StepOutput (tensors or NumPy arrays) -> per-frame
    [(id, (cx, cy, w, h), score)]."""
    ids, boxes, scores, valid = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (stacked.ids, stacked.boxes, stacked.scores, stacked.valid))
    tracks = []
    for f in range(n):
        sel = np.where(valid[f])[0]
        tracks.append([(int(ids[f, i]), tuple(float(x) for x in boxes[f, i]),
                        float(scores[f, i])) for i in sel])
    return tracks
