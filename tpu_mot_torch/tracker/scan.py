"""Sequence-level tracking (counterpart of tpu_mot/tracker/scan.py): the
step run over a frame stack, carrying the TrackBank and stacking the
per-frame outputs.  PyTorch runs eagerly, so the JAX lax.scan is a Python
loop; on the card every frame's kernels are queued without a host sync.
`track_sequence` is the host convenience around it: NumPy frames and
per-frame detection lists in, per-frame track lists out, the clip moved to
the device chunk by chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mot_torch.config import TrackerConfig
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
    stacked = step_mod.StepOutput(*[torch.stack(xs) for xs in zip(*outs)])
    return bank, stacked


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
