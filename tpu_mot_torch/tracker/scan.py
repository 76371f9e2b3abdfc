"""Sequence-level tracking (counterpart of tpu_mot/tracker/scan.py): the
step run over a frame stack, carrying the TrackBank and stacking the
per-frame outputs.  PyTorch runs eagerly, so the JAX lax.scan is a Python
loop; on the card every frame's kernels are queued without a host sync.
"""

from __future__ import annotations

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
