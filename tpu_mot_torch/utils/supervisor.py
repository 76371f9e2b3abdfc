"""Per-stream failure supervision (counterpart of
tpu_mot/utils/supervisor.py).

A stream's tracker state is one TrackBank, so supervision is cheap:

  * periodic snapshots of the bank (host copies),
  * NaN / explosion detection on step outputs,
  * automatic rollback-and-reinit when a step raises or produces garbage.

The supervisor never raises on a stream: a failed frame counts one
failure (`failures`) and the stream goes on from its last snapshot.  A
caller that must not let a fault of the device hide behind a recovery
reads that counter.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import step as step_mod


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def output_healthy(out, frame_hw) -> bool:
    """Cheap per-frame health check on a StepOutput (tensors or arrays):
    every box finite, and no valid track's centre over ten frame sizes
    away."""
    boxes = _np(out.boxes)
    if not np.isfinite(boxes).all():
        return False
    h, w = frame_hw
    valid = _np(out.valid)
    if valid.any():
        b = boxes[valid]
        if ((np.abs(b[:, 0]) > 10 * w).any()
                or (np.abs(b[:, 1]) > 10 * h).any()):
            return False
    return True


class StreamSupervisor:
    """Wraps the per-frame step with snapshot / health-check / recover.

    >>> sup = StreamSupervisor(cfg)             # on the card by default
    >>> out = sup.step(frame, dets, det_valid)   # never raises on stream
    ...                                           # corruption; recovers
    >>> sup.failures                              # observability counter
    """

    def __init__(self, cfg: TrackerConfig, snapshot_every: int = 30,
                 device=None):
        self.cfg = cfg
        self.snapshot_every = snapshot_every
        self.device = bank_mod.resolve_device(device)
        self.bank = bank_mod.empty_bank(cfg, device=self.device)
        self._snap()
        self.frame_idx = 0
        self.failures = 0
        self.last_recovery_frame = -1

    def _snap(self):
        self._snapshot = bank_mod.map_bank(
            lambda x: x.detach().to("cpu", copy=True), self.bank)

    def _restore(self):
        self.bank = bank_mod.map_bank(lambda x: x.to(self.device),
                                      self._snapshot)

    def _step(self, frame, dets, det_valid):
        return step_mod.step(self.bank, frame, dets, det_valid, self.cfg)

    def _healthy(self, out) -> bool:
        return output_healthy(out, (self.cfg.frame_height,
                                    self.cfg.frame_width))

    def step(self, frame, dets, det_valid):
        """One frame (arrays or tensors; moved to the supervisor's device):
        frame [H, W], dets [D, 5|6], det_valid [D] -> StepOutput."""
        frame, dets, det_valid = (torch.as_tensor(x, device=self.device)
                                  for x in (frame, dets, det_valid))
        try:
            new_bank, out = self._step(frame, dets, det_valid)
            if not self._healthy(out):
                raise FloatingPointError("unhealthy tracker output")
            self.bank = new_bank
        except Exception:
            # Roll back to the last good snapshot and re-seed from the
            # current detections (tracker state is ephemeral by design:
            # recovery costs one frame of tentative tracks).  One failed
            # frame counts ONE failure however many recovery stages it
            # takes: the counter an operator alarms on means "frames
            # affected", not "recovery attempts".
            self.failures += 1
            self.last_recovery_frame = self.frame_idx
            self._restore()
            try:
                new_bank, out = self._step(frame, dets, det_valid)
                healthy = self._healthy(out)
            except Exception:
                new_bank, out, healthy = None, None, False
            if healthy:
                self.bank = new_bank
            else:
                # The fault is in the inputs (e.g. a NaN frame), not the
                # state: keep the restored snapshot, skip this frame, and
                # emit an empty output; persisting the corrupt retry bank
                # would defeat the health gate.
                try:
                    self.bank, out = self._step(torch.zeros_like(frame),
                                                torch.zeros_like(dets),
                                                torch.zeros_like(det_valid))
                except Exception:
                    # Persistent device fault: even the zero-input step
                    # failed.  Synthesize an empty host-side output so the
                    # "never raises on stream" contract survives (the next
                    # frame retries normally).
                    t = self.cfg.max_tracks
                    i32 = dict(dtype=torch.int32)
                    out = step_mod.StepOutput(
                        ids=torch.full((t,), -1, **i32),
                        boxes=torch.zeros((t, 4)),
                        scores=torch.zeros((t,)),
                        valid=torch.zeros((t,), dtype=torch.bool),
                        matched_det=torch.full((t,), -1, **i32),
                        cls=torch.full((t,), -1, **i32),
                        n_alive=torch.zeros((), **i32),
                        n_births=torch.zeros((), **i32),
                        n_deaths=torch.zeros((), **i32),
                        n_matches=torch.zeros((), **i32),
                        assign_iters=torch.zeros((), **i32),
                        assign_converged=torch.ones((), dtype=torch.bool))
        self.frame_idx += 1
        if self.frame_idx % self.snapshot_every == 0:
            self._snap()
        return out
