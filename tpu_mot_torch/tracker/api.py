"""Public MOT API (counterpart of tpu_mot/tracker/api.py): the reference's
init/update surface around the step.  The tracker pads detections to the
static capacity, runs the step on its device and unpacks confirmed tracks;
all tracking state is a TrackBank of tensors, snapshotted by
`save_state` / `load_state`.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mot_torch.config import DEFAULT_CONFIG, TrackerConfig
from tpu_mot_torch.tracker import step as step_mod
from tpu_mot_torch.tracker.bank import (TrackBank, empty_bank, map_bank,
                                        resolve_device)


def pad_detections(dets, capacity: int, width: int | None = None):
    """[N, 4|5|6] array-like -> ([capacity, 5|6] float32, [capacity] bool
    valid mask); a copy of tpu_mot.tracker.api.pad_detections (pure NumPy).

    A 6th column is a detector class id, kept iff the input carries it;
    width=6 forces the class-aware form.  4-column input gets score 1.
    """
    dets = np.asarray(dets, np.float32)
    if dets.size == 0:
        dets = dets.reshape(0, dets.shape[-1] if dets.ndim == 2 else 5)
    if dets.ndim == 1:
        # A bare [cx, cy, w, h(, score)] is one detection.
        dets = dets.reshape(1, -1)
    n = min(len(dets), capacity)
    if width is None:
        width = 6 if dets.shape[-1] >= 6 else 5
    out = np.zeros((capacity, width), np.float32)
    if dets.shape[-1] == 4:
        out[:n, :4] = dets[:n]
        out[:n, 4] = 1.0
    else:
        w_in = min(dets.shape[-1], width)
        out[:n, :w_in] = dets[:n, :w_in]
    valid = np.zeros((capacity,), bool)
    valid[:n] = True
    return out, valid


class MultiTracker:
    """Detect-track MOT pipeline behind the reference's init/update API.
    It runs on the CUDA card unless `device` says otherwise (device="cpu"
    for the CPU); with no card and no device it raises.

    >>> mt = MultiTracker()
    >>> mt.init(frame0, dets0)              # dets: [N, 4|5] cx cy w h (score)
    >>> tracks = mt.update(frame1, dets1)   # [(id, (cx, cy, w, h), score)]
    """

    def __init__(self, cfg: TrackerConfig | None = None, device=None):
        self.cfg = cfg or DEFAULT_CONFIG
        self.device = resolve_device(device)
        self.bank: TrackBank | None = None
        self.last_output: step_mod.StepOutput | None = None

    def _inputs(self, frame, detections):
        # One width per config, so 5- and 6-column frames share a shape.
        dets, valid = pad_detections(detections, self.cfg.max_detections,
                                     width=6 if self.cfg.class_aware else 5)
        frame = (frame.to(self.device) if isinstance(frame, torch.Tensor)
                 else torch.as_tensor(np.asarray(frame), device=self.device))
        return (frame, torch.as_tensor(dets, device=self.device),
                torch.as_tensor(valid, device=self.device))

    def init(self, frame, detections):
        self.bank, out = step_mod.init(*self._inputs(frame, detections),
                                       self.cfg)
        self.last_output = out
        return self._unpack(out)

    def update(self, frame, detections=None):
        return self._unpack(self.update_async(frame, detections))

    def update_async(self, frame, detections=None) -> step_mod.StepOutput:
        """update() without fetching the result to the host: queues the
        step and returns the device-resident StepOutput (see `unpack`)."""
        if self.bank is None:
            raise RuntimeError("call init() first")
        if detections is None:
            detections = np.zeros((0, 5), np.float32)
        self.bank, out = step_mod.step(self.bank,
                                       *self._inputs(frame, detections),
                                       self.cfg)
        self.last_output = out
        return out

    def unpack(self, out: step_mod.StepOutput):
        """Fetch a StepOutput: [(id, (cx, cy, w, h), score)]."""
        return self._unpack(out)

    @staticmethod
    def _unpack(out: step_mod.StepOutput):
        ids = out.ids.cpu().numpy()
        boxes = out.boxes.cpu().numpy()
        scores = out.scores.cpu().numpy()
        valid = out.valid.cpu().numpy()
        return [(int(ids[i]), tuple(float(v) for v in boxes[i]),
                 float(scores[i]))
                for i in np.where(valid)[0]]

    def counters(self) -> dict:
        o = self.last_output
        if o is None:
            return {}
        return {"alive": int(o.n_alive), "births": int(o.n_births),
                "deaths": int(o.n_deaths), "matches": int(o.n_matches),
                "assign_iters": int(o.assign_iters),
                "assign_converged": bool(o.assign_converged)}

    def save_state(self) -> dict:
        """A host snapshot: {"bank": TrackBank of CPU tensors, "cfg"}."""
        return {"bank": map_bank(lambda x: x.detach().cpu().clone(),
                                 self.bank),
                "cfg": self.cfg}

    def load_state(self, snap: dict) -> None:
        self.cfg = snap["cfg"]
        self.bank = map_bank(lambda x: x.to(self.device), snap["bank"])


def reset(cfg: TrackerConfig | None = None, device=None) -> TrackBank:
    """Fresh empty bank (functional API), on the CUDA card unless `device`
    says otherwise."""
    return empty_bank(cfg or DEFAULT_CONFIG, device=device)
