"""KCF tracker bank: correlation-only tracking of every slot at once
(counterpart of tpu_mot/tracker/kcf_bank.py).

One call per frame runs patch extraction -> features -> detect -> box move
-> retrain for the whole fixed-capacity bank; dead slots ride along with
lr = 0.  With T = 1 it is the single-object flow (`KCFTracker`).

Patches come through `ops/patch.extract_patches_auto` at "auto": for a CUDA
frame the pyramid and the ROI kernel K1 (`kernels/roi.extract_patches`),
for a CPU frame the gather path, the split the JAX package makes between
TPU and CPU.  The 3-scale search folds the scales into the track axis
scale-major ([3T] boxes with a per-track `scales` vector): one K1 launch of
3T rows.  As in the JAX package the pyramid is built inside every
extraction: the frame is float gray, so the pyramid is float32, and a frame
trained at the refined site builds it twice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.ops import features as feat_ops
from tpu_mot_torch.ops import fft as fft_ops
from tpu_mot_torch.ops import kcf as kcf_ops
from tpu_mot_torch.ops import patch as patch_ops
from tpu_mot_torch.tracker.bank import resolve_device


class KCFBank(NamedTuple):
    model: kcf_ops.KCFModel   # spectra [T, C, S, Sf] / [T, S, Sf]
    boxes: torch.Tensor       # [T, 4] (cx, cy, w, h)
    alive: torch.Tensor       # [T] bool


def _features_at(frame_gray: torch.Tensor, boxes: torch.Tensor,
                 cfg: KCFConfig, scales: torch.Tensor | None = None
                 ) -> torch.Tensor:
    patches = patch_ops.extract_patches_auto(frame_gray, boxes, cfg.padding,
                                             cfg.template_size, scales)
    return feat_ops.extract_features(patches, cfg)


def _yf(cfg: KCFConfig, device) -> torch.Tensor:
    return kcf_ops.make_yf(cfg.feature_size, cfg.padding,
                           cfg.output_sigma_factor, device=device)


def init_bank(frame_gray: torch.Tensor, boxes: torch.Tensor,
              alive: torch.Tensor, cfg: KCFConfig) -> KCFBank:
    """Train fresh models on every slot's box; dead slots are zeroed so
    that later blends cannot leak their spectra."""
    feats = _features_at(frame_gray, boxes, cfg)
    model = kcf_ops.train(feats, _yf(cfg, boxes.device), cfg.kernel_sigma,
                          cfg.lambda_)
    mask = alive.to(torch.float32)
    model = kcf_ops.KCFModel(xf=model.xf * mask[:, None, None, None],
                             alphaf=model.alphaf * mask[:, None, None])
    return KCFBank(model=model, boxes=boxes, alive=alive)


def detect_bank(bank: KCFBank, frame_gray: torch.Tensor, cfg: KCFConfig,
                with_aux: bool = False):
    """Correlation response of every live track at its current box.

    Returns (new_boxes [T, 4], peak [T]); with_aux=True appends
    (feats_unit, dy, dx), the unit-scale features and the chosen sub-pixel
    displacement, for detect-site retraining.  With cfg.scale_step > 1 the
    scales 1/step, 1, step are searched as one [3T] batch and the
    hysteresis-weighted best peak re-sizes the box.
    """
    s = cfg.feature_size
    t_cap = bank.boxes.shape[0]
    scales, scale_vals, wts = kcf_ops.search_scales(
        cfg.scale_step, cfg.scale_weight, str(bank.boxes.device))
    k = len(scales)
    feats = _features_at(frame_gray, bank.boxes.repeat(k, 1), cfg,
                         None if k == 1 else
                         scale_vals.repeat_interleave(t_cap))      # [KT]
    feats = feats.reshape((k, t_cap) + feats.shape[1:])  # [K, T, C, S, S]
    found = kcf_ops.search(bank.model, feats, cfg.kernel_sigma, wts)
    dy, dx, peak = found.dy, found.dx, found.peak
    best_scale = scale_vals[found.best]

    cx, cy, w, h = bank.boxes.unbind(1)
    w = w * best_scale
    h = h * best_scale
    # The displacement is in template pixels of the (scaled) search window.
    cx = cx + dx * w * cfg.padding / s
    cy = cy + dy * h * cfg.padding / s
    new_boxes = torch.where(bank.alive[:, None],
                            torch.stack([cx, cy, w, h], dim=1), bank.boxes)
    if with_aux:
        return new_boxes, peak, (feats[k // 2], dy, dx)
    return new_boxes, peak


def train_bank(bank: KCFBank, frame_gray: torch.Tensor, boxes: torch.Tensor,
               lr: torch.Tensor, cfg: KCFConfig) -> KCFBank:
    """EMA-retrain each slot at its (new) box with per-track lr [T]."""
    feats = _features_at(frame_gray, boxes, cfg)
    new = kcf_ops.train(feats, _yf(cfg, boxes.device), cfg.kernel_sigma,
                        cfg.lambda_)
    return KCFBank(model=kcf_ops.blend(bank.model, new, lr), boxes=boxes,
                   alive=bank.alive)


def step(bank: KCFBank, frame_gray: torch.Tensor, cfg: KCFConfig,
         train_site: str = "refined") -> tuple[KCFBank, torch.Tensor]:
    """One correlation-tracking frame for the whole bank: detect -> move
    boxes -> retrain (lr = interp_factor on live slots); returns (bank,
    peak [T]).

    train_site "refined" re-extracts at the moved boxes; "detect" retrains
    on the detect-site spectra phase-aligned by the measured displacement
    (ops/kcf.shift_spectrum), skipping slots that moved S/4 or more."""
    if train_site == "detect":
        new_boxes, peak, (feats_unit, dy, dx) = detect_bank(
            bank, frame_gray, cfg, with_aux=True)
        s = cfg.feature_size
        guard = (torch.abs(dy) < s / 4) & (torch.abs(dx) < s / 4)
        lr = torch.where(bank.alive & guard, cfg.interp_factor, 0.0)
        zf_a = kcf_ops.shift_spectrum(fft_ops.rfft2(feats_unit), dy, dx, s)
        new = kcf_ops.train_from_spectrum(
            zf_a, _yf(cfg, new_boxes.device), cfg.kernel_sigma, cfg.lambda_,
            s)
        return KCFBank(model=kcf_ops.blend(bank.model, new, lr),
                       boxes=new_boxes, alive=bank.alive), peak
    new_boxes, peak = detect_bank(bank, frame_gray, cfg)
    lr = torch.where(bank.alive, cfg.interp_factor, 0.0)
    return train_bank(bank, frame_gray, new_boxes, lr, cfg), peak


def run_otb_sequence(bank: KCFBank, frames: torch.Tensor, cfg: KCFConfig,
                     train_site: str = "refined"
                     ) -> tuple[KCFBank, torch.Tensor, torch.Tensor]:
    """Track a clip: frames [N, H, W] (or [N, H, W, 3]) on the bank's device
    -> (final bank, boxes [N, T, 4], peaks [N, T]).  The JAX lax.scan is a
    Python loop; on the card nothing syncs between frames."""
    boxes, peaks = [], []
    for i in range(frames.shape[0]):
        bank, peak = step(bank, patch_ops.to_gray(frames[i]), cfg,
                          train_site)
        boxes.append(bank.boxes)
        peaks.append(peak)
    t_cap = bank.boxes.shape[0]
    if not boxes:
        dev = bank.boxes.device
        return (bank, torch.zeros((0, t_cap, 4), device=dev),
                torch.zeros((0, t_cap), device=dev))
    return bank, torch.stack(boxes), torch.stack(peaks)


class KCFTracker:
    """Single-object wrapper, the reference's kcf_init / kcf_update API.  It
    runs on the CUDA card unless `device` says otherwise (device="cpu" for
    the CPU); with no card and no device it raises.

    >>> t = KCFTracker(KCFConfig()); t.init(frame0, box0)
    >>> box, peak = t.update(frame1)        # (cx, cy, w, h) NumPy, float
    """

    def __init__(self, cfg: KCFConfig | None = None, device=None):
        self.cfg = cfg or KCFConfig()
        self.device = resolve_device(device)
        self.bank: KCFBank | None = None

    def _gray(self, frame) -> torch.Tensor:
        frame = (frame.to(self.device) if isinstance(frame, torch.Tensor)
                 else torch.as_tensor(np.asarray(frame), device=self.device))
        return patch_ops.to_gray(frame)

    def init(self, frame, box) -> None:
        boxes = torch.as_tensor(np.asarray(box, np.float32),
                                device=self.device)[None]
        self.bank = init_bank(self._gray(frame), boxes,
                              torch.ones((1,), dtype=torch.bool,
                                         device=self.device), self.cfg)

    def update(self, frame):
        if self.bank is None:
            raise RuntimeError("call init() first")
        self.bank, peak = step(self.bank, self._gray(frame), self.cfg)
        return self.bank.boxes[0].cpu().numpy(), float(peak[0])
