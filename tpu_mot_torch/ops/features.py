"""Patch -> feature maps for the correlation filter (counterpart of
tpu_mot/ops/features.py): raw grayscale features, zero-centred and
cosine-windowed (arXiv:1404.7584 §8, "raw pixels"), or fHOG-31 over
cell x cell cells with a Hann window on the cell grid."""

from __future__ import annotations

import torch

from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.ops import hog
from tpu_mot_torch.ops import window as window_ops


def raw_gray_features(patches: torch.Tensor) -> torch.Tensor:
    """[T, S, S] patches in [0, 1] -> windowed features [T, 1, S, S]."""
    s = patches.shape[-1]
    hann = window_ops.hann2d(s, s, device=patches.device)
    return ((patches - 0.5) * hann)[:, None, :, :]


def extract_features(patches: torch.Tensor, cfg: KCFConfig) -> torch.Tensor:
    """Patch bank [T, P, P] -> cosine-windowed features [T, C, F, F] per
    cfg.feature_type ("gray": C=1, F=P; "hog": C=31, F=P/cell)."""
    if cfg.feature_type == "hog":
        feat = hog.hog_features(patches, cfg.cell_size)        # [T, 31, F, F]
        f = feat.shape[-1]
        hann = window_ops.hann2d(f, f, device=patches.device)
        return feat * hann[None, None]
    return raw_gray_features(patches)
