"""The track bank: fixed-capacity per-slot state of the whole tracker
(counterpart of tpu_mot/tracker/bank.py).

Every field is a dense tensor over the static capacity T with the JAX
package's names, dtypes and shapes, so a bank converts losslessly in both
directions (tpu_mot_torch/interop.py).  KCF spectra are complex64.

Slot lifecycle (SORT-style): EMPTY -> TENTATIVE -> CONFIRMED -> EMPTY.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.ops.kcf import KCFModel

EMPTY = 0
TENTATIVE = 1
CONFIRMED = 2


class TrackBank(NamedTuple):
    """Dense per-slot state; [T] leading axis everywhere (serving stacks S
    banks: a leading [S] on every field, parallel/serve.py)."""

    kf_mean: torch.Tensor           # [T, 8] float32 cx cy w h + velocities
    kf_cov: torch.Tensor            # [T, 8, 8] float32
    kcf: KCFModel                   # complex64 [T, C, S, Sf], [T, S, Sf]
    ids: torch.Tensor               # [T] int32, -1 for empty slots
    state: torch.Tensor             # [T] int32 lifecycle
    hits: torch.Tensor              # [T] int32 matched-detection count
    time_since_update: torch.Tensor  # [T] int32
    age: torch.Tensor               # [T] int32 frames since birth
    score: torch.Tensor             # [T] float32 last confidence
    cls: torch.Tensor               # [T] int32 birth class, -1 empty
    auction_prices: torch.Tensor    # [max(T, D)] float32 (warm-start carry)
    auction_col_of: torch.Tensor    # [max(T, D)] int32
    next_id: torch.Tensor           # [] int32
    frame_idx: torch.Tensor         # [] int32

    @property
    def alive(self) -> torch.Tensor:
        return self.state > EMPTY

    @property
    def confirmed(self) -> torch.Tensor:
        return self.state == CONFIRMED

    @property
    def boxes(self) -> torch.Tensor:
        return self.kf_mean[..., :4]


def resolve_device(device=None) -> torch.device:
    """`device`, or the CUDA card when it is None.  Raises when the device
    is a CUDA one and there is no card: nothing falls back to the CPU
    unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA card is available for device {dev} (the default when "
            "none is given); pass device='cpu' to run on the CPU")
    return dev


def empty_bank(cfg: TrackerConfig, device=None) -> TrackBank:
    """A bank with every slot EMPTY, on `device` (default: the CUDA card;
    see resolve_device)."""
    device = resolve_device(device)
    t = cfg.max_tracks
    s = cfg.kcf.feature_size
    sf = cfg.kcf.spectrum_width
    c = cfg.kcf.num_channels
    n_sq = max(t, cfg.max_detections)
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    c64 = dict(dtype=torch.complex64, device=device)
    return TrackBank(
        kf_mean=torch.zeros((t, 8), **f32),
        kf_cov=torch.eye(8, **f32).expand(t, 8, 8).clone(),
        kcf=KCFModel(xf=torch.zeros((t, c, s, sf), **c64),
                     alphaf=torch.zeros((t, s, sf), **c64)),
        ids=torch.full((t,), -1, **i32),
        state=torch.zeros((t,), **i32),
        hits=torch.zeros((t,), **i32),
        time_since_update=torch.zeros((t,), **i32),
        age=torch.zeros((t,), **i32),
        score=torch.zeros((t,), **f32),
        cls=torch.full((t,), -1, **i32),
        auction_prices=torch.zeros((n_sq,), **f32),
        auction_col_of=torch.full((n_sq,), -1, **i32),
        next_id=torch.zeros((), **i32),
        frame_idx=torch.zeros((), **i32),
    )


def map_bank(fn, bank: TrackBank) -> TrackBank:
    """Apply fn to every tensor of the bank (the KCF spectra included)."""
    return TrackBank(*[KCFModel(*[fn(x) for x in v])
                       if isinstance(v, KCFModel) else fn(v)
                       for v in bank])


def zip_banks(fn, a: TrackBank, b: TrackBank) -> TrackBank:
    """fn(x, y) over the paired tensors of two banks."""
    return TrackBank(*[KCFModel(*[fn(x, y) for x, y in zip(u, v)])
                       if isinstance(u, KCFModel) else fn(u, v)
                       for u, v in zip(a, b)])
