"""Felzenszwalb HOG (fHOG) features for the correlation filter (counterpart
of tpu_mot/ops/hog.py), batched over the whole patch bank in plain torch.

  gradients -> signed-orientation soft binning (18 bins) -> cell pooling ->
  4-neighbourhood block normalisation (truncated at 0.2) -> 31 channels
  (18 contrast-sensitive + 9 contrast-insensitive + 4 texture energy),
  per Felzenszwalb et al., PAMI 2010 §6.1.

The formulas, the order of the sums and the channel order are the JAX
package's: the bin axis leads during binning and pooling, the four
normalisations are summed in the same order, and edge replication pads
the gradients and the block energies.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

N_BINS = 18           # signed orientation bins
N_CHANNELS = N_BINS + 9 + 4
EPS = 1e-7
TRUNC = 0.2


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """[T, H, W] -> [T, H + 2, W + 2], replicating the border (jnp.pad
    mode="edge")."""
    return F.pad(x, (1, 1, 1, 1), mode="replicate")


def hog_features(patches: torch.Tensor, cell: int = 4) -> torch.Tensor:
    """[T, P, P] grayscale patches in [0, 1] -> fHOG [T, 31, F, F]."""
    t, p, _ = patches.shape
    f = p // cell
    xp = _pad_edge(patches.to(torch.float32))
    dy = 0.5 * (xp[:, 2:, 1:-1] - xp[:, :-2, 1:-1])
    dx = 0.5 * (xp[:, 1:-1, 2:] - xp[:, 1:-1, :-2])
    mag = torch.sqrt(dx * dx + dy * dy)
    ang = torch.atan2(dy, dx)                                 # [-pi, pi]

    # Soft assignment to the two nearest signed bins: a periodic hat.
    pos = (ang + math.pi) / (2.0 * math.pi) * N_BINS           # [0, 18]
    bins = torch.arange(N_BINS, dtype=torch.float32,
                        device=patches.device).reshape(N_BINS, 1, 1, 1)
    d = torch.abs(pos[None] - bins)                            # [18, T, P, P]
    d = torch.minimum(d, N_BINS - d)                           # periodic
    votes = torch.clamp_min(1.0 - d, 0.0) * mag[None]

    hist = votes.reshape(N_BINS, t, f, cell, f, cell).sum(dim=(3, 5))
    hist = hist.permute(1, 2, 3, 0)                            # [T, F, F, 18]
    insens = hist[..., :9] + hist[..., 9:]                     # [T, F, F, 9]

    # Block energies over the four 2x2 cell neighbourhoods of each cell.
    energy = torch.sum(insens * insens, dim=-1)                # [T, F, F]
    ep = _pad_edge(energy)
    n00 = ep[:, :-2, :-2] + ep[:, :-2, 1:-1] + ep[:, 1:-1, :-2] \
        + ep[:, 1:-1, 1:-1]
    n01 = ep[:, :-2, 1:-1] + ep[:, :-2, 2:] + ep[:, 1:-1, 1:-1] \
        + ep[:, 1:-1, 2:]
    n10 = ep[:, 1:-1, :-2] + ep[:, 1:-1, 1:-1] + ep[:, 2:, :-2] \
        + ep[:, 2:, 1:-1]
    n11 = ep[:, 1:-1, 1:-1] + ep[:, 1:-1, 2:] + ep[:, 2:, 1:-1] \
        + ep[:, 2:, 2:]
    inv = [(1.0 / torch.sqrt(n + EPS))[..., None]
           for n in (n00, n01, n10, n11)]

    def norm_avg(v):
        acc = 0.0
        for i in inv:
            acc = acc + torch.clamp_max(v * i, TRUNC)
        return 0.25 * acc

    sens = norm_avg(hist)                                      # [T, F, F, 18]
    insens_n = norm_avg(insens)                                # [T, F, F, 9]
    tex = torch.stack(
        [0.2357 * torch.sum(torch.clamp_max(hist * i, TRUNC), dim=-1)
         for i in inv], dim=-1)                                # [T, F, F, 4]
    out = torch.cat([sens, insens_n, tex], dim=-1)             # [T, F, F, 31]
    return out.permute(0, 3, 1, 2).contiguous()
