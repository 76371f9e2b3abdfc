"""Batched constant-velocity Kalman filter over the track bank
(counterpart of tpu_mot/ops/kalman.py).

State [cx, cy, w, h, vcx, vcy, vw, vh]; measurement [cx, cy, w, h].  All
products run in float32 with TF32 off (tpu_mot_torch/__init__.py): at 1080p
coordinates a reduced-precision product injects a multi-pixel quantum into
every predict/correct.
"""

from __future__ import annotations

import functools

import torch

from tpu_mot_torch.config import KalmanConfig

_DIM = 8


@functools.lru_cache(maxsize=None)
def _consts(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    f = torch.eye(_DIM, dtype=torch.float32)
    f[:4, 4:] = torch.eye(4, dtype=torch.float32)    # x += v * dt, dt = 1
    h = torch.eye(4, _DIM, dtype=torch.float32)
    return f.to(device), h.to(device)


def init(boxes: torch.Tensor, cfg: KalmanConfig
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bank state from measured boxes [T, 4] -> (mean [T, 8], cov [T, 8, 8])
    with a wide (uninformative) velocity prior."""
    t = boxes.shape[0]
    zeros = torch.zeros((t, 4), dtype=torch.float32, device=boxes.device)
    mean = torch.cat([boxes, zeros], dim=1)
    scale = torch.clamp_min(torch.maximum(boxes[:, 2], boxes[:, 3]), 1.0)
    pos_var = (2.0 * cfg.pos_std_factor * scale) ** 2           # [T]
    diag = torch.cat([pos_var[:, None].expand(t, 4),
                      torch.full_like(zeros, cfg.init_vel_cov)], dim=1)
    return mean, torch.diag_embed(diag)


def predict(mean: torch.Tensor, cov: torch.Tensor, cfg: KalmanConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x' = F x ; P' = F P F^T + Q(scale)."""
    f, _ = _consts(str(mean.device))
    t = mean.shape[0]
    scale = torch.clamp_min(torch.maximum(mean[:, 2], mean[:, 3]), 1.0)
    q_pos = (cfg.process_pos_std * scale) ** 2
    q_vel = (cfg.process_vel_std * scale) ** 2
    q_diag = torch.cat([q_pos[:, None].expand(t, 4),
                        q_vel[:, None].expand(t, 4)], dim=1)
    new_mean = torch.einsum("ij,tj->ti", f, mean)
    new_cov = (torch.einsum("ij,tjk,lk->til", f, cov, f)
               + torch.diag_embed(q_diag))
    return new_mean, new_cov


def _inv2x2(m: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 inverse [..., 2, 2] (elementwise)."""
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 0]
    d = m[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1e-20)
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]


def _inv4x4_spd(s: torch.Tensor) -> torch.Tensor:
    """Batched 4x4 inverse of symmetric positive-definite matrices via the
    2x2-block Schur complement, as in the JAX package (kalman.py:87-105)."""
    a = s[..., :2, :2]
    b = s[..., :2, 2:]
    c = s[..., 2:, :2]
    d = s[..., 2:, 2:]
    ai = _inv2x2(a)
    aib = ai @ b
    schur = d - c @ aib
    si = _inv2x2(schur)
    cai = c @ ai
    top_left = ai + (aib @ si) @ cai
    top_right = -(aib @ si)
    bot_left = -(si @ cai)
    top = torch.cat([top_left, top_right], dim=-1)
    bot = torch.cat([bot_left, si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def correct(mean: torch.Tensor, cov: torch.Tensor, z: torch.Tensor,
            gate: torch.Tensor, cfg: KalmanConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Measurement update with a per-track gate [T] (False = slot keeps its
    predicted state)."""
    f, h = _consts(str(mean.device))
    scale = torch.clamp_min(torch.maximum(mean[:, 2], mean[:, 3]), 1.0)
    r_diag = ((cfg.pos_std_factor * scale) ** 2)[:, None].expand(-1, 4)
    s = (torch.einsum("ij,tjk,lk->til", h, cov, h)
         + torch.diag_embed(r_diag))
    pht = torch.einsum("tjk,ik->tji", cov, h)                    # [T, 8, 4]
    k = torch.einsum("tji,tik->tjk", pht, _inv4x4_spd(s))        # [T, 8, 4]
    resid = z - torch.einsum("ij,tj->ti", h, mean)               # [T, 4]
    new_mean = mean + torch.einsum("tij,tj->ti", k, resid)
    kh = torch.einsum("tij,jk->tik", k, h)                       # [T, 8, 8]
    eye = torch.eye(_DIM, dtype=torch.float32, device=mean.device)
    new_cov = torch.einsum("tij,tjk->tik", eye[None] - kh, cov)
    g = gate[:, None]
    return (torch.where(g, new_mean, mean),
            torch.where(g[:, :, None], new_cov, cov))
