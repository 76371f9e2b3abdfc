"""The benchmark's traffic generator: synthetic multi-object clips rendered
on the device from (seed, stream).

It follows the generator of the repo's `bench.py` (`make_objects`,
`render_sequence`, `detections_from_gt` at bench.py's settings) in
PyTorch, so that hundreds of 1080p streams render on the card in seconds:
each stream holds `n_obj` textured rectangles (sides drawn from
[min_size, max_size), speed up to `max_speed` px a frame, border bounce)
on a smooth background, plus Gaussian pixel noise, quantised to u8.  Its
detector is the ground truth with 1 px centre jitter, 2% size jitter and a
score drawn from [0.5, 1), in object order, padded to `max_dets` slots.
Later objects are drawn over earlier ones, as in bench.py.

Every random draw of a stream comes from one torch.Generator on the
device, seeded from a hash of (seed, stream), so a stream is the same bit
for bit whatever the number of streams, and streams differ.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch


class Clips(NamedTuple):
    frames: torch.Tensor    # [N, S, H, W] uint8, time-major
    dets: torch.Tensor      # [N, S, D, 5] float32 cx cy w h score
    valid: torch.Tensor     # [N, S, D] bool
    gt: torch.Tensor        # [N, S, K, 4] float32 cx cy w h


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of one run's seed."""
    digest = hashlib.sha256(f"portbench:{seed}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def replay_index(step: int, n_frames: int) -> int:
    """The clip frame shown at a global step: 0..N-1, then N-2..1, then
    0.. again, so motion stays continuous across the turn."""
    if n_frames == 1:
        return 0
    period = 2 * n_frames - 2
    p = step % period
    return p if p < n_frames else period - p


def _trajectory(gen, n_obj, n_frames, height, width, min_size, max_size,
                max_speed, device):
    """Object sizes [K, 2] and centres [N, K, 2] (bench.py's
    constant-velocity motion with border bounce, in float32)."""
    wh = torch.randint(min_size, max_size, (n_obj, 2), generator=gen,
                       device=device).to(torch.float32)
    u = torch.rand((n_obj, 4), generator=gen, device=device)
    lim = torch.tensor([width, height], dtype=torch.float32, device=device)
    pos = wh + u[:, :2] * (lim - 2.0 * wh)
    vel = (u[:, 2:] * 2.0 - 1.0) * max_speed
    centres = []
    for _ in range(n_frames):
        centres.append(pos)
        pos = pos + vel
        out = (pos - wh / 2 < 0) | (pos + wh / 2 > lim)
        vel = torch.where(out, -vel, vel)
        pos = torch.where(out, pos + 2.0 * vel, pos)
    return wh, torch.stack(centres)


def _render_stream(gen, wh, centres, height, width, noise, max_size,
                   device) -> torch.Tensor:
    """One stream's frames [N, H, W] uint8."""
    n_frames, n_obj = centres.shape[:2]
    bg_small = torch.rand((height // 8 + 1, width // 8 + 1), generator=gen,
                          device=device)
    bg = bg_small.repeat_interleave(8, 0).repeat_interleave(8, 1)
    bg = bg[:height, :width] * 0.4 + 0.2
    m = max_size
    tex = torch.rand((n_obj, m, m), generator=gen, device=device) * 0.6 + 0.4
    ii = torch.arange(m, device=device)
    tw = wh[:, 0].long()
    th = wh[:, 1].long()
    rows, cols = ii[None, :, None], ii[None, None, :]
    border = ((rows == 0) | (rows == th[:, None, None] - 1)
              | (cols == 0) | (cols == tw[:, None, None] - 1))
    tex = torch.where(border, 1.0, tex)
    inside_tex = (rows < th[:, None, None]) & (cols < tw[:, None, None])
    # Top-left corner of each drawn texture, per frame.
    y0 = torch.round(centres[..., 1] - th / 2).long()           # [N, K]
    x0 = torch.round(centres[..., 0] - tw / 2).long()
    ys = y0[..., None, None] + ii[None, None, :, None]          # [N, K, m, 1]
    xs = x0[..., None, None] + ii[None, None, None, :]          # [N, K, 1, m]
    ok = (inside_tex[None] & (ys >= 0) & (ys < height)
          & (xs >= 0) & (xs < width))                           # [N, K, m, m]
    dump = height * width
    flat = torch.where(ok, ys * width + xs, dump).reshape(n_frames, -1)
    obj = torch.arange(n_obj, device=device)[None, :, None, None]
    obj = obj.expand(n_frames, n_obj, m, m).reshape(n_frames, -1)
    # The object drawn last over a pixel owns it: a max over object ids.
    owner = torch.full((n_frames, dump + 1), -1, dtype=torch.long,
                       device=device)
    owner.scatter_reduce_(1, flat, obj, "amax")
    owner = owner[:, :dump].reshape(n_frames, height, width)
    drawn = owner >= 0
    k = owner.clamp_min(0)
    f_idx = torch.arange(n_frames, device=device)[:, None, None]
    py = torch.arange(height, device=device)[None, :, None]
    px = torch.arange(width, device=device)[None, None, :]
    ty = (py - y0[f_idx, k]).clamp(0, m - 1)
    tx = (px - x0[f_idx, k]).clamp(0, m - 1)
    img = torch.where(drawn, tex[k, ty, tx], bg)
    if noise > 0:
        img = img + torch.randn(img.shape, generator=gen,
                                device=device) * noise
    return (img.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def _detections(gen, wh, centres, max_dets, device):
    """Detections from the ground truth: [N, D, 5] and valid [N, D]."""
    n_frames, n_obj = centres.shape[:2]
    if n_obj > max_dets:
        raise ValueError(f"{n_obj} objects do not fit {max_dets} "
                         "detection slots")
    jit = torch.randn((n_frames, n_obj, 4), generator=gen, device=device)
    score = torch.rand((n_frames, n_obj), generator=gen,
                       device=device) * 0.5 + 0.5
    size = wh[None].expand(n_frames, n_obj, 2)
    rows = torch.cat([centres + jit[..., :2],
                      size * (1.0 + 0.02 * jit[..., 2:]), score[..., None]],
                     dim=-1)
    dets = torch.zeros((n_frames, max_dets, 5), dtype=torch.float32,
                       device=device)
    dets[:, :n_obj] = rows
    valid = torch.zeros((n_frames, max_dets), dtype=torch.bool,
                        device=device)
    valid[:, :n_obj] = True
    gt = torch.cat([centres, size], dim=-1)
    return dets, valid, gt


def render(seed: int, n_streams: int, n_frames: int, height: int,
           width: int, n_obj: int, min_size: int, max_size: int,
           max_speed: float, noise: float, max_dets: int,
           device) -> Clips:
    """Every stream's clip, on `device`."""
    frames = torch.empty((n_frames, n_streams, height, width),
                         dtype=torch.uint8, device=device)
    dets, valid, gt = [], [], []
    for s in range(n_streams):
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, s))
        wh, centres = _trajectory(gen, n_obj, n_frames, height, width,
                                  min_size, max_size, max_speed, device)
        d, v, g = _detections(gen, wh, centres, max_dets, device)
        frames[:, s] = _render_stream(gen, wh, centres, height, width, noise,
                                      max_size, device)
        dets.append(d)
        valid.append(v)
        gt.append(g)
    return Clips(frames, torch.stack(dets, 1), torch.stack(valid, 1),
                 torch.stack(gt, 1))
