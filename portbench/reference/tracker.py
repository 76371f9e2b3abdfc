"""Plain PyTorch reference of one tracking step of S streams, written from
the tracker's published description and imported from nowhere in the
program under test.

The step is the default configuration the benchmark runs: constant-
velocity Kalman filter over (cx, cy, w, h) and their velocities; a KCF
correlation filter on raw gray pixels (arXiv:1404.7584: Hann-windowed
64 x 64 template over 2.5 x the box, Gaussian kernel correlation, ridge
solve in the Fourier domain, response peak with a parabolic sub-pixel fit
and a peak-to-sidelobe gate); IoU cost with a 0.3 gate; a Jacobi auction
at eps 0.02; the SORT lifecycle (tentative, confirmed after 2 hits,
deleted after 30 unmatched frames, 2 while tentative; births into the
lowest free slots); and detect-site training, the unit-scale sample
phase-shifted to the corrected centre and blended at rate 0.075.

Windows are sampled the way the tracker's ROI stage is specified: through
a 4-level u8 mip pyramid (2 x 2 means rounded back to u8), at the level
where the window is at most 128 px, bilinearly, from a 144 x 256 block
whose origin is aligned to 8 rows and 128 columns; taps outside the block
or the level read 0.

`precision="tf32"` is the control: every operand of the Kalman filter's
matrix products and of the FFTs is rounded to TF32 (10 explicit mantissa
bits), as a TF32 implementation of the same step would compute.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

EMPTY, TENTATIVE, CONFIRMED = 0, 1, 2
N_LEVELS = 4
BLK_ROWS, BLK_COLS = 144, 256
MAX_WIN = 128.0
COST_CAP = 4.0
INFEASIBLE_BENEFIT = -8.0


class State(NamedTuple):
    """Per-slot state of S streams, [S, T, ...]; next_id [S]."""
    kf_mean: torch.Tensor       # [S, T, 8]
    kf_cov: torch.Tensor        # [S, T, 8, 8]
    xf: torch.Tensor            # [S, T, 1, F, F//2+1] complex64
    alphaf: torch.Tensor        # [S, T, F, F//2+1] complex64
    ids: torch.Tensor
    state: torch.Tensor
    hits: torch.Tensor
    tsu: torch.Tensor
    age: torch.Tensor
    score: torch.Tensor
    next_id: torch.Tensor


class Out(NamedTuple):
    ids: torch.Tensor       # [S, T]
    boxes: torch.Tensor     # [S, T, 4]
    valid: torch.Tensor     # [S, T]


class Params(NamedTuple):
    max_tracks: int
    template: int
    padding: float
    lam: float
    sigma: float
    out_sigma_factor: float
    interp: float
    pos_std: float
    init_vel_cov: float
    q_pos: float
    q_vel: float
    iou_gate: float
    infeasible: float
    n_init: int
    max_age: int
    max_age_tentative: int
    min_psr: float
    det_score_min: float
    eps: float
    max_iters: int
    frame_hw: tuple


def params_from_config(cfg: dict, frame_hw: tuple) -> Params:
    """Reference parameters from a configuration file's "tracker" dict;
    raises for a setting the reference does not compute."""
    kcf = cfg.get("kcf", {})
    kal = cfg.get("kalman", {})
    fixed = dict(feature_type=kcf.get("feature_type", "gray"),
                 cell_size=kcf.get("cell_size", 1),
                 scale_step=kcf.get("scale_step", 1.0),
                 train_site=cfg.get("train_site", "detect"),
                 confidence_mode=cfg.get("confidence_mode", "psr"),
                 use_kcf=cfg.get("use_kcf", True),
                 class_aware=cfg.get("class_aware", False),
                 appearance_weight=cfg.get("appearance_weight", 0.0),
                 auction_warm_start=cfg.get("auction_warm_start", False),
                 assoc_box=cfg.get("assoc_box", "auto"),
                 kcf_impl=cfg.get("kcf_impl", "auto"),
                 output_max_tsu=cfg.get("output_max_tsu", 10 ** 6))
    want = dict(feature_type="gray", cell_size=1, scale_step=1.0,
                train_site="detect", confidence_mode="psr", use_kcf=True,
                class_aware=False, appearance_weight=0.0,
                auction_warm_start=False, assoc_box="auto", kcf_impl="auto",
                output_max_tsu=10 ** 6)
    if fixed != want:
        raise ValueError(f"the reference computes {want}, not {fixed}")
    return Params(
        max_tracks=cfg["max_tracks"], template=kcf.get("template_size", 64),
        padding=kcf.get("padding", 2.5), lam=kcf.get("lambda_", 1e-4),
        sigma=kcf.get("kernel_sigma", 0.2),
        out_sigma_factor=kcf.get("output_sigma_factor", 0.125),
        interp=kcf.get("interp_factor", 0.075),
        pos_std=kal.get("pos_std_factor", 1 / 20),
        init_vel_cov=kal.get("init_vel_cov", 1e4),
        q_pos=kal.get("process_pos_std", 1 / 20),
        q_vel=kal.get("process_vel_std", 1 / 160),
        iou_gate=cfg.get("iou_gate", 0.3),
        infeasible=cfg.get("cost_infeasible", 1e4),
        n_init=cfg.get("n_init", 2), max_age=cfg.get("max_age", 30),
        max_age_tentative=cfg.get("max_age_tentative", 2),
        min_psr=(cfg.get("min_psr") if cfg.get("min_psr") is not None
                 else 5.0),
        det_score_min=cfg.get("det_score_min", 0.0), eps=0.02,
        max_iters=2000, frame_hw=tuple(frame_hw))


def empty_state(p: Params, n_streams: int, device) -> State:
    t, f = p.max_tracks, p.template
    z = dict(device=device)
    return State(
        kf_mean=torch.zeros((n_streams, t, 8), **z),
        kf_cov=torch.eye(8, **z).expand(n_streams, t, 8, 8).clone(),
        xf=torch.zeros((n_streams, t, 1, f, f // 2 + 1),
                       dtype=torch.complex64, **z),
        alphaf=torch.zeros((n_streams, t, f, f // 2 + 1),
                           dtype=torch.complex64, **z),
        ids=torch.full((n_streams, t), -1, dtype=torch.int32, **z),
        state=torch.zeros((n_streams, t), dtype=torch.int32, **z),
        hits=torch.zeros((n_streams, t), dtype=torch.int32, **z),
        tsu=torch.zeros((n_streams, t), dtype=torch.int32, **z),
        age=torch.zeros((n_streams, t), dtype=torch.int32, **z),
        score=torch.zeros((n_streams, t), **z),
        next_id=torch.zeros((n_streams,), dtype=torch.int32, **z))


# -- precision ---------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits, nearest-even)."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _Arith:
    def __init__(self, precision: str):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.low = precision == "tf32"

    def r(self, x):
        return _tf32(x) if self.low else x

    def mm(self, eq, *ops):
        return torch.einsum(eq, *[self.r(o) for o in ops])

    def rfft2(self, x):
        return torch.fft.rfft2(self.r(x))

    def irfft2(self, x, w):
        if self.low:
            x = torch.complex(_tf32(x.real), _tf32(x.imag))
        return torch.fft.irfft2(x, s=(x.shape[-2], w))


# -- ROI sampling -------------------------------------------------------

def pyramid(frames: torch.Tensor) -> list[torch.Tensor]:
    """u8 frames [S, H, W] -> 4 u8 levels, each the rounded 2 x 2 mean of
    the one above (an odd edge averages with zeros)."""
    levels = [frames]
    cur = frames
    for _ in range(N_LEVELS - 1):
        h, w = cur.shape[-2:]
        x = torch.nn.functional.pad(cur.to(torch.float32),
                                    (0, w % 2, 0, h % 2))
        x = (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] + x[..., 1::2, 0::2]
             + x[..., 1::2, 1::2]) * 0.25
        cur = (x + 0.5).clamp(0.0, 255.0).to(torch.uint8)
        levels.append(cur)
    return levels


def _extents(h, w):
    return [(-(-h // (1 << k)), -(-w // (1 << k))) for k in range(N_LEVELS)]


def _max_origin(h, w):
    out = []
    for lh, lw in _extents(h, w):
        ph = max(-(-lh // 8) * 8, BLK_ROWS)
        pw = max(-(-lw // 128) * 128, BLK_COLS)
        out.append((ph - BLK_ROWS, pw - BLK_COLS))
    return out


def sample_windows(levels, boxes: torch.Tensor, p: Params) -> torch.Tensor:
    """Windows [S, T, F, F] in [0, 1] of boxes [S, T, 4] (cx, cy, w, h)."""
    n_str, t = boxes.shape[:2]
    f = p.template
    dev = boxes.device
    h, w = p.frame_hw
    ext = torch.tensor(_extents(h, w), dtype=torch.float32, device=dev)
    mo = torch.tensor(_max_origin(h, w), dtype=torch.int64, device=dev)
    cx, cy = boxes[..., 0], boxes[..., 1]
    bw = boxes[..., 2].clamp_min(1.0)
    bh = boxes[..., 3].clamp_min(1.0)
    win_w, win_h = bw * p.padding, bh * p.padding
    win = torch.maximum(win_w, win_h)
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp_min(win / MAX_WIN,
                                                             1.0))),
                      0, N_LEVELS - 1).long()                       # [S, T]
    scale = torch.exp2(lvl.to(torch.float32))[..., None]
    lh = ext[lvl, 0][..., None]
    lw = ext[lvl, 1][..., None]
    u = (torch.arange(f, dtype=torch.float32, device=dev) + 0.5) / f - 0.5
    ys = torch.minimum(((cy[..., None] + u * win_h[..., None] + 0.5) / scale
                        - 0.5).clamp_min(0.0), lh - 1.0)            # [S, T, F]
    xs = torch.minimum(((cx[..., None] + u * win_w[..., None] + 0.5) / scale
                        - 0.5).clamp_min(0.0), lw - 1.0)
    r0 = torch.div(torch.floor(ys[..., 0]).long(), 8,
                   rounding_mode="floor") * 8
    c0 = torch.div(torch.floor(xs[..., 0]).long(), 128,
                   rounding_mode="floor") * 128
    r0 = torch.minimum(r0.clamp_min(0), mo[lvl, 0])
    c0 = torch.minimum(c0.clamp_min(0), mo[lvl, 1])
    lh_i, lw_i = lh.long(), lw.long()

    def taps(coord, origin, blk, extent):
        y = coord - origin[..., None].to(torch.float32)
        fl = torch.floor(y)
        a = fl.long()
        out = []
        for tap, tf in ((a, fl), (a + 1, fl + 1.0)):
            g = origin[..., None] + tap
            ok = (tap >= 0) & (tap < blk) & (g < extent)
            wgt = torch.clamp_min(1.0 - torch.abs(y - tf), 0.0)
            out.append((torch.minimum(g.clamp_min(0), extent - 1),
                        torch.where(ok, wgt, 0.0)))
        return out

    (ry0, wy0), (ry1, wy1) = taps(ys, r0, BLK_ROWS, lh_i)
    (cx0, wx0), (cx1, wx1) = taps(xs, c0, BLK_COLS, lw_i)
    wy0, wy1 = wy0 * (1.0 / 255.0), wy1 * (1.0 / 255.0)
    stream = torch.arange(n_str, device=dev)[:, None, None, None]
    out = torch.zeros((n_str, t, f, f), dtype=torch.float32, device=dev)
    for k, level in enumerate(levels):
        sel = lvl == k
        if not bool(sel.any()):
            continue
        lv = level.to(torch.float32)
        k_h, k_w = lv.shape[-2:]

        def px(r, c):
            # Rows of tracks at other levels are clamped here and discarded.
            return lv[stream, r.clamp_max(k_h - 1)[..., :, None],
                      c.clamp_max(k_w - 1)[..., None, :]]

        r0w, r1w = wy0[..., :, None], wy1[..., :, None]
        t0 = r0w * px(ry0, cx0) + r1w * px(ry1, cx0)
        t1 = r0w * px(ry0, cx1) + r1w * px(ry1, cx1)
        val = t0 * wx0[..., None, :] + t1 * wx1[..., None, :]
        out = torch.where(sel[..., None, None], val, out)
    return out


# -- KCF ---------------------------------------------------------------------

def _hann(f: int, device) -> torch.Tensor:
    n = np.arange(f)
    h = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (f - 1)))
    return torch.as_tensor(np.outer(h, h).astype(np.float32), device=device)


def _yf(p: Params, ar: _Arith, device) -> torch.Tensor:
    f = p.template
    sig = math.sqrt(f * f) / p.padding * p.out_sigma_factor
    c = f // 2
    d2 = (np.arange(f) - c) ** 2
    g = np.exp(-0.5 * (d2[:, None] + d2[None, :]) / (sig * sig))
    return ar.rfft2(torch.as_tensor(g.astype(np.float32), device=device))


def _energy(xf: torch.Tensor, f: int) -> torch.Tensor:
    """sum |x|^2 over (C, F, F) from a half spectrum (Parseval)."""
    wts = torch.full((xf.shape[-1],), 2.0, device=xf.device)
    wts[0] = 1.0
    if f % 2 == 0:
        wts[-1] = 1.0
    return ((xf.real ** 2 + xf.imag ** 2) * wts).sum(dim=(-3, -2, -1)) / (
        xf.shape[-2] * f)


def _kernel_corr(xf, zf, p: Params, ar: _Arith) -> torch.Tensor:
    f = p.template
    cross = ar.irfft2((xf * zf.conj()).sum(dim=-3), f)
    d = (_energy(xf, f) + _energy(zf, f))[..., None, None] - 2.0 * cross
    k = torch.exp(-d.clamp_min(0.0) / (p.sigma ** 2 * f * f * xf.shape[-3]))
    return ar.rfft2(k)


def _peak(resp: torch.Tensor):
    """(dy, dx, peak value, argmax row, argmax col) of [..., F, F]."""
    f = resp.shape[-1]
    flat = resp.flatten(-2)
    idx = flat.argmax(dim=-1, keepdim=True)
    peak = flat.gather(-1, idx)[..., 0]
    py, px = (idx // f)[..., 0], (idx % f)[..., 0]

    def at(r, c):
        return flat.gather(-1, (r * f + c)[..., None])[..., 0]

    def fit(pos, lo, hi):
        den = 2.0 * peak - lo - hi
        d = torch.where(den.abs() > 1e-8,
                        0.5 * (hi - lo) / den.clamp_min(1e-8), 0.0)
        return torch.where((pos > 0) & (pos < f - 1), d.clamp(-0.5, 0.5), 0.0)

    dy = py.float() + fit(py, at((py - 1).clamp_min(0), px),
                          at((py + 1).clamp_max(f - 1), px)) - f // 2
    dx = px.float() + fit(px, at(py, (px - 1).clamp_min(0)),
                          at(py, (px + 1).clamp_max(f - 1))) - f // 2
    return dy, dx, peak, py, px


def _psr(resp, peak, py, px, exclude: int = 5):
    f = resp.shape[-1]
    i = torch.arange(f, device=resp.device, dtype=torch.float32)
    side = (((i[:, None] - py[..., None, None].float()).abs() > exclude)
            | ((i[None, :] - px[..., None, None].float()).abs() > exclude))
    n = side.sum(dim=(-2, -1)).float().clamp_min(1.0)
    mean = torch.where(side, resp, 0.0).sum(dim=(-2, -1)) / n
    var = torch.where(side, (resp - mean[..., None, None]) ** 2,
                      0.0).sum(dim=(-2, -1)) / n
    return (peak - mean) / torch.sqrt(var + 1e-8)


def model_response(xf: torch.Tensor, alphaf: torch.Tensor,
                   p: Params) -> torch.Tensor:
    """The response a KCF model gives on its own template,
    irfft2(k^{xx} * alphaf) [..., F, F]: what the dual coefficients are
    for, and far better conditioned than alphaf itself (whose bins where
    k^{xx} is near 0 swing with the last bits of k)."""
    return _Arith("float32").irfft2(
        _kernel_corr(xf, xf, p, _Arith("float32")) * alphaf, p.template)


# -- Kalman -------------------------------------------------------------

def _f_h(device):
    fm = torch.eye(8, device=device)
    fm[:4, 4:] = torch.eye(4, device=device)
    return fm, torch.eye(4, 8, device=device)


def _kf_init(boxes, p: Params):
    scale = torch.maximum(boxes[..., 2], boxes[..., 3]).clamp_min(1.0)
    pos_var = (2.0 * p.pos_std * scale) ** 2
    diag = torch.cat([pos_var[..., None].expand(boxes.shape[:-1] + (4,)),
                      torch.full(boxes.shape[:-1] + (4,), p.init_vel_cov,
                                 device=boxes.device)], dim=-1)
    return (torch.cat([boxes, torch.zeros_like(boxes)], dim=-1),
            torch.diag_embed(diag))


def _kf_predict(mean, cov, p: Params, ar: _Arith):
    fm, _ = _f_h(mean.device)
    scale = torch.maximum(mean[..., 2], mean[..., 3]).clamp_min(1.0)
    q = torch.cat([((p.q_pos * scale) ** 2)[..., None].expand(
        scale.shape + (4,)), ((p.q_vel * scale) ** 2)[..., None].expand(
        scale.shape + (4,))], dim=-1)
    return (ar.mm("ij,...j->...i", fm, mean),
            ar.mm("ij,...jk,lk->...il", fm, cov, fm) + torch.diag_embed(q))


def _kf_correct(mean, cov, z, gate, p: Params, ar: _Arith):
    _, hm = _f_h(mean.device)
    scale = torch.maximum(mean[..., 2], mean[..., 3]).clamp_min(1.0)
    r = ((p.pos_std * scale) ** 2)[..., None].expand(scale.shape + (4,))
    s = ar.mm("ij,...jk,lk->...il", hm, cov, hm) + torch.diag_embed(r)
    pht = ar.mm("...jk,ik->...ji", cov, hm)                   # [..., 8, 4]
    # K = P H^T S^-1, from S K^T = H P^T.
    gain = torch.linalg.solve(s, pht.transpose(-1, -2)).transpose(-1, -2)
    gain = ar.r(gain)
    new_mean = mean + ar.mm("...ij,...j->...i", gain,
                            z - ar.mm("ij,...j->...i", hm, mean))
    eye = torch.eye(8, device=mean.device)
    new_cov = ar.mm("...ij,...jk->...ik",
                    eye - ar.mm("...ij,jk->...ik", gain, hm), cov)
    g = gate[..., None]
    return (torch.where(g, new_mean, mean),
            torch.where(g[..., None], new_cov, cov))


# -- association -------------------------------------------------------------

def _iou(a, b):
    """[S, T, 4] x [S, D, 4] -> [S, T, D]."""
    def corners(x):
        return (x[..., 0] - x[..., 2] / 2, x[..., 1] - x[..., 3] / 2,
                x[..., 0] + x[..., 2] / 2, x[..., 1] + x[..., 3] / 2)
    ax1, ay1, ax2, ay2 = (c[..., :, None] for c in corners(a))
    bx1, by1, bx2, by2 = (c[..., None, :] for c in corners(b))
    iw = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    ih = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = iw * ih
    union = ((a[..., 2] * a[..., 3])[..., :, None]
             + (b[..., 2] * b[..., 3])[..., None, :] - inter)
    return torch.where(union > 0, inter / union, 0.0)


def auction(cost: torch.Tensor, feasible: torch.Tensor, eps: float,
            max_iters: int) -> torch.Tensor:
    """Jacobi auction over S problems [S, T, D] -> row's column [S, T]
    (-1 unmatched).  The problem is squared with zero-benefit dummies;
    feasible pairs have benefit 1 + clip(4 - cost, 0, 4), infeasible -8,
    rows with no feasible pair 0; a jitter of ((7r + 13c) % 29) eps/116
    breaks ties.  Each round, every unassigned row bids its best column's
    price plus the gap to its second best plus eps on that column; each
    column takes its highest bid (the lowest row on ties)."""
    n_str, t, d = cost.shape
    n = max(t, d)
    dev = cost.device
    b = torch.where(feasible, (COST_CAP - cost).clamp(0.0, COST_CAP) + 1.0,
                    INFEASIBLE_BENEFIT)
    b = torch.where(feasible.any(dim=-1, keepdim=True), b, 0.0)
    b = torch.nn.functional.pad(b, (0, n - d, 0, n - t))
    idx = torch.arange(n, device=dev)
    b = b + (((idx[:, None] * 7 + idx[None, :] * 13) % 29).float()
             * (0.25 * eps / 29.0))
    prices = torch.zeros((n_str, n), device=dev)
    owner_of_row = torch.full((n_str, n), -1, dtype=torch.long, device=dev)
    row_of_col = torch.full((n_str, n), -1, dtype=torch.long, device=dev)
    for _ in range(max_iters):
        bidding = owner_of_row < 0
        if not bool(bidding.any()):
            break
        val = b - prices[:, None, :]
        best, col = val.max(dim=-1)          # first maximum
        second = val.scatter(-1, col[..., None], float("-inf")).max(dim=-1)[0]
        second = torch.where(torch.isfinite(second), second, best)
        bid = prices.gather(1, col) + (best - second) + eps
        bids = torch.full((n_str, n, n), float("-inf"), device=dev)
        bids.scatter_(2, col[..., None],
                      torch.where(bidding, bid, float("-inf"))[..., None])
        top, winner = bids.max(dim=1)        # per column; lowest row on ties
        got = torch.isfinite(top)
        old = torch.where(got, row_of_col, -1)
        rows = torch.arange(n, device=dev)
        # Evict previous owners, then seat the winners.
        evicted = torch.zeros((n_str, n + 1), dtype=torch.bool, device=dev)
        evicted.scatter_(1, torch.where(old >= 0, old, n), True)
        owner_of_row = torch.where(evicted[:, :n], -1, owner_of_row)
        seat = torch.full((n_str, n + 1), -1, dtype=torch.long, device=dev)
        seat.scatter_(1, torch.where(got, winner, n),
                      rows.expand(n_str, n).clone())
        owner_of_row = torch.where(seat[:, :n] >= 0, seat[:, :n],
                                   owner_of_row)
        row_of_col = torch.where(got, winner, row_of_col)
        prices = torch.where(got, top, prices)
    col = owner_of_row[:, :t]
    real = (col >= 0) & (col < d)
    ok = real & feasible.gather(2, col.clamp(0, d - 1)[..., None])[..., 0]
    return torch.where(ok, col, -1)


# -- the step ----------------------------------------------------------------

def step(st: State, frames: torch.Tensor, dets: torch.Tensor,
         det_valid: torch.Tensor, p: Params, precision: str = "float32"
         ) -> tuple[State, Out]:
    """One frame of S streams: frames [S, H, W] u8, dets [S, D, 5],
    det_valid [S, D] -> (new state, outputs)."""
    ar = _Arith(precision)
    dev = frames.device
    n_str, t = st.state.shape
    d = dets.shape[1]
    f = p.template
    h_f, w_f = p.frame_hw
    alive = st.state > EMPTY
    det_valid = det_valid & (dets[..., 4] >= p.det_score_min)
    det_boxes = dets[..., :4]

    # 1. Kalman predict.
    mean, cov = _kf_predict(st.kf_mean, st.kf_cov, p, ar)
    pred = mean[..., :4]

    # 2. KCF detect at the predicted windows.
    levels = pyramid(frames)
    hann = _hann(f, dev)
    feats = ((sample_windows(levels, pred, p) - 0.5) * hann)[:, :, None]
    zf = ar.rfft2(feats)                                    # [S, T, 1, F, Fh]
    kf = _kernel_corr(zf, st.xf, p, ar)
    resp = ar.irfft2(kf * st.alphaf, f)
    dy, dx, peak, py, px = _peak(resp)
    psr = _psr(resp, peak, py, px)
    win = pred[..., 2:4] * p.padding
    kcf_xy = pred[..., :2] + torch.stack([dx, dy], dim=-1) * win / f
    in_frame = ((pred[..., 0] > 0) & (pred[..., 0] < w_f)
                & (pred[..., 1] > 0) & (pred[..., 1] < h_f))
    kcf_ok = alive & in_frame & (psr >= p.min_psr) & (st.age != 1)
    refined = torch.where(kcf_ok[..., None],
                          torch.cat([kcf_xy, pred[..., 2:4]], dim=-1), pred)

    # 3-4. Cost and assignment.
    iou = _iou(refined, det_boxes)
    feasible = ((iou >= p.iou_gate) & alive[..., :, None]
                & det_valid[..., None, :])
    cost = torch.where(feasible, 1.0 - iou, p.infeasible)
    match = auction(cost, cost < p.infeasible * 0.5, p.eps, p.max_iters)
    matched = match >= 0
    didx = match.clamp_min(0)
    taken = torch.zeros((n_str, d + 1), dtype=torch.bool, device=dev)
    taken.scatter_(1, torch.where(matched, match, d), True)
    taken = taken[:, :d]

    def at_det(x, i):
        if x.ndim == 2:
            return x.gather(1, i)
        return x.gather(1, i[..., None].expand(-1, -1, x.shape[-1]))

    # 5. Kalman correct with the detection, or with a trusted KCF peak.
    z = torch.where(matched[..., None], at_det(det_boxes, didx), refined)
    mean, cov = _kf_correct(mean, cov, z,
                            matched | (alive & kcf_ok), p, ar)

    # 6-7. Lifecycle.
    hits = torch.where(matched, st.hits + 1, st.hits)
    tsu = torch.where(matched, 0, st.tsu + 1)
    age = torch.where(alive, st.age + 1, 0)
    state = torch.where((st.state == TENTATIVE) & (hits >= p.n_init),
                        CONFIRMED, st.state)
    die = alive & (((state == CONFIRMED) & (tsu > p.max_age))
                   | ((state == TENTATIVE) & ~matched
                      & (tsu > p.max_age_tentative)))
    state = torch.where(die, EMPTY, state)
    free = state == EMPTY
    new_det = det_valid & ~taken
    # The r-th unmatched detection takes the r-th free slot.
    slot_det = torch.full((n_str, t), -1, dtype=torch.long, device=dev)
    for s in range(n_str):
        slots = torch.nonzero(free[s])[:, 0]
        cand = torch.nonzero(new_det[s])[:, 0]
        k = min(len(slots), len(cand))
        slot_det[s, slots[:k]] = cand[:k]
    birth = slot_det >= 0
    bdet = slot_det.clamp_min(0)
    imean, icov = _kf_init(at_det(det_boxes, bdet), p)
    mean = torch.where(birth[..., None], imean, mean)
    cov = torch.where(birth[..., None, None], icov, cov)
    state = torch.where(birth, TENTATIVE, state)
    hits = torch.where(birth, 1, hits)
    tsu = torch.where(birth, 0, tsu)
    age = torch.where(birth, 1, age)
    n_birth = birth.sum(-1)
    ids = torch.where(birth, st.next_id[:, None]
                      + torch.cumsum(birth.long(), -1) - 1, st.ids)
    ids = torch.where(state == EMPTY, -1, ids)
    score = torch.where(birth, at_det(dets[..., 4], bdet), st.score)
    score = torch.where(matched, at_det(dets[..., 4], didx), score)

    # 8. Detect-site training: the detect sample, shifted to the corrected
    # centre, blended into the model.
    live = state > EMPTY
    w_safe = (pred[..., 2:4] * p.padding).clamp_min(1e-6)
    delta = (mean[..., :2] - pred[..., :2]) * f / w_safe
    guard = (delta.abs() < f / 4).all(dim=-1)
    delta = torch.where(guard[..., None], delta, 0.0)
    ky = ((torch.arange(f, device=dev) + f // 2) % f - f // 2).float()
    kx = torch.arange(f // 2 + 1, device=dev).float()
    theta = 2.0 * math.pi * (ky[:, None] * (delta[..., 1, None, None] / f)
                             + kx * (delta[..., 0, None, None] / f))
    zf_a = zf * torch.polar(torch.ones_like(theta), theta)[:, :, None]
    kxx = _kernel_corr(zf_a, zf_a, p, ar)
    alphaf_new = _yf(p, ar, dev) / (kxx + p.lam)
    init_now = live & (age == 2) & ~birth
    lr = torch.where(init_now, 1.0,
                     torch.where(live & ~birth & guard & (matched | kcf_ok),
                                 p.interp, 0.0))
    lr_x = lr[..., None, None, None]
    lr_a = lr[..., None, None]
    xf = st.xf * (1.0 - lr_x) + zf_a * lr_x
    alphaf = st.alphaf * (1.0 - lr_a) + alphaf_new * lr_a

    new = State(kf_mean=mean, kf_cov=cov, xf=xf, alphaf=alphaf,
                ids=ids.to(torch.int32), state=state.to(torch.int32),
                hits=hits.to(torch.int32), tsu=tsu.to(torch.int32),
                age=age.to(torch.int32), score=score,
                next_id=(st.next_id + n_birth).to(torch.int32))
    out = Out(ids=new.ids, boxes=mean[..., :4],
              valid=(new.state == CONFIRMED))
    return new, out
