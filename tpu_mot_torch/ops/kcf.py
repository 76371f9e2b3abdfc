"""Batched KCF correlation-filter math in the FFT domain (counterpart of
tpu_mot/ops/kcf.py).

Every op carries a leading track-bank axis.  Spectra are complex64 half
spectra: features [T, C, S, S] -> [T, C, S, Sf], Sf = S//2 + 1.  Math
follows arXiv:1404.7584 (KCF): Gaussian kernel correlation (eq. 31),
dual-space ridge training (eq. 17), detection response (eq. 22).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from tpu_mot_torch.ops import fft as fft_ops
from tpu_mot_torch.ops import window as window_ops


class KCFModel(NamedTuple):
    """Per-track learned state: template spectrum and dual coefficients."""
    xf: torch.Tensor        # [T, C, S, Sf] complex64
    alphaf: torch.Tensor    # [T, S, Sf] complex64


def _abs2(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def _parseval_energy(xf: torch.Tensor, width: int) -> torch.Tensor:
    """sum(|x|^2) over (C, S, S) from the half spectrum (Parseval with
    Hermitian column folding): ||x||^2 = sum(w_k |X|^2) / N."""
    wts = fft_ops._hermitian_weights(width, xf.device)
    n = xf.shape[-2] * width
    return torch.sum(_abs2(xf) * wts, dim=(-3, -2, -1)) / n


def gaussian_correlation(xf: torch.Tensor, zf: torch.Tensor, sigma: float,
                         width: int) -> torch.Tensor:
    """Gaussian-kernel correlation k^{xz} for all cyclic shifts (eq. 31),
    with the cross term from one inverse FFT of sum_c X_c * conj(Z_c).

    xf, zf: [..., C, S, Sf] spectra.  Returns k_f = rfft2(k) [..., S, Sf].
    """
    s = xf.shape[-2]
    c = xf.shape[-3]
    xx = _parseval_energy(xf, width)
    zz = _parseval_energy(zf, width)
    cross_f = torch.sum(xf * torch.conj(zf), dim=-3)
    cross = fft_ops.irfft2(cross_f, width)                       # [..., S, S]
    numel = s * width * c
    d = (xx + zz)[..., None, None] - 2.0 * cross
    k = torch.exp(-torch.clamp_min(d, 0.0) / (sigma * sigma * numel))
    return fft_ops.rfft2(k)


def div_real_shifted(y: torch.Tensor, k: torch.Tensor,
                     lam: float) -> torch.Tensor:
    """y / (k + lam), the dual-space ridge solve (eq. 17), with the
    denominator floored at 1e-20 as in the JAX package."""
    dr = k.real + lam
    ki = k.imag
    inv = 1.0 / torch.clamp_min(dr * dr + ki * ki, 1e-20)
    return torch.complex((y.real * dr + y.imag * ki) * inv,
                         (y.imag * dr - y.real * ki) * inv)


def train(feat: torch.Tensor, yf: torch.Tensor, sigma: float,
          lambda_: float) -> KCFModel:
    """Ridge training (eq. 17) on features [T, C, S, S]; no blending."""
    return train_from_spectrum(fft_ops.rfft2(feat), yf, sigma, lambda_,
                               feat.shape[-1])


def train_from_spectrum(xf: torch.Tensor, yf: torch.Tensor, sigma: float,
                        lambda_: float, width: int) -> KCFModel:
    """Ridge training (eq. 17) on feature spectra xf [T, C, S, Sf] against
    the shared target spectrum yf [S, Sf]."""
    kf = gaussian_correlation(xf, xf, sigma, width)
    return KCFModel(xf=xf, alphaf=div_real_shifted(yf, kf, lambda_))


def shift_spectrum(zf: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                   width: int) -> torch.Tensor:
    """Circularly translate patches by (+dy, +dx) pixels in the Fourier
    domain: f(n + d) <-> F(k) e^{+2 pi i k d / N}.  Row frequencies are
    signed, which fractional shifts require; the rfft column axis is
    already non-negative.

    zf [..., T, C, S, Sf], dy/dx [..., T] float.
    """
    s = zf.shape[-2]
    sf = zf.shape[-1]
    dev = zf.device
    ky = ((torch.arange(s, device=dev) + s // 2) % s - s // 2).to(
        torch.float32)
    kx = torch.arange(sf, device=dev).to(torch.float32)
    theta = (2.0 * math.pi) * (
        ky[:, None] * (dy[..., None, None] / s)
        + kx * (dx[..., None, None] / width))                    # [T, S, Sf]
    c = torch.cos(theta).unsqueeze(-3)
    sn = torch.sin(theta).unsqueeze(-3)
    re, im = zf.real, zf.imag
    return torch.complex(re * c - im * sn, re * sn + im * c)


def blend(model: KCFModel, new: KCFModel, lr) -> KCFModel:
    """EMA model update; lr is a scalar or a per-track [T] rate."""
    lr = torch.as_tensor(lr, dtype=torch.float32, device=model.xf.device)
    lr_x = lr.reshape(lr.shape + (1,) * (model.xf.ndim - lr.ndim))
    lr_a = lr.reshape(lr.shape + (1,) * (model.alphaf.ndim - lr.ndim))
    return KCFModel(xf=_lerp(model.xf, new.xf, lr_x),
                    alphaf=_lerp(model.alphaf, new.alphaf, lr_a))


def _lerp(a: torch.Tensor, b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.complex(a.real * (1.0 - t) + b.real * t,
                         a.imag * (1.0 - t) + b.imag * t)


def detect_from_spectrum(model: KCFModel, zf: torch.Tensor, sigma: float,
                         width: int) -> torch.Tensor:
    """Correlation response (eq. 22) of the model bank on feature spectra
    zf [T, C, S, Sf] -> [T, S, S] real."""
    kf = gaussian_correlation(zf, model.xf, sigma, width)
    return fft_ops.irfft2(kf * model.alphaf, width)


def detect(model: KCFModel, feat: torch.Tensor, sigma: float
           ) -> torch.Tensor:
    """Correlation response (eq. 22) of the model bank on features
    [..., T, C, S, S] -> [..., T, S, S]."""
    return detect_from_spectrum(model, fft_ops.rfft2(feat), sigma,
                                feat.shape[-1])


class Search(NamedTuple):
    """What `search` found: the chosen scale's displacement and raw peak,
    and what the tracker reads beside them."""
    dy: torch.Tensor         # [R] template pixels, at the chosen scale
    dx: torch.Tensor         # [R]
    peak: torch.Tensor       # [R] raw peak of the chosen scale
    best: torch.Tensor       # [R] int64 chosen scale index
    response: torch.Tensor   # [K, R, S, S]
    peaks: torch.Tensor      # [K, R] each response's peak value
    idx: torch.Tensor        # [K, R] int64 each response's first-max index
    zf: torch.Tensor | None  # [K, R, C, S, Sf] spectra; None when K4 ran


@functools.lru_cache(maxsize=None)
def search_scales(scale_step: float, scale_weight: float, device: str
                  ) -> tuple[tuple, torch.Tensor, torch.Tensor]:
    """The scale search's scales as Python floats, then as float32 [K]
    tensors the scale values and their hysteresis weights, built once per
    device: K = 1 ((1.0,) with weight 1.0) at scale_step 1.0, else the
    3-scale search (1/step, 1, step) with weights (weight, 1, weight).
    Cached: treat the tensors as read-only."""
    if scale_step == 1.0:
        vals, wts = (1.0,), (1.0,)
    else:
        vals = (1.0 / scale_step, 1.0, scale_step)
        wts = (scale_weight, 1.0, scale_weight)
    return (vals, torch.tensor(vals, dtype=torch.float32).to(device),
            torch.tensor(wts, dtype=torch.float32).to(device))


def search(model: KCFModel, feats: torch.Tensor, sigma: float,
           scale_wts: torch.Tensor, impl: str = "auto") -> Search:
    """Correlate ONE model bank [R] against features [K, R, C, S, S] at K
    scales (scale-major) and keep, per row, the scale of the best peak
    weighted by `scale_wts` [K] (hysteresis: the first of equal weighted
    peaks wins).  K = 1 with weight 1.0 is the unit-scale detect: the
    selection is then the identity, bit for bit.

    impl is TrackerConfig.kcf_impl, which the step passes on here:

      "auto"    the torch.fft chain here (its spectra are returned, and
                detect-site training reuses them), except detect-site
                training of a gray 64 x 64 bank on the card, which is K6
                (`train_shift_on_kernel` decides by the input)
      "xla"     the torch.fft chain everywhere
      "pallas"  the fused kernel wrappers, on the CPU their plain versions:
                K4 for this search (kernels/kcf.detect_fused on the [K*R]
                items, item k*R + r against model row r), K5 for
                refined-site training (`train_blend_auto`), and K6 where
                "auto" takes it"""
    k, r = feats.shape[:2]
    if impl == "pallas":
        from tpu_mot_torch.kernels import kcf as kcf_kernels
        flat = kcf_kernels.detect_fused(
            model, feats.reshape((k * r,) + feats.shape[2:]), sigma)
        response = flat.reshape((k, r) + flat.shape[1:])
        zf = None
    else:
        zf = fft_ops.rfft2(feats)
        response = detect_from_spectrum(model, zf, sigma, feats.shape[-1])
    dys, dxs, peaks, idx = peak_displacement(response)           # [K, R]
    best = torch.argmax(peaks * scale_wts[:, None], dim=0)[None]  # [1, R]
    return Search(dy=dys.gather(0, best)[0], dx=dxs.gather(0, best)[0],
                  peak=peaks.gather(0, best)[0], best=best[0],
                  response=response, peaks=peaks, idx=idx, zf=zf)


def train_blend_auto(model: KCFModel, feat: torch.Tensor, yf: torch.Tensor,
                     sigma: float, lambda_: float, lr: torch.Tensor,
                     impl: str = "auto") -> KCFModel:
    """blend(model, train(feat), lr) with implementation dispatch by
    kcf_impl, as in `search`: "pallas" = kernels/kcf.train_fused (K5 on
    the card), "auto"/"xla" = the FFT chain here."""
    if impl == "pallas":
        from tpu_mot_torch.kernels import kcf as kcf_kernels
        return kcf_kernels.train_fused(model, feat, yf, sigma, lambda_, lr)
    return blend(model, train(feat, yf, sigma, lambda_), lr)


def train_shift_on_kernel(device_type: str, c: int, s: int, width: int,
                          impl: str) -> bool:
    """Whether `train_shift_blend_auto` launches the fused kernel K6: a
    CUDA spectrum of one channel at S = width = 64 under kcf_impl "auto" or
    "pallas".  "xla", the CPU and every other shape (fHOG's C = 31, other
    template sizes) take the FFT chain."""
    return (device_type == "cuda" and c == 1 and s == width == 64
            and impl in ("auto", "pallas"))


def train_shift_blend_auto(model: KCFModel, zf: torch.Tensor,
                           dy: torch.Tensor, dx: torch.Tensor,
                           yf: torch.Tensor, sigma: float, lambda_: float,
                           lr: torch.Tensor, width: int,
                           impl: str = "auto") -> KCFModel:
    """Detect-site training: blend(model, train_from_spectrum(
    shift_spectrum(zf, dy, dx)), lr) on spectra zf [T, C, S, Sf], with
    dispatch by what the input is (`train_shift_on_kernel`): the kernel
    wrapper kernels/kcf.train_shift_fused (K6) or the chain here."""
    if train_shift_on_kernel(zf.device.type, zf.shape[-3], zf.shape[-2],
                             width, impl):
        from tpu_mot_torch.kernels import kcf as kcf_kernels
        return kcf_kernels.train_shift_fused(
            KCFModel(*[x.contiguous() for x in model]), zf.contiguous(), dy,
            dx, yf, sigma, lambda_, lr, width)
    return blend(model, train_from_spectrum(
        shift_spectrum(zf, dy, dx, width), yf, sigma, lambda_, width), lr)


def peak_displacement(response: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Response peak with a parabolic sub-pixel fit per axis, clipped to
    half a pixel: [..., T, S, S] -> (dy, dx, peak, idx), each [..., T], in
    template pixels relative to the patch center; idx is the flat index of
    the peak, the first maximum, as jnp.argmax takes it."""
    lead = response.shape[:-2]
    s = response.shape[-1]
    flat = response.reshape(-1, s * s)
    t = flat.shape[0]
    idx = torch.argmax(flat, dim=1)
    rows = torch.arange(t, device=response.device)
    peak = flat[rows, idx]
    py = idx // s
    px = idx % s

    def subpixel(p, left, right):
        denom = 2.0 * peak - left - right
        delta = torch.where(
            torch.abs(denom) > 1e-8,
            0.5 * (right - left) / torch.clamp_min(denom, 1e-8), 0.0)
        delta = delta.clamp(-0.5, 0.5)
        interior = (p > 0) & (p < s - 1)
        return torch.where(interior, delta, 0.0)

    ly = flat[rows, torch.clamp_min(py - 1, 0) * s + px]
    ry = flat[rows, torch.clamp_max(py + 1, s - 1) * s + px]
    lx = flat[rows, py * s + torch.clamp_min(px - 1, 0)]
    rx = flat[rows, py * s + torch.clamp_max(px + 1, s - 1)]
    dy = py.to(torch.float32) + subpixel(py, ly, ry) - (s // 2)
    dx = px.to(torch.float32) + subpixel(px, lx, rx) - (s // 2)
    return (dy.reshape(lead), dx.reshape(lead), peak.reshape(lead),
            idx.reshape(lead))


def psr(response: torch.Tensor, peak: torch.Tensor, idx: torch.Tensor,
        exclude: int = 5) -> torch.Tensor:
    """Peak-to-sidelobe ratio (peak - mean_sidelobe) / std_sidelobe with an
    exclusion window of `exclude` pixels around the peak: response
    [..., T, S, S], peak [..., T] and its flat index idx [..., T] (from
    `peak_displacement`) -> [..., T]."""
    lead = response.shape[:-2]
    sz = response.shape[-1]
    response = response.reshape(-1, sz, sz)
    idx = idx.reshape(-1)
    py = (idx // sz).to(torch.float32)
    px = (idx % sz).to(torch.float32)
    iota = torch.arange(sz, dtype=torch.float32, device=response.device)
    yy = iota[:, None].expand(sz, sz)
    xx = iota[None, :].expand(sz, sz)
    side = ((torch.abs(yy[None] - py[:, None, None]) > exclude)
            | (torch.abs(xx[None] - px[:, None, None]) > exclude))
    n = torch.clamp_min(side.sum(dim=(1, 2)).to(torch.float32), 1.0)
    mean = torch.where(side, response, 0.0).sum(dim=(1, 2)) / n
    var = torch.where(side, (response - mean[:, None, None]) ** 2,
                      0.0).sum(dim=(1, 2)) / n
    return ((peak.reshape(-1) - mean) / torch.sqrt(var + 1e-8)).reshape(lead)


@functools.lru_cache(maxsize=None)
def _make_yf_cached(size: int, padding: float, output_sigma_factor: float,
                    device: str) -> torch.Tensor:
    sigma = window_ops.output_sigma(size, size, padding, output_sigma_factor)
    return fft_ops.rfft2(window_ops.gaussian_peak(
        size, size, sigma, device=device)).contiguous()


def make_yf(size: int, padding: float, output_sigma_factor: float,
            device=None) -> torch.Tensor:
    """Spectrum of the shared desired-response Gaussian [S, Sf].  Cached
    per device (the per-frame path copies nothing from the host): treat it
    as read-only."""
    return _make_yf_cached(size, padding, output_sigma_factor,
                           str(torch.device(device or "cpu")))
