"""Fused KCF detect, train and search: the CUDA kernels K4, K5, K6 and K8
(csrc/kcf.cu) and their plain torch versions (K4 and K5 are the
counterparts of tpu_mot/kernels/kcf.py; K6 and K8 have no TPU kernel).

  detect_fused : feat [N, C, S, S] against a model bank of T rows (N a
                 multiple of T; item i reads model row i % T, the
                 scale-major [K*T] layout of the 3-scale search) ->
                 response [N, S, S]                     (eqs. 31, 22)
  train_fused  : feat [T, C, S, S] -> x^, k^xx, alpha^ = y^/(k^+lambda),
                 blended into the bank with a per-track lr  (eq. 17)
  train_shift_fused : detect-site training, C = 1 and S = 64 only: the
                 spectrum zf [T, 1, 64, 33] phase-shifted by (dy, dx) [T],
                 trained as train_fused and blended with lr [T]
  search_fused : stage 2's search, C = 1 and S = 64 only: feat [N, 1, 64,
                 64] against a bank of R rows (item i, row i % R) -> z^,
                 the response, its first-max peak with the sub-pixel fit,
                 and its PSR                    (eqs. 31, 22; `SearchRows`)

The plain versions are the torch.fft chain of ops/kcf.py: `detect` on the
tiled model, `blend(model, train(feat), lr)`, blend(model,
train_from_spectrum(shift_spectrum(zf, dy, dx)), lr), and rfft2 ->
detect_from_spectrum -> peak_displacement -> psr.  The wrappers launch the
kernel for CUDA tensors and run the plain version for CPU tensors, as the
JAX package runs its Pallas kernels in interpret mode on the CPU; for a
CUDA tensor they launch or raise, never fall back.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_mot_torch.kernels import _build
from tpu_mot_torch.ops import fft as fft_ops
from tpu_mot_torch.ops import kcf as kcf_ops

MAX_S = 64          # direct row/column DFTs: S <= 64
# K4's and K5's code paths (csrc/kcf.cu: `kcf_detect_kernel` /
# `kcf_detect_fft16_kernel`, `kcf_train_kernel` / `kcf_train_fft16_kernel`):
# chosen by the shape alone, given 16-byte aligned features, response and
# model (any tensor torch allocates).
PATHS = ("direct DFTs", "FFTs in registers (S = 16, C <= 32)")

# Kernel launches made by `detect_fused` (K4), `train_fused` (K5) and
# `train_shift_fused` (K6): plain counts; reset them to 0 to measure a run.
launches_detect = 0
launches_train = 0
launches_train_shift = 0
# Kernel launches made by `search_fused` (K8).
launches_search = 0

# K6's and K8's one shape: a gray (C = 1) 64 x 64 template.
SHIFT_S = 64


@functools.lru_cache(maxsize=None)
def _twiddles(s: int, device: str) -> torch.Tensor:
    """e^{-2 pi i j / s}, j < s, computed in float64 and rounded to
    complex64 (the TPU kernel's DFT operators are built the same way);
    cached per device: read-only."""
    theta = 2.0 * np.pi * np.arange(s, dtype=np.float64) / s
    tw = (np.cos(theta) - 1j * np.sin(theta)).astype(np.complex64)
    return torch.as_tensor(tw, device=device)


def _tile(model: kcf_ops.KCFModel, k: int) -> kcf_ops.KCFModel:
    return kcf_ops.KCFModel(*[x.repeat((k,) + (1,) * (x.ndim - 1))
                              for x in model])


def detect_fused_ref(model: kcf_ops.KCFModel, feat: torch.Tensor,
                     sigma: float) -> torch.Tensor:
    """Plain version of `detect_fused`: ops/kcf.detect on the model tiled
    to the items."""
    reps = feat.shape[0] // model.xf.shape[0]
    return kcf_ops.detect(_tile(model, reps), feat, sigma)


def train_fused_ref(model: kcf_ops.KCFModel, feat: torch.Tensor,
                    yf: torch.Tensor, sigma: float, lambda_: float,
                    lr: torch.Tensor) -> kcf_ops.KCFModel:
    """Plain version of `train_fused`: blend(model, train(feat), lr)."""
    return kcf_ops.blend(model, kcf_ops.train(feat, yf, sigma, lambda_), lr)


def train_shift_fused_ref(model: kcf_ops.KCFModel, zf: torch.Tensor,
                          dy: torch.Tensor, dx: torch.Tensor,
                          yf: torch.Tensor, sigma: float, lambda_: float,
                          lr: torch.Tensor, width: int) -> kcf_ops.KCFModel:
    """Plain version of `train_shift_fused`: stage 8's detect-site chain,
    blend(model, train_from_spectrum(shift_spectrum(zf, dy, dx)), lr)."""
    return kcf_ops.blend(model, kcf_ops.train_from_spectrum(
        kcf_ops.shift_spectrum(zf, dy, dx, width), yf, sigma, lambda_,
        width), lr)


class SearchRows(NamedTuple):
    """What `search_fused` finds for each of its N items."""
    zf: torch.Tensor         # [N, 1, 64, 33] complex64 feature spectra
    response: torch.Tensor   # [N, 64, 64]
    dy: torch.Tensor         # [N] sub-pixel peak offsets from the center
    dx: torch.Tensor         # [N]
    peak: torch.Tensor       # [N] peak value
    idx: torch.Tensor        # [N] int64 flat index of the first maximum
    psr: torch.Tensor        # [N] peak-to-sidelobe ratio


def search_fused_ref(model: kcf_ops.KCFModel, feat: torch.Tensor,
                     sigma: float) -> SearchRows:
    """Plain version of `search_fused`: the chain ops/kcf.search runs, on
    the items as [N / R, R] against the bank: rfft2, detect_from_spectrum,
    peak_displacement and psr."""
    n, r = feat.shape[0], model.xf.shape[0]
    width = feat.shape[-1]
    zf = fft_ops.rfft2(feat.reshape((n // r, r) + feat.shape[1:]))
    response = kcf_ops.detect_from_spectrum(model, zf, sigma, width)
    response = response.reshape((n,) + response.shape[2:])
    dy, dx, peak, idx = kcf_ops.peak_displacement(response)
    return SearchRows(zf.reshape((n,) + zf.shape[2:]), response, dy, dx,
                      peak, idx, kcf_ops.psr(response, peak, idx))


def _check(what: str, name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(
            f"{what}: {name} must be a contiguous {dtype} {shape} tensor on "
            f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous: {t.is_contiguous()})")


# Kept per process: the limits are the device's and the sources', and
# asking the library on every call costs host time on a launch-bound path.
@functools.lru_cache(maxsize=None)
def _smem_limit() -> int:
    return _build.load().tpu_mot_kcf_smem_limit()


@functools.lru_cache(maxsize=None)
def _smem_need(what: str, c: int, s: int) -> int:
    """Shared memory per CTA of the kernel that `what` launches."""
    lib = _build.load()
    if what == "detect_fused":
        return lib.tpu_mot_kcf_detect_smem_bytes(c, s)
    return lib.tpu_mot_kcf_train_smem_bytes(c, s)


def _launch_info(entry: str, c: int, s: int) -> dict:
    info = _build.launch_info(getattr(_build.load(), entry), c, s)
    info["path"] = PATHS[info["path"]]
    return info


def detect_launch_info(c: int, s: int) -> dict:
    """What K4 launches for C channels of S x S features: code path (a name
    from PATHS), threads, registers, shared memory, CTAs per SM."""
    return _launch_info("tpu_mot_kcf_detect_info", c, s)


def train_launch_info(c: int, s: int) -> dict:
    """What K5 launches for C channels of S x S features, as
    `detect_launch_info`."""
    return _launch_info("tpu_mot_kcf_train_info", c, s)


def train_shift_launch_info() -> dict:
    """What K6 launches, as `detect_launch_info` (its one code path is
    0; shared memory is static)."""
    return _build.launch_info(_build.load().tpu_mot_kcf_train_shift_info)


def search_launch_info() -> dict:
    """What K8 launches, as `train_shift_launch_info`."""
    return _build.launch_info(_build.load().tpu_mot_kcf_search_info)


def _check_shape(what: str, c: int, s: int) -> None:
    if not 2 <= s <= MAX_S:
        raise ValueError(f"{what}: feature size S={s} outside 2..{MAX_S} "
                         "(the generic kernel's DFTs are direct sums)")
    need, limit = _smem_need(what, c, s), _smem_limit()
    if need > limit:
        raise ValueError(
            f"{what}: C={c}, S={s} needs {need} bytes of shared memory per "
            f"CTA, above the device's {limit}")


def detect_fused(model: kcf_ops.KCFModel, feat: torch.Tensor,
                 sigma: float) -> torch.Tensor:
    """Correlation response of the model bank on feat [N, C, S, S] ->
    [N, S, S]; item i against model row i % T.  K4 for CUDA tensors, the
    plain version for CPU tensors."""
    global launches_detect
    what = "detect_fused"
    n, c, s, _ = feat.shape
    t = model.xf.shape[0]
    if t < 1 or n % t:
        raise ValueError(f"{what}: {n} items is not a multiple of the "
                         f"model's {t} rows")
    if not _build.on_card(what, feat):
        return detect_fused_ref(model, feat, sigma)
    dev = feat.device
    sf = s // 2 + 1
    _check(what, "feat", feat, torch.float32, (n, c, s, s), dev)
    _check(what, "xf", model.xf, torch.complex64, (t, c, s, sf), dev)
    _check(what, "alphaf", model.alphaf, torch.complex64, (t, s, sf), dev)
    _check_shape(what, c, s)
    lib = _build.load()
    out = torch.empty((n, s, s), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    tw = _twiddles(s, str(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpu_mot_kcf_detect(
            feat.data_ptr(), model.xf.data_ptr(), model.alphaf.data_ptr(),
            tw.data_ptr(), out.data_ptr(), n, t, c, s,
            float(sigma * sigma * (s * s * c)), stream)
    _build.check(rc, what)
    launches_detect += 1
    return out


def train_fused(model: kcf_ops.KCFModel, feat: torch.Tensor,
                yf: torch.Tensor, sigma: float, lambda_: float,
                lr: torch.Tensor) -> kcf_ops.KCFModel:
    """Train on feat [T, C, S, S] against yf [S, Sf] and blend into the
    bank with lr [T] (old (1 - lr) + new lr).  K5 for CUDA tensors, the
    plain version for CPU tensors."""
    global launches_train
    what = "train_fused"
    t, c, s, _ = feat.shape
    if not _build.on_card(what, feat):
        return train_fused_ref(model, feat, yf, sigma, lambda_, lr)
    dev = feat.device
    sf = s // 2 + 1
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    _check(what, "feat", feat, torch.float32, (t, c, s, s), dev)
    _check(what, "xf", model.xf, torch.complex64, (t, c, s, sf), dev)
    _check(what, "alphaf", model.alphaf, torch.complex64, (t, s, sf), dev)
    _check(what, "yf", yf, torch.complex64, (s, sf), dev)
    _check(what, "lr", lr, torch.float32, (t,), dev)
    _check_shape(what, c, s)
    lib = _build.load()
    out = kcf_ops.KCFModel(xf=torch.empty_like(model.xf),
                           alphaf=torch.empty_like(model.alphaf))
    if t == 0:
        return out
    tw = _twiddles(s, str(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpu_mot_kcf_train(
            feat.data_ptr(), model.xf.data_ptr(), model.alphaf.data_ptr(),
            yf.data_ptr(), lr.data_ptr(), tw.data_ptr(), out.xf.data_ptr(),
            out.alphaf.data_ptr(), t, c, s,
            float(sigma * sigma * (s * s * c)), float(lambda_), stream)
    _build.check(rc, what)
    launches_train += 1
    return out


def train_shift_fused(model: kcf_ops.KCFModel, zf: torch.Tensor,
                      dy: torch.Tensor, dx: torch.Tensor, yf: torch.Tensor,
                      sigma: float, lambda_: float, lr: torch.Tensor,
                      width: int) -> kcf_ops.KCFModel:
    """Detect-site training of a gray 64 x 64 bank: the spectrum zf [T, 1,
    64, 33] shifted by (dy, dx) [T] feature pixels, trained against yf
    [64, 33] and blended into the bank with lr [T] (old (1 - lr) + new
    lr), into new tensors.  K6 for CUDA tensors (16-byte aligned,
    contiguous), the plain version for CPU tensors."""
    global launches_train_shift
    what = "train_shift_fused"
    if not _build.on_card(what, zf):
        return train_shift_fused_ref(model, zf, dy, dx, yf, sigma, lambda_,
                                     lr, width)
    dev = zf.device
    t = zf.shape[0]
    s, sf = SHIFT_S, SHIFT_S // 2 + 1
    if width != s:
        raise ValueError(f"{what}: width {width}, the kernel takes {s}")
    _check(what, "zf", zf, torch.complex64, (t, 1, s, sf), dev)
    _check(what, "xf", model.xf, torch.complex64, (t, 1, s, sf), dev)
    _check(what, "alphaf", model.alphaf, torch.complex64, (t, s, sf), dev)
    _check(what, "yf", yf, torch.complex64, (s, sf), dev)
    for name, v in (("dy", dy), ("dx", dx), ("lr", lr)):
        _check(what, name, v, torch.float32, (t,), dev)
    for name, v in (("zf", zf), ("xf", model.xf), ("alphaf", model.alphaf),
                    ("yf", yf)):
        if v.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    out = kcf_ops.KCFModel(xf=torch.empty_like(model.xf),
                           alphaf=torch.empty_like(model.alphaf))
    if t == 0:
        return out
    lib = _build.load()
    tw = _twiddles(s, str(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpu_mot_kcf_train_shift(
            zf.data_ptr(), model.xf.data_ptr(), model.alphaf.data_ptr(),
            yf.data_ptr(), dy.data_ptr(), dx.data_ptr(), lr.data_ptr(),
            tw.data_ptr(), out.xf.data_ptr(), out.alphaf.data_ptr(), t,
            float(sigma * sigma * (s * s)), float(lambda_), stream)
    _build.check(rc, what)
    launches_train_shift += 1
    return out


def search_fused(model: kcf_ops.KCFModel, feat: torch.Tensor,
                 sigma: float) -> SearchRows:
    """Stage 2's search of a gray 64 x 64 bank of R rows on feat [N, 1, 64,
    64], item i against row i % R (N a multiple of R): the feature spectra,
    the response and what the tracker reads of it (`SearchRows`), into new
    tensors.  K8 for CUDA tensors (contiguous; K8 reads them element by
    element, so it needs no alignment beyond their elements'), the plain
    version for CPU tensors."""
    global launches_search
    what = "search_fused"
    n = feat.shape[0]
    r = model.xf.shape[0]
    if r < 1 or n % r:
        raise ValueError(f"{what}: {n} items is not a multiple of the "
                         f"model's {r} rows")
    if not _build.on_card(what, feat):
        return search_fused_ref(model, feat, sigma)
    dev = feat.device
    s, sf = SHIFT_S, SHIFT_S // 2 + 1
    _check(what, "feat", feat, torch.float32, (n, 1, s, s), dev)
    _check(what, "xf", model.xf, torch.complex64, (r, 1, s, sf), dev)
    _check(what, "alphaf", model.alphaf, torch.complex64, (r, s, sf), dev)
    if n >= 2 ** 31:
        raise ValueError(f"{what}: {n} items, the grid takes < 2^31")
    zf = torch.empty((n, 1, s, sf), dtype=torch.complex64, device=dev)
    response = torch.empty((n, s, s), dtype=torch.float32, device=dev)
    stats = torch.empty((4, n), dtype=torch.float32, device=dev)
    idx = torch.empty((n,), dtype=torch.int64, device=dev)
    out = SearchRows(zf, response, stats[0], stats[1], stats[2], idx,
                     stats[3])
    if n == 0:
        return out
    lib = _build.load()
    tw = _twiddles(s, str(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpu_mot_kcf_search(
            feat.data_ptr(), model.xf.data_ptr(), model.alphaf.data_ptr(),
            tw.data_ptr(), zf.data_ptr(), response.data_ptr(),
            stats.data_ptr(), idx.data_ptr(), n, r,
            float(sigma * sigma * (s * s)), stream)
    _build.check(rc, what)
    launches_search += 1
    return out


# ---- numpy mirror of the S = 16 path's FFT schedule (csrc/kcf.cu) -------
#
# The kernel's 16-point FFT is a 4 x 4 Cooley-Tukey schedule in one
# thread's registers, leaving output k in slot REV16[k]; real rows go two
# at a time through one complex FFT.  The functions below repeat that
# schedule, slot for slot, on a trailing axis of 16 in the dtype they are
# given, so the CPU tests can hold it against numpy's FFT.

REV16 = tuple(4 * (k & 3) + (k >> 2) for k in range(16))
_C1, _S1, _R2 = np.cos(np.pi / 8), np.sin(np.pi / 8), np.sqrt(0.5)
# slot -> (cos, sin) of its twiddle w16^(b k1) between the two passes
_TWIDDLES = {5: (_C1, _S1), 9: (_R2, _R2), 13: (_S1, _C1), 6: (_R2, _R2),
             10: (0.0, 1.0), 14: (-_R2, _R2), 7: (_S1, _C1),
             11: (-_R2, _R2), 15: (-_C1, -_S1)}


def _dft4(v: list, slots: tuple, inverse: bool) -> None:
    a, b, c, d = (v[i] for i in slots)
    t0, t1, t2, t3 = a + c, a - c, b + d, b - d
    lo, hi = t1 - 1j * t3, t1 + 1j * t3
    v[slots[0]], v[slots[2]] = t0 + t2, t0 - t2
    v[slots[1]], v[slots[3]] = (hi, lo) if inverse else (lo, hi)


def fft16_mirror(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """The kernel's fft16 on the last axis (length 16, complex): the
    unnormalised DFT, output k in slot REV16[k]."""
    ctype = x.dtype
    rtype = np.float32 if ctype == np.complex64 else np.float64
    v = [x[..., i] for i in range(16)]
    for b in range(4):
        _dft4(v, (b, b + 4, b + 8, b + 12), inverse)
    for slot, (c, s) in _TWIDDLES.items():
        w = rtype(c) + 1j * rtype(s if inverse else -s)
        v[slot] = (v[slot] * ctype.type(w)).astype(ctype)
    for k1 in range(4):
        _dft4(v, (4 * k1, 4 * k1 + 1, 4 * k1 + 2, 4 * k1 + 3), inverse)
    return np.stack(v, axis=-1)


def _rows_forward(x: np.ndarray) -> np.ndarray:
    """Real rows [..., 16, 16] -> half spectra [..., 16, 9], rows 2p and
    2p + 1 through one complex FFT (the kernel's split_pair)."""
    ctype = np.complex64 if x.dtype == np.float32 else np.complex128
    z = fft16_mirror((x[..., 0::2, :] + 1j * x[..., 1::2, :]).astype(ctype))
    out = np.empty(x.shape[:-1] + (9,), ctype)
    half = z.real.dtype.type(0.5)
    for k in range(9):
        p, m = z[..., REV16[k]], z[..., REV16[(16 - k) % 16]]
        out[..., 0::2, k] = half * (p + np.conj(m))
        out[..., 1::2, k] = half * (-1j) * (p - np.conj(m))
    return out


def _rows_inverse(t: np.ndarray) -> np.ndarray:
    """Half spectra [..., 16, 9] -> real rows [..., 16, 16] times 16, two
    rows per complex FFT (the kernel's join_pair: the imaginary parts of DC
    and Nyquist are not read)."""
    a, b = t[..., 0::2, :], t[..., 1::2, :]
    v = np.empty(a.shape[:-1] + (16,), t.dtype)
    for k in (0, 8):
        v[..., k] = a[..., k].real + 1j * b[..., k].real
    for k in range(1, 8):
        v[..., k] = a[..., k] + 1j * b[..., k]
        v[..., 16 - k] = np.conj(a[..., k]) + 1j * np.conj(b[..., k])
    z = fft16_mirror(v, inverse=True)[..., list(REV16)]
    out = np.empty(t.shape[:-1] + (16,), z.real.dtype)
    out[..., 0::2, :], out[..., 1::2, :] = z.real, z.imag
    return out


def _columns(t: np.ndarray, inverse: bool) -> np.ndarray:
    """The 16-point FFT along axis -2 of [..., 16, 9], natural order."""
    z = fft16_mirror(np.swapaxes(t, -1, -2), inverse)[..., list(REV16)]
    return np.swapaxes(z, -1, -2)


def rfft2_16_mirror(x: np.ndarray) -> np.ndarray:
    """np.fft.rfft2 of [..., 16, 16] by the kernel's schedule."""
    return _columns(_rows_forward(x), inverse=False)


def irfft2_16_mirror(spec: np.ndarray) -> np.ndarray:
    """np.fft.irfft2 of [..., 16, 9] by the kernel's schedule."""
    rows = _rows_inverse(_columns(spec, inverse=True))
    return rows * rows.dtype.type(1.0 / 256.0)


def reduce_scatter_mirror(q: np.ndarray) -> np.ndarray:
    """The column stage's sum over channels: q [32 lanes, n floats], n = 32
    (K4: complex products) or 16 (K5: |x^|^2 is real) -> [32], entry l what
    lane l ends with, the total over the lanes of float l % n.  At step
    h = n/2, ..., 2, 1 a lane keeps the half of its values that its bit h
    selects and adds its partner's (lane ^ h) copy; for n = 16 the two
    half-warps then exchange their totals (h = 16)."""
    q = q.copy()
    n = q.shape[1]
    lanes = np.arange(32)
    h = n // 2
    while h:
        up = (lanes & h) != 0
        send = np.where(up[:, None], q[:, :h], q[:, h:2 * h])
        keep = np.where(up[:, None], q[:, h:2 * h], q[:, :h])
        q[:, :h] = keep + send[lanes ^ h]
        h //= 2
    h = n
    while h < 32:
        q[:, 0] = q[:, 0] + q[lanes ^ h, 0]
        h *= 2
    return q[:, 0]


def detect_fft16_mirror(xf: np.ndarray, alphaf: np.ndarray,
                        feat: np.ndarray, sigma: float) -> np.ndarray:
    """K4's S = 16 path in numpy float32, stage by stage: feat [N, C, 16,
    16] against xf [T, C, 16, 9], alphaf [T, 16, 9] (item i, row i % T) ->
    response [N, 16, 16].  z's energy comes from the features, x's from
    the spectrum; the channel sum goes through `reduce_scatter_mirror`."""
    n, c = feat.shape[:2]
    rows = np.arange(n) % xf.shape[0]
    x = xf[rows].astype(np.complex64)
    zf = _columns(_rows_forward(feat.astype(np.float32)), inverse=False)
    prod = zf * np.conj(x)                                 # [N, C, 16, 9]
    lanes = np.zeros((n, 32, 16, 9), np.complex64)
    lanes[:, :c] = prod
    # lane = channel; a warp's 32 floats are one kx column, (ky, re/im)
    q = np.stack([lanes.real, lanes.imag], axis=-1)        # [N,32,16,9,2]
    q = q.transpose(0, 3, 1, 2, 4).reshape(n, 9, 32, 32)
    tot = np.stack([[reduce_scatter_mirror(q[i, kx]) for kx in range(9)]
                    for i in range(n)]).reshape(n, 9, 16, 2)
    cross_f = (tot[..., 0] + 1j * tot[..., 1]).transpose(0, 2, 1)
    fold = np.array([1.0] + [2.0] * 7 + [1.0], np.float32)
    zz = np.sum(feat.astype(np.float32) ** 2, axis=(1, 2, 3))
    xx = np.sum((x.real ** 2 + x.imag ** 2) * fold, axis=(1, 2, 3))
    energies = (zz + xx * np.float32(1.0 / 256.0))[:, None, None]
    cross = irfft2_16_mirror(cross_f.astype(np.complex64))
    denom = np.float32(sigma * sigma * (256 * c))
    k = np.exp(-np.maximum(energies - np.float32(2.0) * cross, 0) / denom)
    kf = rfft2_16_mirror(k.astype(np.float32))
    return irfft2_16_mirror((kf * alphaf[rows]).astype(np.complex64))


def train_fft16_mirror(xf: np.ndarray, alphaf: np.ndarray, feat: np.ndarray,
                       yf: np.ndarray, sigma: float, lambda_: float,
                       lr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K5's S = 16 path in numpy float32, stage by stage: feat [T, C, 16,
    16], the old model xf [T, C, 16, 9] and alphaf [T, 16, 9], yf [16, 9],
    lr [T] -> the new (xf, alphaf).  x's energy comes from the features
    (as the kernel's row stage sums it), the channel sum of |x^|^2 goes
    through `reduce_scatter_mirror` with slot i of a lane holding
    ky = REV16[i], and both blends are old (1 - lr) + new lr on the real
    and imaginary parts."""
    t, c = feat.shape[:2]
    feat = feat.astype(np.float32)
    lr = lr.astype(np.float32)
    keep = np.float32(1.0) - lr

    def blend(old, new, shape):
        k, w = keep.reshape(shape), lr.reshape(shape)
        return ((old.real * k + new.real * w)
                + 1j * (old.imag * k + new.imag * w)).astype(np.complex64)

    xhat = _columns(_rows_forward(feat), inverse=False)    # [T, C, 16, 9]
    new_xf = blend(xf.astype(np.complex64), xhat, (t, 1, 1, 1))
    lanes = np.zeros((t, 32, 16, 9), np.float32)
    lanes[:, :c] = xhat.real ** 2 + xhat.imag ** 2
    # warp = kx, lane = channel, slot i of a lane = ky REV16[i]
    q = lanes[:, :, list(REV16), :].transpose(0, 3, 1, 2)  # [T, 9, 32, 16]
    tot = np.stack([[reduce_scatter_mirror(q[i, kx]) for kx in range(9)]
                    for i in range(t)])                    # [T, 9, 32]
    kxx = np.empty((t, 16, 9), np.float32)
    kxx[:, list(REV16), :] = tot[:, :, :16].transpose(0, 2, 1)
    xx = np.sum(feat ** 2, axis=(1, 2, 3))
    energies = (xx + xx)[:, None, None]
    cross = irfft2_16_mirror(kxx.astype(np.complex64))
    denom = np.float32(sigma * sigma * (256 * c))
    k = np.exp(-np.maximum(energies - np.float32(2.0) * cross, 0) / denom)
    kf = rfft2_16_mirror(k.astype(np.float32))
    dr = kf.real + np.float32(lambda_)
    inv = np.float32(1.0) / np.maximum(dr * dr + kf.imag * kf.imag,
                                       np.float32(1e-20))
    y = yf.astype(np.complex64)
    alpha = ((y.real * dr + y.imag * kf.imag) * inv
             + 1j * ((y.imag * dr - y.real * kf.imag) * inv))
    new_alphaf = blend(alphaf.astype(np.complex64),
                       alpha.astype(np.complex64), (t, 1, 1))
    return new_xf, new_alphaf


# ---- numpy mirror of K6's schedule (csrc/kcf.cu, S = 64) ---------------
#
# K6's 64-point FFT runs on a group of 8 lanes as an 8 x 8 Cooley-Tukey
# schedule: lane j takes x(8 n1 + j), runs an 8-point DFT (two 4-point
# DFTs and the w8 twiddles), multiplies output k1 by w64^(j k1) from
# `_twiddles(64)`, trades through scratch so that lane j takes Y(n2, j),
# runs the second 8-point DFT and ends with X(j + 8 k2).  The functions
# below repeat that schedule, and K6's four passes, in the dtype they are
# given, so the CPU tests can hold them against numpy's FFT and the plain
# chain.

def _dft8(v: list, inverse: bool) -> None:
    """8-point DFT in place on a list of 8 arrays: two 4-point DFTs (evens,
    odds) and the twiddles w8^k of the odd half, as the kernel's fft64."""
    _dft4(v, (0, 2, 4, 6), inverse)
    _dft4(v, (1, 3, 5, 7), inverse)
    r = np.sqrt(0.5)
    sgn = 1.0 if inverse else -1.0
    o1 = v[3] * v[3].dtype.type(complex(r, sgn * r))
    o2 = v[5] * v[5].dtype.type(sgn * 1j)
    o3 = v[7] * v[7].dtype.type(complex(-r, sgn * r))
    v[:] = [v[0] + v[1], v[2] + o1, v[4] + o2, v[6] + o3,
            v[0] - v[1], v[2] - o1, v[4] - o2, v[6] - o3]


def fft64_mirror(x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """K6's fft64 on the last axis (length 64, complex): the unnormalised
    DFT (inverse: e^{+}), in natural order."""
    ctype = x.dtype
    theta = 2.0 * np.pi * np.arange(64, dtype=np.float64) / 64
    tw = (np.cos(theta) - 1j * np.sin(theta)).astype(ctype)  # = _twiddles
    lanes = np.arange(8)
    v = [x[..., 8 * n1:8 * n1 + 8] for n1 in range(8)]   # [..., lane j]
    _dft8(v, inverse)
    for k1 in range(1, 8):
        w = tw[(lanes * k1) % 64]
        v[k1] = (v[k1] * (np.conj(w) if inverse else w)).astype(ctype)
    u = [np.stack([v[k1][..., n2] for k1 in range(8)], axis=-1)
         for n2 in range(8)]                             # lane j: Y(n2, j)
    _dft8(u, inverse)
    return np.concatenate(u, axis=-1)                    # X(j + 8 k2)


def _unpack(z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The two transforms packed as z = A + i B of Hermitian pairs, from
    Z = the transform of z (natural order, last axis): A = (Z + conj
    Z(-n)) / 2, B = (Z - conj Z(-n)) / 2i, the kernel's operations."""
    m = z[..., (-np.arange(z.shape[-1])) % z.shape[-1]]
    half = z.real.dtype.type(0.5)
    a = half * (z.real + m.real) + 1j * (half * (z.imag - m.imag))
    b = half * (z.imag + m.imag) + 1j * (half * (m.real - z.real))
    return a.astype(z.dtype), b.astype(z.dtype)


def train_shift_fused_mirror(xf: np.ndarray, alphaf: np.ndarray,
                             zf: np.ndarray, dy: np.ndarray, dx: np.ndarray,
                             yf: np.ndarray, sigma: float, lambda_: float,
                             lr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K6 in numpy float32, pass by pass: zf and the old xf [T, 1, 64, 33],
    the old alphaf [T, 64, 33], yf [64, 33], dy, dx, lr [T] -> the new (xf,
    alphaf).  The phase shift and blend repeat the plain chain's roundings;
    the cross spectrum is |x^|^2 (real); columns 0 and 32, then (g, g + 16),
    go through one complex column FFT in pairs, column 16 alone; rows 2p
    and 2p + 1 through one; k^ is taken real (k is even)."""
    f32 = np.float32
    t = zf.shape[0]
    z = zf[:, 0].astype(np.complex64)
    lr = lr.astype(f32)
    keep = f32(1.0) - lr
    ky = np.arange(64)
    ky = np.where(ky < 32, ky, ky - 64).astype(f32)[:, None]
    kx = np.arange(33, dtype=f32)
    sy = (dy.astype(f32) * f32(1.0 / 64))[:, None, None]
    sx = (dx.astype(f32) * f32(1.0 / 64))[:, None, None]
    theta = f32(2.0 * np.pi) * (ky * sy + kx * sx)
    c, s = np.cos(theta), np.sin(theta)
    ar = z.real * c - z.imag * s
    ai = z.real * s + z.imag * c

    def blend(old, nr, ni, shape):
        k, w = keep.reshape(shape), lr.reshape(shape)
        return ((old.real * k + nr * w)
                + 1j * (old.imag * k + ni * w)).astype(np.complex64)

    new_xf = blend(xf.astype(np.complex64), ar[:, None], ai[:, None],
                   (t, 1, 1, 1))
    p = ar * ar + ai * ai                                    # [T, 64, 33]
    fold = np.array([1.0] + [2.0] * 31 + [1.0], f32)
    xx = np.sum(p * fold, axis=(1, 2), dtype=f32) * f32(1.0 / 4096)
    energies = (xx + xx)[:, None, None]
    # inverse columns: Q = sum_ky |x^|^2 e^{+}
    cols = p.transpose(0, 2, 1).astype(np.complex64)         # [T, 33, 64]
    q = np.empty((t, 33, 64), np.complex64)
    dc = fft64_mirror(cols[:, 0] + 1j * cols[:, 32], inverse=True)
    q[:, 0], q[:, 32] = dc.real, dc.imag
    q[:, 16] = fft64_mirror(cols[:, 16], inverse=True)
    q[:, 1:16], q[:, 17:32] = _unpack(fft64_mirror(
        (cols[:, 1:16] + 1j * cols[:, 17:32]).astype(np.complex64),
        inverse=True))
    q = q.transpose(0, 2, 1)                                 # [T, 64, 33]
    # rows 2p, 2p + 1: inverse -> Gaussian kernel -> forward
    q1, q2 = q[:, 0::2], q[:, 1::2]
    zr = np.empty((t, 32, 64), np.complex64)
    zr[..., :32] = (q1.real[..., :32] - q2.imag[..., :32]) + 1j * (
        q1.imag[..., :32] + q2.real[..., :32])
    mir = q[..., 32:0:-1]                                    # kx = 32..63
    m1, m2 = mir[:, 0::2], mir[:, 1::2]
    zr[..., 32:] = (m1.real + m2.imag) + 1j * (m2.real - m1.imag)
    cross = fft64_mirror(zr, inverse=True)
    denom = f32(sigma * sigma * 4096)
    inv_n = f32(1.0 / 4096)

    def gauss(v):
        return np.exp(-np.maximum(energies - f32(2.0) * (v * inv_n), 0)
                      / denom).astype(f32)

    k = (gauss(cross.real) + 1j * gauss(cross.imag)).astype(np.complex64)
    ka, kb = _unpack(fft64_mirror(k))
    kr = np.empty((t, 64, 33), np.complex64)
    kr[:, 0::2], kr[:, 1::2] = ka[..., :33], kb[..., :33]
    # forward columns: k^ = Re, Im of the transform of K_a + i K_b
    kc = kr.transpose(0, 2, 1)                               # [T, 33, 64]
    kf = np.empty((t, 33, 64), f32)

    def pair(a, b):
        return fft64_mirror(((a.real - b.imag) + 1j * (a.imag + b.real))
                            .astype(np.complex64))

    both = pair(kc[:, 0], kc[:, 32])
    kf[:, 0], kf[:, 32] = both.real, both.imag
    kf[:, 16] = fft64_mirror(kc[:, 16]).real
    both = pair(kc[:, 1:16], kc[:, 17:32])
    kf[:, 1:16], kf[:, 17:32] = both.real, both.imag
    kf = kf.transpose(0, 2, 1)                               # [T, 64, 33]
    d = kf + f32(lambda_)
    inv = f32(1.0) / np.maximum(d * d, f32(1e-20))
    y = yf.astype(np.complex64)
    new_alphaf = blend(alphaf.astype(np.complex64), y.real * d * inv,
                       y.imag * d * inv, (t, 1, 1))
    return new_xf, new_alphaf


# ---- numpy mirror of K8's schedule (csrc/kcf.cu, S = 64) ---------------
#
# K8 runs its passes on K6's fft64 groups: rows in pairs through one complex
# transform (split with `_unpack`), columns one to a group with the real
# columns 0 and 32 paired, columns 0 and 32 of a product back through one
# inverse as the sum h0 + i h32 of their Hermitian parts.  `search64_mirror` repeats the passes
# and the peak, sub-pixel and PSR rules in numpy float32.

def _rows_to_halves(x: np.ndarray) -> np.ndarray:
    """Real rows [N, 64, 64] -> half spectra [N, 64, 33], rows 2p and 2p + 1
    through one forward transform."""
    a, b = _unpack(fft64_mirror((x[:, 0::2] + 1j * x[:, 1::2])
                                .astype(np.complex64)))
    out = np.empty((x.shape[0], 64, 33), np.complex64)
    out[:, 0::2], out[:, 1::2] = a[..., :33], b[..., :33]
    return out


def _halves_to_rows(h: np.ndarray) -> np.ndarray:
    """Half spectra [N, 64, 33] -> [N, 32, 64] complex, the unnormalised
    inverse of rows 2p (real part) and 2p + 1 (imaginary part), the
    imaginary parts of DC and Nyquist not read."""
    q1, q2 = h[:, 0::2], h[:, 1::2]
    v = np.empty((h.shape[0], 32, 64), np.complex64)
    v[..., :32] = (q1.real[..., :32] - q2.imag[..., :32]) + 1j * (
        q1.imag[..., :32] + q2.real[..., :32])
    m1, m2 = h[:, 0::2, 32:0:-1], h[:, 1::2, 32:0:-1]
    v[..., 32:] = (m1.real + m2.imag) + 1j * (m2.real - m1.imag)
    return fft64_mirror(v, inverse=True)


def _columns_forward(h: np.ndarray) -> np.ndarray:
    """Forward column transforms of row half spectra [N, 64, 33] whose
    columns 0 and 32 are real -> [N, 33, 64] (kx, ky)."""
    c = h.transpose(0, 2, 1)
    out = np.empty(c.shape, np.complex64)
    out[:, 1:32] = fft64_mirror(np.ascontiguousarray(c[:, 1:32]))
    out[:, 0], out[:, 32] = _unpack(fft64_mirror(
        (c[:, 0].real + 1j * c[:, 32].real).astype(np.complex64)))
    return out


def _columns_inverse(c: np.ndarray) -> np.ndarray:
    """Inverse column transforms of [N, 33, 64] (kx, ky) -> [N, 64, 33]
    (y, kx); columns 0 and 32 go through one transform as h0 + i h32, their
    Hermitian parts (c(k) + conj c(-k)) / 2, and come back as the real
    parts of their own inverses (C2R semantics)."""
    out = np.empty(c.shape, np.complex64)
    out[:, 1:32] = fft64_mirror(np.ascontiguousarray(c[:, 1:32]), True)
    neg = (-np.arange(64)) % 64
    half = np.float32(0.5)
    h0, h32 = ((half * (x.real + x.real[..., neg])
                + 1j * (half * (x.imag - x.imag[..., neg])))
               .astype(np.complex64) for x in (c[:, 0], c[:, 32]))
    both = fft64_mirror((h0 + 1j * h32).astype(np.complex64), inverse=True)
    out[:, 0], out[:, 32] = both.real, both.imag
    return out.transpose(0, 2, 1)


def search64_mirror(xf: np.ndarray, alphaf: np.ndarray, feat: np.ndarray,
                    sigma: float) -> tuple:
    """K8 in numpy float32, pass by pass: feat [N, 1, 64, 64] against xf
    [R, 1, 64, 33] and alphaf [R, 64, 33] (item i, row i % R) -> (zf [N, 1,
    64, 33], response [N, 64, 64], dy, dx, peak, idx, psr [N]), the fields
    of `SearchRows`.  z's energy comes from the features, x's from the
    spectrum."""
    f32 = np.float32
    n = feat.shape[0]
    rows = np.arange(n) % xf.shape[0]
    x = xf[rows, 0].astype(np.complex64)
    a = alphaf[rows].astype(np.complex64)
    p = feat[:, 0].astype(f32)
    zz = np.sum(p * p, axis=(1, 2), dtype=f32)
    z = _columns_forward(_rows_to_halves(p))                 # [N, 33, 64]
    zf = z.transpose(0, 2, 1)[:, None].astype(np.complex64)
    xc = x.transpose(0, 2, 1)
    q = _columns_inverse((z * np.conj(xc)).astype(np.complex64))
    fold = np.array([1.0] + [2.0] * 31 + [1.0], f32)
    xx = np.sum((x.real * x.real + x.imag * x.imag) * fold, axis=(1, 2),
                dtype=f32)
    energies = (zz + xx * f32(1.0 / 4096))[:, None, None]
    cross = _halves_to_rows(q)
    denom = f32(sigma * sigma * 4096)
    inv_n = f32(1.0 / 4096)

    def gauss(v):
        return np.exp(-np.maximum(energies - f32(2.0) * (v * inv_n), 0)
                      / denom).astype(f32)

    k = np.empty((n, 64, 64), f32)
    k[:, 0::2], k[:, 1::2] = gauss(cross.real), gauss(cross.imag)
    kf = _columns_forward(_rows_to_halves(k))
    r = _columns_inverse((kf * a.transpose(0, 2, 1)).astype(np.complex64))
    back = _halves_to_rows(r)
    response = np.empty((n, 64, 64), f32)
    response[:, 0::2], response[:, 1::2] = back.real * inv_n, back.imag * inv_n
    flat = response.reshape(n, 4096)
    idx = np.argmax(flat, axis=1)
    at = np.arange(n)
    peak = flat[at, idx]
    py, px = idx // 64, idx % 64

    def subpixel(pos, left, right):
        den = f32(2.0) * peak - left - right
        with np.errstate(divide="ignore", invalid="ignore"):
            d = f32(0.5) * (right - left) / np.maximum(den, f32(1e-8))
        d = np.clip(np.where(np.abs(den) > f32(1e-8), d, f32(0)), -0.5, 0.5)
        return np.where((pos > 0) & (pos < 63), d, f32(0)).astype(f32)

    dy = (py.astype(f32) + subpixel(
        py, flat[at, np.maximum(py - 1, 0) * 64 + px],
        flat[at, np.minimum(py + 1, 63) * 64 + px])) - f32(32)
    dx = (px.astype(f32) + subpixel(
        px, flat[at, py * 64 + np.maximum(px - 1, 0)],
        flat[at, py * 64 + np.minimum(px + 1, 63)])) - f32(32)
    yy, xs = np.divmod(np.arange(4096), 64)
    side = ((np.abs(yy[None] - py[:, None]) > 5)
            | (np.abs(xs[None] - px[:, None]) > 5))
    count = np.maximum(side.sum(axis=1), 1).astype(f32)
    mean = np.where(side, flat, f32(0)).sum(axis=1, dtype=f32) / count
    var = np.where(side, (flat - mean[:, None]) ** 2,
                   f32(0)).sum(axis=1, dtype=f32) / count
    psr = (peak - mean) / np.sqrt(var + f32(1e-8))
    return (zf, response, dy.astype(f32), dx.astype(f32), peak,
            idx.astype(np.int64), psr.astype(f32))
