"""Fused KCF detect and train: the CUDA kernels K4 and K5 (csrc/kcf.cu) and
their plain torch versions (counterpart of tpu_mot/kernels/kcf.py).

  detect_fused : feat [N, C, S, S] against a model bank of T rows (N a
                 multiple of T; item i reads model row i % T, the
                 scale-major [K*T] layout of the 3-scale search) ->
                 response [N, S, S]                     (eqs. 31, 22)
  train_fused  : feat [T, C, S, S] -> x^, k^xx, alpha^ = y^/(k^+lambda),
                 blended into the bank with a per-track lr  (eq. 17)

The plain versions are the torch.fft chain of ops/kcf.py: `detect` on the
tiled model, and `blend(model, train(feat), lr)`.  The wrappers launch the
kernel for CUDA tensors and run the plain version for CPU tensors, as the
JAX package runs its Pallas kernels in interpret mode on the CPU; for a
CUDA tensor they launch or raise, never fall back.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_mot_torch.kernels import _build
from tpu_mot_torch.ops import kcf as kcf_ops

MAX_S = 64          # direct row/column DFTs: S <= 64
# K4's and K5's code paths (csrc/kcf.cu: `kcf_detect_kernel` /
# `kcf_detect_fft16_kernel`, `kcf_train_kernel` / `kcf_train_fft16_kernel`):
# chosen by the shape alone, given 16-byte aligned features, response and
# model (any tensor torch allocates).
PATHS = ("direct DFTs", "FFTs in registers (S = 16, C <= 32)")

# Kernel launches made by `detect_fused` (K4) and `train_fused` (K5):
# plain counts; reset them to 0 to measure a run.
launches_detect = 0
launches_train = 0


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
