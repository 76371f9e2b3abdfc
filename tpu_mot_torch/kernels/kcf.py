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


def _check_shape(what: str, lib, c: int, s: int) -> None:
    if not 2 <= s <= MAX_S:
        raise ValueError(f"{what}: feature size S={s} outside 2..{MAX_S} "
                         "(the kernel's DFTs are direct sums)")
    need = lib.tpu_mot_kcf_smem_bytes(c, s)
    limit = lib.tpu_mot_kcf_smem_limit()
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
    lib = _build.load()
    _check_shape(what, lib, c, s)
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
    lib = _build.load()
    _check_shape(what, lib, c, s)
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
