"""tpu-mot on PyTorch and CUDA: the tracker of `tpu_mot`, ported.

Public surface (the reference's init/update API and its configuration),
the same names as `tpu_mot`'s:

>>> from tpu_mot_torch import MultiTracker, TrackerConfig
>>> mt = MultiTracker(TrackerConfig())      # on the card; device="cpu" here
>>> mt.init(frame0, dets0)
>>> tracks = mt.update(frame1, dets1)

The exports load on attribute access, so `import tpu_mot_torch` imports
torch and none of the package's modules.

The package mirrors `tpu_mot`'s module names (`ops/`, `kernels/`,
`tracker/`, `models/`, `parallel/`, `config`, `data/`, `utils/`, `native/`,
`cli`) so each function has an obvious counterpart, and `tools/` holds the
twins of the repo's measuring scripts (`python -m
tpu_mot_torch.tools.bench`, `bench_e2e`, `bench_variants`,
`bench_latency`).  It imports `torch` and nothing of `jax` or of
`tpu_mot`: the JAX-free modules it needs (`config`, `data.synthetic`, the
CLEAR-MOT and HOTA metrics, ...) are its own copies.  The five TPU kernels
are hand-written CUDA for Hopper (`csrc/roi.cu`, `csrc/auction.cu`,
`csrc/kcf.cu`), built with nvcc at first use; every other op is plain
torch (the detector's convolutions cuDNN).  Entry points run on the card
unless the caller passes device="cpu".

Precision policy: fp32 everywhere, TF32 off.  bf16 forward spectra
collapsed the bounce fixture's IDF1 from 0.987 to ~0.70 on the TPU
(tpu_mot/ops/fft.py), and a reduced-precision Kalman adds a multi-pixel
quantum at 1080p coordinates, so neither matmuls nor convolutions may
silently drop to TF32 here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

_EXPORTS = {
    "MultiTracker": ("tpu_mot_torch.tracker.api", "MultiTracker"),
    "KCFTracker": ("tpu_mot_torch.tracker.kcf_bank", "KCFTracker"),
    "YoloDetector": ("tpu_mot_torch.models.detector", "YoloDetector"),
    "TrackerConfig": ("tpu_mot_torch.config", "TrackerConfig"),
    "KCFConfig": ("tpu_mot_torch.config", "KCFConfig"),
    "KalmanConfig": ("tpu_mot_torch.config", "KalmanConfig"),
    "YoloSpec": ("tpu_mot_torch.models.yolo", "YoloSpec"),
    "dets_with_classes": ("tpu_mot_torch.models.detector",
                          "dets_with_classes"),
}

__all__ = list(_EXPORTS) + ["__version__"]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'tpu_mot_torch' has no attribute {name!r}")
