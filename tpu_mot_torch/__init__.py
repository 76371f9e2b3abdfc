"""tpu-mot on PyTorch and CUDA: the tracker of `tpu_mot`, ported.

The package mirrors `tpu_mot`'s module names (`ops/`, `kernels/`,
`tracker/`, `config`, `data/`, `utils/`) so each function has an obvious
counterpart.  It imports `torch` and nothing of `jax` or of `tpu_mot`: the
JAX-free modules it needs (`config`, `data.synthetic`, the CLEAR-MOT and
HOTA metrics) are its own copies.

What runs today is the tracker step through `tracker.scan.run_sequence`
and `tracker.api.MultiTracker`: the default configuration (gray 64x64
features, unit scale, detect-site training, PSR gate, IoU-only cost) and
the heavy one (fHOG-31 features over 4x4 cells, the 3-scale search, and
optionally the fused KCF kernels with refined-site training).  The five
kernels are hand-written CUDA for Hopper (`csrc/roi.cu`, `csrc/auction.cu`,
`csrc/kcf.cu`), built with nvcc at first use; every other op is plain
torch.  Entry points run on the card unless the caller passes
device="cpu".

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
