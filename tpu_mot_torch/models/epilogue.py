"""The inference epilogue of a YOLO ConvBlock: BatchNorm with its running
statistics, leaky ReLU (0.1) and the residual add, over the float32 NCHW
conv output y,

    out = [skip +] leaky(((y - mean[c]) * mul[c]) + bias[c], 0.1)

with mul = rsqrt(var + eps) * weight from the block's own expression.

  fused         K7 (csrc/epilogue.cu) for CUDA tensors, in place into y:
                one read of y (and skip) and one write, bit for bit the
                chain's result; the plain version for CPU tensors;
  epilogue_ref  the plain version: the chain of PyTorch operations the block
                ran before K7 (and runs where `takes` says no);
  mirror        K7's per-element arithmetic in NumPy (float32, each
                operation rounded on its own), for the CPU tests.

`models/yolo.ConvBlock` routes by the input, with no option: a block with
BatchNorm and the activation, in eval mode, whose conv output `takes`
accepts, runs K7; every other block (the CPU, train mode, bfloat16, a
float64 net, a tensor that needs a gradient) runs the chain.

The launch lives in this module, not in kernels/ or models/yolo, because a
traced run credits each device operation to the innermost program module
open at its launch: K7's time is the detector's and not a convolution's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_mot_torch.kernels import _build

# K7 launches, and BatchNorm blocks that ran the chain instead (counted by
# models/yolo.ConvBlock): plain counts, read by tests and chip_smoke.py; a
# YOLOv3 forward on the card is 72 launches and 0 chain blocks.
launches = 0
chain_blocks = 0

SLOPE = 0.1
# csrc/epilogue.cu's schedule: a warp per work item of LANES x PER_LANE
# units, a unit 4 elements (float4) on the vector path, else 1; WARPS
# items a CTA.
LANES, PER_LANE, WARPS = 32, 8, 8
_MAX_HW = 2**31 - 1 - 4 * LANES * PER_LANE
_MAX_CTAS = 2**31 - 1


def epilogue_ref(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                 bias: torch.Tensor, skip: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """Plain version of `fused`: ConvBlock's chain for float32 y, into new
    tensors."""
    c = (slice(None), None, None)
    out = F.leaky_relu((y - mean[c]) * mul[c] + bias[c], SLOPE)
    return out if skip is None else skip + out


def takes(y: torch.Tensor, skip: torch.Tensor | None = None) -> bool:
    """Whether K7 computes the epilogue of y (and skip): contiguous float32
    CUDA tensors of one shape that need no gradient."""
    return all(t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()
               and not t.requires_grad and t.shape == y.shape
               and t.device == y.device
               for t in ((y,) if skip is None else (y, skip)))


def vector_path(y: torch.Tensor, skip: torch.Tensor | None = None) -> bool:
    """Whether K7 takes y in float4 units: H*W a multiple of 4 and y and
    skip 16-byte aligned."""
    return (y.shape[-1] * y.shape[-2] % 4 == 0 and y.data_ptr() % 16 == 0
            and (skip is None or skip.data_ptr() % 16 == 0))


def fused(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
          bias: torch.Tensor, skip: torch.Tensor | None = None
          ) -> torch.Tensor:
    """[skip +] leaky(((y - mean) * mul) + bias) per channel of y [N, C, H,
    W].  K7 for CUDA tensors, written into y and returned (y, skip: as
    `takes` accepts; mean, mul, bias: [C] float32, contiguous, on y's
    card); the plain version for CPU tensors."""
    global launches
    what = "epilogue"
    if not _build.on_card(what, y):
        return epilogue_ref(y, mean, mul, bias, skip)
    if y.dim() != 4 or not takes(y, skip):
        raise ValueError(f"{what}: y and skip must be contiguous float32 "
                         "NCHW tensors of one shape on the card that need "
                         "no gradient")
    n, ch, h, w = y.shape
    for name, v in (("mean", mean), ("mul", mul), ("bias", bias)):
        if (v.shape != (ch,) or v.dtype != torch.float32
                or v.device != y.device or not v.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"[{ch}] tensor on {y.device}")
    vector = vector_path(y, skip)
    items = n * ch * -(-h * w // (LANES * PER_LANE * (4 if vector else 1)))
    if h * w > _MAX_HW or -(-items // WARPS) > _MAX_CTAS:
        raise ValueError(f"{what}: {tuple(y.shape)} is past the kernel's "
                         "32-bit plane offsets or grid")
    if y.numel() == 0:
        return y
    lib = _build.load()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.tpu_mot_epilogue(
            y.data_ptr(), None if skip is None else skip.data_ptr(),
            mean.data_ptr(), mul.data_ptr(), bias.data_ptr(), n * ch, ch,
            h * w, int(vector), stream)
    _build.check(rc, what)
    launches += 1
    return y


def mirror(y: np.ndarray, mean: np.ndarray, mul: np.ndarray,
           bias: np.ndarray, skip: np.ndarray | None = None) -> np.ndarray:
    """K7's arithmetic on each element of y [N, C, H, W] in NumPy float32,
    into a new array: t = ((y - mean) * mul) + bias, t > 0 ? t : t * 0.1,
    then skip + t."""
    f32 = np.float32
    c = (slice(None), None, None)
    mean, mul, bias = (np.asarray(v, f32)[c] for v in (mean, mul, bias))
    with np.errstate(all="ignore"):         # inf and NaN as the card makes
        t = (np.asarray(y, f32) - mean) * mul + bias
        t = np.where(t > 0, t, t * f32(SLOPE))
        return t if skip is None else np.asarray(skip, f32) + t
