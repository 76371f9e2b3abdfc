"""The ConvBlock epilogue (tpu_mot_torch.models.epilogue) on the CPU: its
plain version and the NumPy mirror of K7 against the chain that
`models/yolo.ConvBlock` runs in eval mode, the route that keeps the
chain wherever K7 does not apply, and chip_smoke.py's counts and checks of
K7's calls.  K7 itself runs only on a CUDA card (tests/test_torch_cuda.py).

Every comparison is bit for bit (the float32 words, so NaN too): K7 runs
the chain's operations in its order, each rounded on its own, and so do the
mirror and the plain version.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from tpu_mot_torch import interop
from tpu_mot_torch.models import epilogue
from tpu_mot_torch.models import yolo as t_yolo

torch.set_num_threads(1)

# (N, C, H, W): odd planes (19 x 19 = 361, 13 x 13 = 169, 1 x 1), C = 1, 3
# and 255, planes of several work items on both paths (48 x 48), a plane
# that is a multiple of 4 but not of the vector tile (40 x 33 = 1320).
SHAPES = [(2, 3, 19, 19), (1, 255, 13, 13), (3, 1, 1, 1), (2, 1, 48, 48),
          (2, 3, 40, 33), (1, 255, 2, 2)]


def bits(t) -> np.ndarray:
    return np.asarray(t, np.float32).view(np.int32)


def inputs(shape, seed, skip):
    """y with negatives, +-0, values near float32's largest and NaN; the
    channel parameters as a block computes them, mul from rsqrt(var + eps)
    * weight; skip or None."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    y = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = y.reshape(-1)
    k = rng.permutation(flat.size)[:min(flat.size, 12)]
    flat[k] = np.array([0.0, -0.0, 3e38, -3e38, np.nan, 0.0, -0.0, 1e-40,
                        -1e-40, np.inf, -np.inf, np.nan],
                       np.float32)[:k.size]
    mean = rng.standard_normal(c).astype(np.float32)
    mean[0] = -0.0
    var = rng.random(c).astype(np.float32)
    mul = torch.rsqrt(torch.as_tensor(var) + 1e-5) * torch.as_tensor(
        rng.standard_normal(c).astype(np.float32))
    bias = rng.standard_normal(c).astype(np.float32)
    s = (rng.standard_normal(shape) * 2).astype(np.float32) if skip else None
    return y, mean, mul.numpy(), bias, s


def chain(y, mean, mul, bias, skip):
    """ConvBlock's eval chain and YoloV3's shortcut as the nets ran them
    before K7: (y - mean) * mul + bias, leaky ReLU 0.1, x + block(y)."""
    y, mean, mul, bias = map(torch.as_tensor, (y, mean, mul, bias))
    c = (slice(None), None, None)
    out = F.leaky_relu((y - mean[c]) * mul[c] + bias[c], 0.1)
    return out if skip is None else torch.as_tensor(skip) + out


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "skip"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ref_and_mirror_equal_the_chain(shape, skip):
    y, mean, mul, bias, s = inputs(shape, sum(shape), skip)
    want = bits(chain(y, mean, mul, bias, s))
    got = epilogue.epilogue_ref(*map(torch.as_tensor, (y, mean, mul, bias)),
                                None if s is None else torch.as_tensor(s))
    assert np.array_equal(bits(got), want)
    assert np.array_equal(bits(epilogue.mirror(y, mean, mul, bias, s)),
                          want)


def block(cin=4, cout=5, seed=0, **kw):
    """A ConvBlock with seeded weights and running statistics, eval mode."""
    blk = t_yolo.ConvBlock(cin, cout, **kw)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in (blk.conv.weight, blk.bn.weight, blk.bn.bias,
                  blk.bn.running_mean):
            t.copy_(torch.randn(t.shape, generator=g))
        blk.bn.running_var.copy_(torch.rand(cout, generator=g) + 0.1)
    return blk.eval()


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "skip"])
def test_block_is_its_conv_then_the_plain_version(skip):
    blk = block()
    x = torch.randn(2, 4, 9, 7, generator=torch.Generator().manual_seed(1))
    r = torch.randn(2, 5, 9, 7) if skip else None
    before = (epilogue.launches, epilogue.chain_blocks)
    with torch.no_grad():
        got = blk(x, skip=r)
        bn = blk.bn
        want = epilogue.epilogue_ref(
            F.conv2d(x, blk.conv.weight, None, 1, 1), bn.running_mean,
            torch.rsqrt(bn.running_var + bn.eps) * bn.weight, bn.bias, r)
    assert np.array_equal(bits(got), bits(want))
    assert (epilogue.launches, epilogue.chain_blocks) == (before[0],
                                                          before[1] + 1)
    if skip:
        with torch.no_grad():
            assert np.array_equal(bits(got), bits(r + blk(x)))


def test_wrapper_on_the_cpu_is_the_plain_version():
    y, mean, mul, bias, s = map(
        lambda a: None if a is None else torch.as_tensor(a),
        inputs((2, 3, 5, 5), 3, True))
    y0 = y.clone()
    before = epilogue.launches
    got = epilogue.fused(y, mean, mul, bias, s)
    assert np.array_equal(bits(got),
                          bits(epilogue.epilogue_ref(y0, mean, mul, bias, s)))
    assert torch.equal(y.view(torch.int32), y0.view(torch.int32))
    assert epilogue.launches == before


@pytest.mark.parametrize("case", ["cpu", "train", "bfloat16", "float64",
                                  "non_contiguous", "requires_grad"])
def test_route_keeps_the_chain(case):
    """Each input K7 does not take runs the chain: `takes` says no, and
    the block counts a chain block and launches nothing.  (On the card,
    tests/test_torch_cuda.py holds the same cases, where only the named
    condition fails.)"""
    dtype = {"bfloat16": "bfloat16"}.get(case, "float32")
    blk = block(dtype=dtype)
    if case == "float64":
        blk = blk.double()
    x = torch.randn(2, 4, 6, 6, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64 if case == "float64" else None)
    if case == "non_contiguous":
        x = x.contiguous(memory_format=torch.channels_last)
    if case == "train":
        blk.train()
    before = (epilogue.launches, epilogue.chain_blocks)
    with torch.set_grad_enabled(case == "requires_grad"):
        out = blk(x)
    assert (epilogue.launches, epilogue.chain_blocks) == (before[0],
                                                          before[1] + 1)
    assert out.requires_grad == (case == "requires_grad")
    assert not epilogue.takes(out)
    if case == "non_contiguous":
        assert not out.is_contiguous()


@pytest.mark.parametrize("name,bn_blocks", [("yolov3", 72),
                                            ("yolov3-tiny", 11),
                                            ("yolov2", 22),
                                            ("yolov2-tiny", 8)])
def test_cpu_forward_runs_the_chain_in_every_batchnorm_block(name,
                                                             bn_blocks):
    spec = t_yolo.YoloSpec(name, num_classes=3, input_size=64)
    model = t_yolo.build_model(spec)
    model.load_state_dict(interop.yolo_params_from_jax(
        interop.numpy_yolo_params(spec, 0)))
    before = (epilogue.launches, epilogue.chain_blocks)
    with torch.no_grad():
        model(torch.rand(1, 1, 64, 64))
    assert (epilogue.launches - before[0],
            epilogue.chain_blocks - before[1]) == (0, bn_blocks)
    # chip_smoke.py expects that many K7 launches of a forward on the card
    assert chip_smoke.bn_blocks(spec) == bn_blocks


@pytest.mark.parametrize("fault", [False, True], ids=["faithful", "fault"])
@pytest.mark.parametrize("skip", [False, True], ids=["plain", "skip"])
def test_smoke_holds_each_epilogue_call_to_the_plain_version(monkeypatch,
                                                             skip, fault):
    """chip_smoke.kernels_checked as its detector phases use it: each call
    of the K7 wrapper is filed at its shape and held word for word against
    the plain version on its own inputs (0, or inf where a word differs),
    its result is the wrapper's, and the wrapper is restored after.  On the
    CPU the wrapper computes the plain version; a wrapper that flips one
    bit stands in for a faulty kernel."""
    shape = (2, 3, 19, 19)
    y, mean, mul, bias, s = (None if a is None else torch.as_tensor(a)
                             for a in inputs(shape, 5, skip))
    fused = epilogue.fused
    if fault:
        def flipped(*args):
            out = fused(*args)
            out.view(-1).view(torch.int32)[7] ^= 1
            return out
        monkeypatch.setattr(epilogue, "fused", flipped)
    wrapper = epilogue.fused
    with chip_smoke.kernels_checked() as st:
        got = epilogue.fused(y, mean, mul, bias, s)
    assert epilogue.fused is wrapper
    assert st.by_kernel() == {"epilogue": [math.inf if fault else 0]}
    assert st.calls == {("epilogue", (*shape, skip)): 1}
    want = epilogue.epilogue_ref(y, mean, mul, bias, s)
    assert np.array_equal(bits(got) != bits(want),
                          np.arange(got.numel()).reshape(shape) == 7
                          if fault else np.zeros(shape, bool))
