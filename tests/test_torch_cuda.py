"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and nvcc (marker `cuda`); elsewhere the
`cuda` fixture skips them with a reason.  The file
imports neither jax nor the JAX package's JAX modules, so it also runs on
a machine without JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: ROI patches (K1, K3) 1e-5 absolute (the kernel's 4-tap form
and the plain version's hat-weight matmuls sum the same two nonzero
products per axis in another order); auction col_of and iters exactly
equal (sums and differences only); fused KCF (K4, K5) against the
torch.fft chain, relative to the largest magnitude of each tensor: 1e-4
for the response and xf, 1e-3 for alphaf (the divide by k^ + lambda
amplifies float32 error where k^ is small); K6 likewise 1e-6 for xf (its
phase shift and blend repeat the chain's roundings one by one) and 1e-4
for alphaf (its own 64-point FFTs against cuFFT's, amplified as for K5);
the tracker on the card
against the tracker on the CPU: ids and valid exact, boxes 1e-3 (cuFFT
and the kernels' own transforms against pocketfft); the detector's heads
on the card against the CPU's within 1e-4 of the largest |head| (cuDNN
with TF32 off against oneDNN), and NMS on the card equal index for index
to NMS on the CPU fed the card's own candidates; the ConvBlock epilogue
(K7) bit for bit the chain it replaces, and the nets' heads bit for bit
the chain's.
"""

import numpy as np
import pytest
import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.config import KCFConfig
from tpu_mot_torch.kernels import auction as t_auction
from tpu_mot_torch.kernels import kcf as t_kcfk
from tpu_mot_torch.kernels import roi as t_roi
from tpu_mot_torch.models import detector as t_det
from tpu_mot_torch.models import epilogue as t_epi
from tpu_mot_torch.models import yolo as t_yolo
from tpu_mot_torch.ops import assignment as t_assign
from tpu_mot_torch.ops import iou as t_iou
from tpu_mot_torch.ops import kcf as t_kcf
from tpu_mot_torch.ops import nms as t_nms
from tpu_mot_torch.parallel import serve as t_serve
from tpu_mot_torch.tracker import api as t_api
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import kcf_bank as t_kcf_bank
from tpu_mot_torch.tracker import scan as t_scan
from tpu_mot_torch.tracker import step as t_step

pytestmark = pytest.mark.cuda

H, W = 1160, 2100           # level 3 (145 x 263) exceeds the 144 x 256 block
BOXES = np.array([
    [0.0, 0.0, 20.0, 20.0], [W - 1.0, H - 1.0, 30.0, 18.0],
    [500.0, 400.0, 0.0, 0.0], [700.0, 300.0, -4.0, 12.0],
    [5000.0, -300.0, 20.0, 20.0], [300.0, 200.0, 51.2, 10.0],
    [310.0, 210.0, 51.21, 10.0], [900.0, 500.0, 102.4, 60.0],
    [1200.0, 700.0, 30.0, 204.8], [1000.0, 580.0, 600.0, 600.0],
    [1050.0, 580.0, 1000.0, 100.0], [123.4, 567.8, 37.5, 25.25],
], np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("pyramid", [torch.uint8, torch.float32])
def test_roi_kernel_matches_plain_version(cuda, pyramid):
    frame = torch.as_tensor(np.random.default_rng(4).integers(
        0, 256, (H, W), dtype=np.uint8), device=cuda)
    if pyramid == torch.float32:
        frame = frame.float() / 255.0
    levels = t_roi.build_pyramid(frame)
    assert levels[0].dtype == pyramid
    boxes = torch.as_tensor(BOXES, device=cuda)
    before = t_roi.launches
    got = t_roi.extract_patches(None, boxes, 2.5, 64, levels=levels,
                                frame_hw=(H, W))
    want = t_roi.extract_patches_ref(None, boxes, 2.5, 64, levels=levels,
                                     frame_hw=(H, W))
    torch.cuda.synchronize()
    assert t_roi.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5


def test_roi_wrapper_rejects_bad_levels(cuda):
    frame = torch.zeros((64, 96), dtype=torch.uint8, device=cuda)
    levels = t_roi.build_pyramid(frame)
    boxes = torch.as_tensor(BOXES[:2] * 0.05, device=cuda)
    with pytest.raises(ValueError, match="level 1"):
        t_roi.extract_patches(None, boxes, 2.5, 16,
                              levels=[levels[0], levels[1][:, :5].clone(),
                                      levels[2], levels[3]],
                              frame_hw=(64, 96))


def _mot_benefits(rng, dev):
    tracks = rng.uniform(50, 1800, (128, 4)).astype(np.float32)
    tracks[:, 1] = rng.uniform(50, 1000, 128)
    tracks[:, 2:] = rng.uniform(24, 64, (128, 2))
    dets = np.concatenate([tracks[:100] + rng.normal(0, 3, (100, 4)),
                           rng.uniform(50, 1000, (60, 4))]).astype(np.float32)
    cost = t_iou.association_cost(
        torch.as_tensor(tracks, device=dev), torch.as_tensor(dets, device=dev),
        torch.ones(128, dtype=torch.bool, device=dev),
        torch.ones(160, dtype=torch.bool, device=dev), 0.1, 1e4)
    return t_assign.build_benefits(cost, cost < 1e3, t_assign.DEFAULT_EPS)


def _quantised_benefits(rng, n, dev):
    """Benefits on a grid of 0.25: many rows place equal bids on one
    column."""
    cost = np.round(rng.uniform(0, 1, (n, n)) * 4) / 4
    b = t_assign.build_benefits(
        torch.as_tensor(cost.astype(np.float32), device=dev),
        torch.as_tensor(rng.random((n, n)) < 0.8, device=dev),
        t_assign.DEFAULT_EPS)
    return torch.round(b * 4) / 4


def _contested_benefits(rng, n, dev):
    """Every row prefers the same few columns (a column's cost plus a
    little noise): a price war of hundreds of rounds."""
    pref = rng.uniform(0, 1, n)
    cost = pref[None, :] + 0.05 * rng.uniform(0, 1, (n, n))
    return t_assign.build_benefits(
        torch.as_tensor(cost.astype(np.float32), device=dev),
        torch.as_tensor(rng.random((n, n)) < 0.9, device=dev),
        t_assign.DEFAULT_EPS)


def _random_benefits(rng, n, dev):
    cost = torch.as_tensor(rng.uniform(0, 1, (n, n)).astype(np.float32),
                           device=dev)
    feas = torch.as_tensor(rng.random((n, n)) < 0.8, device=dev)
    return t_assign.build_benefits(cost, feas, t_assign.DEFAULT_EPS)


# n7, n33, n159: rows that are no multiple of 16 bytes (scalar staging,
# padded rows); nshared: the largest matrix staged into shared memory
# (237); n238 up: rows read from global memory (float4 where n % 4 == 0,
# scalar loads at 238 and 257), nmax: the largest n (1024); ties*: equal
# bids; contested*: a price war; n159 needs over 50 rounds (131 on the
# CPU).
@pytest.mark.parametrize("case", ["mot", "n1", "n8", "n40", "n160",
                                  "capped", "n7", "n33", "n159", "nshared",
                                  "nmax", "ties40", "ties160", "ties159",
                                  "n238", "n240", "n256", "n257", "n512",
                                  "ties256", "ties257", "contested238",
                                  "contested256", "contested257",
                                  "contested512", "capped256"])
def test_auction_kernel_matches_plain_version(cuda, case):
    rng = np.random.default_rng(7)
    max_iters = 3 if case.startswith("capped") else 2000
    if case in ("mot", "capped"):
        b = _mot_benefits(rng, cuda)
    elif case.startswith("ties"):
        b = _quantised_benefits(rng, int(case[4:]), cuda)
    elif case.startswith("contested"):
        b = _contested_benefits(rng, int(case[9:]), cuda)
    else:
        n = {"nmax": t_auction.max_n(), "nshared": t_auction.shared_max_n(),
             "capped256": 256}.get(case) or int(case[1:])
        b = _random_benefits(rng, n, cuda)
    before = t_auction.launches
    col, it = t_auction.auction_solve(b, t_assign.DEFAULT_EPS, max_iters)
    want_col, want_it = t_auction.auction_solve_ref(b, t_assign.DEFAULT_EPS,
                                                    max_iters)
    torch.cuda.synchronize()
    assert t_auction.launches == before + 1
    assert torch.equal(col, want_col) and int(it) == int(want_it)
    assert case.startswith("capped") == bool((col < 0).any())
    if case in ("n159", "contested256"):
        assert int(it) >= 50


@pytest.mark.parametrize("n,path", [(160, 1), (159, 0), (237, 0), (238, 2),
                                    (240, 3), (256, 3), (257, 2), (1024, 3)])
def test_auction_path_by_size(cuda, n, path):
    """Up to shared_max_n() columns the matrix is staged into shared memory;
    above it the rows are read from global memory (float4 for n % 4 == 0),
    with under 21 KB of shared memory for the state."""
    assert t_auction.shared_max_n() == 237
    info = t_auction.launch_info(n)
    assert info["path"] == t_auction.PATHS[path]
    if path >= 2:
        assert info["smem_bytes"] < 21 * 1024


def test_auction_kernel_takes_an_unaligned_matrix(cuda):
    """A contiguous matrix 4 bytes off a 16-byte boundary cannot be bulk
    copied; the kernel stages it by scalar loads instead."""
    rng = np.random.default_rng(9)
    flat = torch.zeros(160 * 160 + 1, device=cuda)
    b = flat[1:].view(160, 160)
    b.copy_(_mot_benefits(rng, cuda))
    assert b.is_contiguous() and b.data_ptr() % 16 == 4
    col, it = t_auction.auction_solve(b, t_assign.DEFAULT_EPS, 2000)
    want_col, want_it = t_auction.auction_solve_ref(b, t_assign.DEFAULT_EPS,
                                                    2000)
    assert torch.equal(col, want_col) and int(it) == int(want_it)


def test_auction_kernel_reads_an_unaligned_matrix_from_global_memory(cuda):
    """n = 256 at a base 4 bytes off a 16-byte boundary: the global path
    reads its rows by scalar loads instead of float4."""
    rng = np.random.default_rng(10)
    flat = torch.zeros(256 * 256 + 1, device=cuda)
    b = flat[1:].view(256, 256)
    b.copy_(_contested_benefits(rng, 256, cuda))
    assert b.is_contiguous() and b.data_ptr() % 16 == 4
    col, it = t_auction.auction_solve(b, t_assign.DEFAULT_EPS, 2000)
    want_col, want_it = t_auction.auction_solve_ref(b, t_assign.DEFAULT_EPS,
                                                    2000)
    assert torch.equal(col, want_col) and int(it) == int(want_it)


def test_auction_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    n_max = t_auction.max_n()
    assert n_max == 1024
    with pytest.raises(ValueError, match="1..1024"):
        t_auction.auction_solve(torch.zeros((1025, 1025), device=cuda),
                                0.02, 10)
    for bad in (torch.zeros((n_max + 1, n_max + 1), device=cuda),
                torch.zeros((2, n_max + 1, n_max + 1), device=cuda),
                torch.zeros((8, 8), dtype=torch.float64, device=cuda),
                torch.zeros((8, 9), device=cuda),
                torch.zeros((8, 16), device=cuda)[:, ::2]):
        with pytest.raises(ValueError):
            t_auction.auction_solve(bad, 0.02, 10)


def test_tracker_on_card_matches_cpu(cuda):
    """roi_impl/assign_impl "pallas" on the CPU runs the kernels' plain
    versions; "auto" on the card runs the kernels."""
    h, w = 240, 320
    rng = np.random.default_rng(5)
    objs = synthetic.make_objects(8, h, w, rng, max_speed=2.0)
    frames, boxes, vis = synthetic.render_sequence(objs, 8, h, w, seed=5)
    dets = synthetic.detections_from_gt(boxes, vis, seed=5, frame_hw=(h, w))
    frames_u8 = torch.as_tensor((frames * 255).astype(np.uint8))
    d = np.zeros((8, 16, 5), np.float32)
    v = np.zeros((8, 16), bool)
    for f in range(8):
        d[f], v[f] = t_api.pad_detections(dets[f], 16)
    d, v = torch.as_tensor(d), torch.as_tensor(v)
    cfg = TrackerConfig(max_tracks=32, max_detections=16, frame_height=h,
                        frame_width=w)
    cpu_cfg = cfg.replace(roi_impl="pallas", assign_impl="pallas")
    _, want = t_scan.run_sequence(t_bank.empty_bank(cpu_cfg, device="cpu"),
                                  frames_u8, d, v, cpu_cfg)
    roi0, auc0 = t_roi.launches, t_auction.launches
    k6 = t_kcfk.launches_train_shift
    _, got = t_scan.run_sequence(t_bank.empty_bank(cfg, device=cuda),
                                 frames_u8.to(cuda), d.to(cuda), v.to(cuda),
                                 cfg)
    torch.cuda.synchronize()
    assert (t_roi.launches - roi0, t_auction.launches - auc0) == (8, 8)
    # stage 8 (gray S = 64, detect-site training) is one K6 launch a frame
    assert t_kcfk.launches_train_shift - k6 == 8
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert (got.boxes.cpu() - want.boxes).abs().max().item() <= 1e-3


SCALES = (1 / 1.05, 1.0, 1.05)


def _scales_boxes(t):
    """t boxes: the edge cases, the straddling box (2.5 * 50 = 125 px at
    unit scale, 131 px at 1.05), then seeded boxes of 8-400 px."""
    rng = np.random.default_rng(t)
    rand = np.stack([rng.uniform(0, W, t), rng.uniform(0, H, t),
                     rng.uniform(8, 400, t), rng.uniform(8, 400, t)], axis=1)
    return np.concatenate([[[300.0, 240.0, 50.0, 50.0]], BOXES,
                           rand])[:t].astype(np.float32)


# S = 64 has its size compiled in; 48 reads it at run time; 30 is no
# multiple of 4 (coordinates read and outputs written one by one).
@pytest.mark.parametrize("s", [64, 48, 30])
@pytest.mark.parametrize("scales", [SCALES, (1.0,)])
@pytest.mark.parametrize("t", [1, 37, 128])
@pytest.mark.parametrize("pyramid", [torch.uint8, torch.float32])
def test_roi_scales_kernel_matches_plain_version(cuda, pyramid, t, scales,
                                                 s):
    frame = torch.as_tensor(np.random.default_rng(8).integers(
        0, 256, (H, W), dtype=np.uint8), device=cuda)
    if pyramid == torch.float32:
        frame = frame.float() / 255.0
    levels = t_roi.build_pyramid(frame)
    boxes = torch.as_tensor(_scales_boxes(t), device=cuda)
    info = t_roi.scales_launch_info(pyramid == torch.uint8, s)
    assert info["path"] == t_roi.SCALES_PATHS[s == 64]
    before = t_roi.launches_scales
    got = t_roi.extract_patches_scales(None, boxes, 2.5, s, scales,
                                       levels=levels, frame_hw=(H, W))
    want = t_roi.extract_patches_scales_ref(None, boxes, 2.5, s, scales,
                                            levels=levels, frame_hw=(H, W))
    torch.cuda.synchronize()
    assert t_roi.launches_scales == before + 1
    assert got.shape == (len(scales), t, s, s)
    assert (got - want).abs().max().item() <= 1e-5
    # The kernel's arithmetic is the mirror's, operation for operation.
    mirror = t_roi.four_tap_mirror(levels, (H, W), *t_roi.sample_coords_scales(
        boxes, 2.5, s, scales, (H, W)))
    assert torch.equal(got, mirror)


# K1 is the K = 1 case of the same tile function: T = 384 is the
# single-object bank's 3-scale call (128 boxes x 3 per-track scales).
@pytest.mark.parametrize("s", [64, 48, 30])
@pytest.mark.parametrize("with_scales", [False, True])
@pytest.mark.parametrize("t", [1, 37, 128, 384])
@pytest.mark.parametrize("pyramid", [torch.uint8, torch.float32])
def test_roi_kernel_equals_mirror(cuda, pyramid, t, with_scales, s):
    frame = torch.as_tensor(np.random.default_rng(8).integers(
        0, 256, (H, W), dtype=np.uint8), device=cuda)
    if pyramid == torch.float32:
        frame = frame.float() / 255.0
    levels = t_roi.build_pyramid(frame)
    boxes = torch.as_tensor(_scales_boxes(t), device=cuda)
    scales = (torch.as_tensor(np.random.default_rng(t).choice(
        SCALES, t).astype(np.float32), device=cuda) if with_scales else None)
    info = t_roi.launch_info(pyramid == torch.uint8, s)
    assert info["path"] == t_roi.SCALES_PATHS[s == 64]
    before = t_roi.launches, t_roi.launches_scales
    got = t_roi.extract_patches(None, boxes, 2.5, s, levels=levels,
                                frame_hw=(H, W), scales=scales)
    want = t_roi.extract_patches_ref(None, boxes, 2.5, s, levels=levels,
                                     frame_hw=(H, W), scales=scales)
    torch.cuda.synchronize()
    assert (t_roi.launches, t_roi.launches_scales) == (before[0] + 1,
                                                       before[1])
    assert got.shape == (t, s, s)
    assert (got - want).abs().max().item() <= 1e-5
    lvl, r0, c0, ys, xs = t_roi.sample_coords(boxes, 2.5, s, (H, W), scales)
    mirror = t_roi.four_tap_mirror(levels, (H, W), lvl, r0, c0, ys[None],
                                   xs[None])[0]
    assert torch.equal(got, mirror)


@pytest.mark.parametrize("rows", [4, 2, 1])
@pytest.mark.parametrize("s", [64, 30])
def test_roi_kernel_rows_per_thread_variants_equal_mirror(cuda, s, rows):
    """The variants that tools/kernel_cost.py times give the same bits."""
    frame = torch.as_tensor(np.random.default_rng(9).integers(
        0, 256, (H, W), dtype=np.uint8), device=cuda)
    levels = t_roi.build_pyramid(frame)
    boxes = torch.as_tensor(_scales_boxes(37), device=cuda)
    lvl, r0, c0, ys, xs = t_roi.sample_coords(boxes, 2.5, s, (H, W))
    got = t_roi._resample_cuda(levels, (H, W), lvl, r0, c0, ys, xs,
                               rows_per_thread=rows)
    mirror = t_roi.four_tap_mirror(levels, (H, W), lvl, r0, c0, ys[None],
                                   xs[None])[0]
    assert torch.equal(got, mirror)
    with pytest.raises(RuntimeError, match="CUDA error"):
        t_roi._resample_cuda(levels, (H, W), lvl, r0, c0, ys, xs,
                             rows_per_thread=3)


def test_roi_wrapper_rejects_a_size_the_kernel_does_not_take(cuda):
    frame = torch.zeros((64, 96), dtype=torch.uint8, device=cuda)
    boxes = torch.as_tensor(BOXES[:2] * 0.05, device=cuda)
    with pytest.raises(ValueError, match="template size"):
        t_roi.extract_patches(frame, boxes, 2.5, t_roi.max_scales_s() + 1)


def test_roi_scales_wrapper_rejects_a_size_the_kernel_does_not_take(cuda):
    frame = torch.zeros((64, 96), dtype=torch.uint8, device=cuda)
    boxes = torch.as_tensor(BOXES[:2] * 0.05, device=cuda)
    with pytest.raises(ValueError, match="template size"):
        t_roi.extract_patches_scales(frame, boxes, 2.5,
                                     t_roi.max_scales_s() + 1, SCALES)


def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _kcf_inputs(dev, t, c, s, k=1, seed=0):
    rng = np.random.default_rng(seed)
    feat0 = torch.as_tensor(
        rng.standard_normal((t, c, s, s)).astype(np.float32) * 0.3,
        device=dev)
    feat = torch.as_tensor(
        rng.standard_normal((k * t, c, s, s)).astype(np.float32) * 0.3,
        device=dev)
    yf = t_kcf.make_yf(s, 2.5, 0.125, device=dev)
    # The wrappers take contiguous spectra; cuFFT's may be strided.
    model = t_kcf.KCFModel(*[x.contiguous() for x in
                             t_kcf.train(feat0, yf, 0.2, 1e-4)])
    return model, feat, yf


# The slice's shapes: HF (3 scales x 128 tracks, fHOG-31 at S=16) and the
# default gray shape (128 tracks, S=64), plus one in between.  The S = 16
# shapes with at most 32 channels take the FFT path, (33, 16) and every
# other S the direct path.
@pytest.mark.parametrize("c,s,k", [(31, 16, 3), (1, 64, 1), (3, 32, 2),
                                   (1, 16, 1), (32, 16, 2), (33, 16, 1),
                                   (3, 12, 2)])
def test_kcf_detect_kernel_matches_plain_version(cuda, c, s, k):
    model, feat, _ = _kcf_inputs(cuda, 128, c, s, k)
    fft_path = s == 16 and c <= 32
    assert (t_kcfk.detect_launch_info(c, s)["path"]
            == t_kcfk.PATHS[fft_path])
    before = t_kcfk.launches_detect
    got = t_kcfk.detect_fused(model, feat, 0.2)
    want = t_kcfk.detect_fused_ref(model, feat, 0.2)
    torch.cuda.synchronize()
    assert t_kcfk.launches_detect == before + 1
    assert got.shape == (k * 128, s, s)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("c,s", [(31, 16), (3, 12)])
def test_kcf_detect_kernel_is_deterministic(cuda, c, s):
    """No atomics, fixed summation order: two runs on the same input are
    bit-equal (the ids-equal checks against the JAX run rely on it)."""
    model, feat, _ = _kcf_inputs(cuda, 128, c, s, 3, seed=3)
    first = t_kcfk.detect_fused(model, feat, 0.2)
    second = t_kcfk.detect_fused(model, feat, 0.2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_kcf_detect_kernel_takes_unaligned_features(cuda):
    """Features 4 bytes off a 16-byte boundary take the direct path (the
    FFT path reads float4) and give the same response."""
    model, feat, _ = _kcf_inputs(cuda, 8, 31, 16, 3)
    flat = torch.zeros(feat.numel() + 1, device=cuda)
    off = flat[1:].view(feat.shape)
    off.copy_(feat)
    assert off.data_ptr() % 16 == 4
    got = t_kcfk.detect_fused(model, off, 0.2)
    want = t_kcfk.detect_fused(model, feat, 0.2)
    assert _rel_err(got, want) <= 1e-4


# (1, 16), (31, 16), (32, 16) take the FFT kernel; (33, 16) and every other
# S the direct one.
@pytest.mark.parametrize("c,s", [(31, 16), (1, 64), (3, 32), (1, 16),
                                 (32, 16), (33, 16), (3, 12)])
def test_kcf_train_kernel_matches_plain_version(cuda, c, s):
    model, feat, yf = _kcf_inputs(cuda, 128, c, s, seed=1)
    lr = torch.tensor([1.0, 0.075, 0.0, 0.5], device=cuda).repeat(32)
    fft_path = s == 16 and c <= 32
    assert (t_kcfk.train_launch_info(c, s)["path"]
            == t_kcfk.PATHS[fft_path])
    before = t_kcfk.launches_train
    got = t_kcfk.train_fused(model, feat, yf, 0.2, 1e-4, lr)
    want = t_kcfk.train_fused_ref(model, feat, yf, 0.2, 1e-4, lr)
    torch.cuda.synchronize()
    assert t_kcfk.launches_train == before + 1
    assert _rel_err(got.xf, want.xf) <= 1e-4
    assert _rel_err(got.alphaf, want.alphaf) <= 1e-3
    assert torch.equal(got.xf[2], model.xf[2])            # lr = 0 keeps
    assert torch.equal(got.alphaf[2], model.alphaf[2])


@pytest.mark.parametrize("c,s", [(31, 16), (1, 16), (3, 12)])
def test_kcf_train_kernel_is_deterministic(cuda, c, s):
    """A fixed tree over the channels, no atomics: two runs are bit-equal;
    a bank of 37 rows is no multiple of anything."""
    model, feat, yf = _kcf_inputs(cuda, 37, c, s, seed=4)
    lr = torch.full((37,), 0.075, device=cuda)
    first = t_kcfk.train_fused(model, feat, yf, 0.2, 1e-4, lr)
    second = t_kcfk.train_fused(model, feat, yf, 0.2, 1e-4, lr)
    want = t_kcfk.train_fused_ref(model, feat, yf, 0.2, 1e-4, lr)
    torch.cuda.synchronize()
    assert torch.equal(first.xf, second.xf)
    assert torch.equal(first.alphaf, second.alphaf)
    assert _rel_err(first.xf, want.xf) <= 1e-4
    assert _rel_err(first.alphaf, want.alphaf) <= 1e-3


@pytest.mark.parametrize("which", ["feat", "xf"])
def test_kcf_train_kernel_takes_unaligned_tensors(cuda, which):
    """Features or a model 8 bytes off a 16-byte boundary take the direct
    kernel (the FFT kernel reads and writes 16 bytes at a time) and give
    the same model."""
    model, feat, yf = _kcf_inputs(cuda, 8, 31, 16, seed=5)
    lr = torch.full((8,), 0.3, device=cuda)
    want = t_kcfk.train_fused(model, feat, yf, 0.2, 1e-4, lr)
    if which == "feat":
        flat = torch.zeros(feat.numel() + 2, device=cuda)
        off = flat[2:].view(feat.shape)
        off.copy_(feat)
        args = (model, off)
    else:
        flat = torch.zeros(model.xf.numel() + 1, dtype=torch.complex64,
                           device=cuda)
        off = flat[1:].view(model.xf.shape)
        off.copy_(model.xf)
        args = (t_kcf.KCFModel(xf=off, alphaf=model.alphaf), feat)
    assert off.data_ptr() % 16 == 8 and off.is_contiguous()
    got = t_kcfk.train_fused(*args, yf, 0.2, 1e-4, lr)
    torch.cuda.synchronize()
    assert _rel_err(got.xf, want.xf) <= 1e-4
    assert _rel_err(got.alphaf, want.alphaf) <= 1e-3


def test_kcf_wrappers_reject_what_the_kernels_do_not_take(cuda):
    model, feat, yf = _kcf_inputs(cuda, 4, 1, 16)
    lr = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        t_kcfk.detect_fused(model, feat[:3], 0.2)
    with pytest.raises(ValueError, match="feat"):
        t_kcfk.detect_fused(model, feat.double(), 0.2)
    with pytest.raises(ValueError, match="yf"):
        t_kcfk.train_fused(model, feat, yf[:, :4], 0.2, 1e-4, lr)
    big, feat_big, _ = _kcf_inputs(cuda, 2, 31, 64)
    with pytest.raises(ValueError, match="shared memory"):
        t_kcfk.detect_fused(big, feat_big, 0.2)


K6_TOL = {"xf": 1e-6, "alphaf": 1e-4}


def _shift_inputs(dev, t, seed=0):
    """K6's arguments at t rows: a bank trained on seeded features, the
    spectra of others, shifts up to just inside +-S/4 (every 7th row 0),
    rates 0, 0.075, 1, 0.075."""
    model, feat, yf = _kcf_inputs(dev, t, 1, 64, seed=seed)
    rng = np.random.default_rng(seed + 100)
    shifts = rng.uniform(-15.999, 15.999, (2, t)).astype(np.float32)
    shifts[:, ::7] = 0.0
    dy, dx = (torch.as_tensor(x, device=dev) for x in shifts)
    lr = torch.tensor([0.0, 0.075, 1.0, 0.075], device=dev).repeat(t // 4)
    return (model, torch.fft.rfft2(feat).contiguous(), dy, dx, yf, 0.2,
            1e-4, lr, 64)


def test_kcf_train_shift_kernel_matches_plain_version(cuda):
    """K6 at the serve cell's 256 x 128 rows against its plain version;
    one launch; lr = 0 keeps the old model exactly."""
    args = _shift_inputs(cuda, 256 * 128)
    model, lr = args[0], args[7]
    before = t_kcfk.launches_train_shift
    got = t_kcfk.train_shift_fused(*args)
    want = t_kcfk.train_shift_fused_ref(*args)
    torch.cuda.synchronize()
    assert t_kcfk.launches_train_shift == before + 1
    assert _rel_err(got.xf, want.xf) <= K6_TOL["xf"]
    assert _rel_err(got.alphaf, want.alphaf) <= K6_TOL["alphaf"]
    assert torch.equal(got.xf[lr == 0], model.xf[lr == 0])
    assert torch.equal(got.alphaf[lr == 0], model.alphaf[lr == 0])


def test_kcf_train_shift_kernel_is_deterministic_by_row(cuda):
    """Fixed orders, no atomics, a row from that row alone: two runs
    bit-equal, and rows run alone equal to the same rows of the batch."""
    args = _shift_inputs(cuda, 64, seed=3)
    first = t_kcfk.train_shift_fused(*args)
    second = t_kcfk.train_shift_fused(*args)
    part = slice(9, 14)
    model, zf, dy, dx, yf, sigma, lam, lr, width = args
    alone = t_kcfk.train_shift_fused(
        t_kcf.KCFModel(*[x[part].contiguous() for x in model]),
        zf[part].contiguous(), dy[part].contiguous(), dx[part].contiguous(),
        yf, sigma, lam, lr[part].contiguous(), width)
    torch.cuda.synchronize()
    assert torch.equal(first.xf, second.xf)
    assert torch.equal(first.alphaf, second.alphaf)
    assert torch.equal(alone.xf, first.xf[part])
    assert torch.equal(alone.alphaf, first.alphaf[part])


@pytest.mark.parametrize("c,s,impl,kernel", [
    (1, 64, "auto", True), (1, 64, "pallas", True), (1, 64, "xla", False),
    (31, 16, "auto", False), (1, 48, "auto", False), (1, 32, "pallas", False)])
def test_kcf_train_shift_route_on_card(cuda, c, s, impl, kernel):
    """train_shift_blend_auto launches K6 for gray S = 64 under "auto" or
    "pallas" and runs the chain (bit for bit its plain version) otherwise."""
    model, feat, yf = _kcf_inputs(cuda, 8, c, s, seed=5)
    zf = torch.fft.rfft2(feat)
    dy = torch.linspace(-3.0, 3.0, 8, device=cuda)
    lr = torch.full((8,), 0.075, device=cuda)
    before = t_kcfk.launches_train_shift
    got = t_kcf.train_shift_blend_auto(model, zf, dy, -dy, yf, 0.2, 1e-4,
                                       lr, s, impl)
    want = t_kcfk.train_shift_fused_ref(model, zf, dy, -dy, yf, 0.2, 1e-4,
                                        lr, s)
    torch.cuda.synchronize()
    assert t_kcfk.launches_train_shift - before == int(kernel)
    if kernel:
        assert _rel_err(got.alphaf, want.alphaf) <= K6_TOL["alphaf"]
    else:
        assert torch.equal(got.xf, want.xf)
        assert torch.equal(got.alphaf, want.alphaf)


def test_kcf_train_shift_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = list(_shift_inputs(cuda, 8))
    model, zf = args[0], args[1]
    cases = [
        (dict(width=48), "width"),
        (dict(zf=zf.transpose(-1, -2).contiguous().transpose(-1, -2)), "zf"),
        (dict(lr=args[7].double()), "lr"),
        (dict(model=t_kcf.KCFModel(model.xf[:4], model.alphaf)), "xf"),
    ]
    flat = torch.zeros(zf.numel() + 1, dtype=zf.dtype, device=cuda)
    off = flat[1:].view(zf.shape)
    off.copy_(zf)
    cases.append((dict(zf=off), "aligned"))
    names = ("model", "zf", "dy", "dx", "yf", "sigma", "lambda_", "lr",
             "width")
    for change, match in cases:
        kw = dict(zip(names, args), **change)
        with pytest.raises(ValueError, match=match):
            t_kcfk.train_shift_fused(**kw)


@pytest.mark.parametrize("kcf_impl,train_site", [("pallas", "refined"),
                                                 ("auto", "detect")])
def test_heavy_tracker_on_card_matches_cpu(cuda, kcf_impl, train_site):
    """The heavy configuration (fHOG-31, 3-scale search) on a small u8
    fixture: the kernels on the card against their plain versions on the
    CPU, frame by frame."""
    h, w = 120, 160
    rng = np.random.default_rng(11)
    objs = synthetic.make_objects(6, h, w, rng, min_size=12, max_size=24,
                                  max_speed=2.0)
    frames, boxes, vis = synthetic.render_sequence(objs, 8, h, w, seed=2,
                                                   noise=0.01)
    dets = synthetic.detections_from_gt(boxes, vis, seed=2, frame_hw=(h, w))
    frames_u8 = torch.as_tensor((frames * 255).astype(np.uint8))
    d = np.zeros((8, 8, 5), np.float32)
    v = np.zeros((8, 8), bool)
    for f in range(8):
        d[f], v[f] = t_api.pad_detections(dets[f], 8)
    d, v = torch.as_tensor(d), torch.as_tensor(v)
    cfg = TrackerConfig(
        kcf=KCFConfig(template_size=32, feature_type="hog", cell_size=4,
                      scale_step=1.05),
        max_tracks=8, max_detections=8, frame_height=h, frame_width=w,
        kcf_impl=kcf_impl, train_site=train_site)
    cpu_cfg = cfg.replace(roi_impl="pallas", assign_impl="pallas")
    _, want = t_scan.run_sequence(t_bank.empty_bank(cpu_cfg, device="cpu"),
                                  frames_u8, d, v, cpu_cfg)
    k0 = (t_roi.launches_scales, t_kcfk.launches_detect,
          t_kcfk.launches_train, t_roi.launches)
    _, got = t_scan.run_sequence(t_bank.empty_bank(cfg, device=cuda),
                                 frames_u8.to(cuda), d.to(cuda), v.to(cuda),
                                 cfg)
    torch.cuda.synchronize()
    fused = int(kcf_impl == "pallas")
    assert (t_roi.launches_scales - k0[0], t_kcfk.launches_detect - k0[1],
            t_kcfk.launches_train - k0[2], t_roi.launches - k0[3]) == (
                8, 8 * fused, 8 * fused, 8 * fused)
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert (got.boxes.cpu() - want.boxes).abs().max().item() <= 1e-3


@pytest.mark.parametrize("warm", [False, True])
def test_assoc_tracker_on_card_matches_cpu(cuda, warm):
    """The association branches (class gate, assoc_box "best", appearance
    blend; with and without the warm-started auction) at full width, 1080p
    with 128 slots and 160 detections of three classes, for 8 frames."""
    h, w, n = 1080, 1920, 8
    objs = synthetic.make_objects(128, h, w, np.random.default_rng(0),
                                  n_classes=3)
    frames, boxes, vis = synthetic.render_sequence(objs, n, h, w, seed=0,
                                                   noise=0.01)
    dets = synthetic.detections_from_gt(
        boxes, vis, seed=0, frame_hw=(h, w),
        classes=np.array([o.cls for o in objs]))
    frames_u8 = torch.as_tensor((frames * 255).astype(np.uint8))
    d = np.zeros((n, 160, 6), np.float32)
    v = np.zeros((n, 160), bool)
    for f in range(n):
        d[f], v[f] = t_api.pad_detections(dets[f], 160, width=6)
    d, v = torch.as_tensor(d), torch.as_tensor(v)
    cfg = TrackerConfig(max_tracks=128, max_detections=160, frame_height=h,
                        frame_width=w, class_aware=True,
                        appearance_weight=0.3, auction_warm_start=warm)
    assert cfg.assoc_box_resolved == "best"
    cpu_cfg = cfg.replace(roi_impl="pallas", assign_impl="pallas")
    _, want = t_scan.run_sequence(t_bank.empty_bank(cpu_cfg, device="cpu"),
                                  frames_u8, d, v, cpu_cfg)
    roi0, auc0 = t_roi.launches, t_auction.launches
    bank, got = t_scan.run_sequence(t_bank.empty_bank(cfg, device=cuda),
                                    frames_u8.to(cuda), d.to(cuda),
                                    v.to(cuda), cfg)
    torch.cuda.synchronize()
    assert (t_roi.launches - roi0, t_auction.launches - auc0) == (
        n, 0 if warm else n)
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert torch.equal(got.cls.cpu(), want.cls)
    assert torch.equal(got.assign_iters.cpu(), want.assign_iters)
    assert (got.boxes.cpu() - want.boxes).abs().max().item() <= 1e-3
    if warm:
        assert bank.auction_prices.abs().max().item() > 0


def test_kcf_tracker_on_card(cuda):
    """The single-object flow on the card: two K1 launches a frame after
    the first, and the box stays on the moving object."""
    objs = [synthetic.SyntheticObject(cx=160, cy=120, w=28, h=24, vx=2.0,
                                      vy=1.2)]
    clip, gt, _ = synthetic.render_sequence(objs, 30, 480, 640, seed=3,
                                            noise=0.0)
    roi0 = t_roi.launches
    tracker = t_kcf_bank.KCFTracker()
    assert tracker.device.type == "cuda"
    tracker.init(clip[0], gt[0, 0])
    for f in range(1, len(clip)):
        box, peak = tracker.update(clip[f])
        assert np.hypot(box[0] - gt[f, 0, 0], box[1] - gt[f, 0, 1]) < 2.0
        assert np.isfinite(peak)
    assert t_roi.launches - roi0 == 1 + 2 * (len(clip) - 1)


DET_HW = (96, 128)


def small_detector(name, device, dtype="float32"):
    spec = t_yolo.YoloSpec(name, num_classes=3, input_size=64, dtype=dtype)
    return t_det.YoloDetector.random_init(spec, seed=2, max_out=16,
                                          score_thr=0.2, device=device)


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov2-tiny", "yolov2",
                                  "yolov3"])
def test_detector_heads_on_card_match_cpu(cuda, name):
    x = torch.as_tensor(np.random.default_rng(1).random(
        (2, 1, 64, 64)).astype(np.float32))
    with torch.no_grad():
        want = small_detector(name, "cpu").model(x)
        got = small_detector(name, cuda).model(x.to(cuda))
    for a, b in zip(want, got):
        assert b.device.type == "cuda" and b.dtype == torch.float32
        err = (b.cpu() - a).abs().max().item()
        assert err <= 1e-4 * a.abs().max().item(), err


@pytest.mark.parametrize("cin,stride,gray", [(16, 1, False), (64, 2, False),
                                             (1024, 1, False), (3, 1, True)])
def test_int8_conv_on_card_equals_cpu(cuda, cin, stride, gray):
    """The int8 conv's integer sums are exact on both devices (float64;
    1024 channels pass float32's 2^24), so the outputs are bit-equal.  A
    whole int8 net is not compared: a float32 rounding difference between
    cuDNN and the CPU upstream can move one activation by a quantisation
    step."""
    rng = np.random.default_rng(cin)
    x = torch.as_tensor(rng.standard_normal(
        (2, 1 if gray else cin, 9, 11)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((5, cin, 3, 3)).astype(
        np.float32))
    want = t_yolo._quant_conv(x, w, stride, 1, gray)
    got = t_yolo._quant_conv(x.to(cuda), w.to(cuda), stride, 1, gray)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("impl", ["greedy", "fast"])
def test_nms_on_card_equals_cpu(cuda, impl):
    det = small_detector("yolov3-tiny", cuda)
    frames = torch.as_tensor(np.random.default_rng(5).integers(
        0, 256, (3,) + DET_HW, dtype=np.uint8), device=cuda)
    boxes, scores, classes = t_det.decode_frames(det.model, frames, DET_HW)
    got = t_nms.nms_classwise(boxes, scores, classes, 16, 0.45, 0.2,
                              impl=impl)
    want = t_nms.nms_classwise(boxes.cpu(), scores.cpu(), classes.cpu(), 16,
                               0.45, 0.2, impl=impl)
    assert got[1].any()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    dets, valid, cls = t_det.detect_batch(det.model, frames, DET_HW, 16,
                                          0.45, 0.2, nms_impl=impl)
    assert dets.device.type == "cuda" and torch.equal(valid, got[1])


def test_bfloat16_detector_on_card(cuda):
    """bf16 on the card: finite, its top score within 0.05 of float32's
    (tests/test_detector.py:305)."""
    frames = torch.as_tensor(np.random.default_rng(4).random(
        (2,) + DET_HW).astype(np.float32), device=cuda)
    d32, _, _ = t_det.detect_batch(small_detector("yolov2-tiny", cuda).model,
                                   frames, DET_HW, 8, 0.45, 0.0)
    d16, _, _ = t_det.detect_batch(
        small_detector("yolov2-tiny", cuda, "bfloat16").model, frames,
        DET_HW, 8, 0.45, 0.0, nms_impl="fast")
    assert torch.isfinite(d16).all()
    assert (d16[:, 0, 4] - d32[:, 0, 4]).abs().max().item() <= 0.05


@pytest.mark.parametrize("n", [6, 7])
def test_strided_scans_on_card(cuda, n):
    """The strided scans on the card equal run_sequence fed the detector's
    detections on the stride frames and none elsewhere (ids and valid
    exact, boxes within 0.05 px), with K1 and K2 launched once a frame."""
    spec = t_yolo.YoloSpec("yolov2-tiny", num_classes=1, input_size=64)
    det = t_det.YoloDetector.random_init(spec, seed=0, device=cuda)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=96,
                        frame_width=128)
    frames = torch.as_tensor(np.random.default_rng(2).random(
        (n, 96, 128)).astype(np.float32), device=cuda)
    d = torch.zeros((n, 8, 5), device=cuda)
    v = torch.zeros((n, 8), dtype=torch.bool, device=cuda)
    for i in range(0, n, 3):
        d[i], v[i], _ = (x[0] for x in t_det.detect_batch(
            det.model, frames[i:i + 1], (96, 128), 8, 0.45, 0.2))
    assert v.any()
    bank0 = t_bank.empty_bank(cfg, device=cuda)
    _, want = t_scan.run_sequence(bank0, frames, d, v, cfg)
    for fn in (t_scan.run_sequence_strided_detector,
               t_scan.run_sequence_strided_batched):
        roi0, auc0 = t_roi.launches, t_auction.launches
        _, got = fn(bank0, frames, det.model, cfg, 3, score_thr=0.2)
        torch.cuda.synchronize()
        assert (t_roi.launches - roi0, t_auction.launches - auc0) == (n, n)
        assert torch.equal(got.ids, want.ids), fn.__name__
        assert torch.equal(got.valid, want.valid), fn.__name__
        assert (got.boxes - want.boxes).abs().max().item() <= 0.05


# ---- serving: K1/K3 with a frame index, K2 over a batch, the stream step


def _stacked_frames(dev, n, pyramid):
    frames = torch.as_tensor(np.random.default_rng(11).integers(
        0, 256, (n, H, W), dtype=np.uint8), device=dev)
    return frames if pyramid == torch.uint8 else frames.float() / 255.0


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("pyramid", [torch.uint8, torch.float32])
def test_roi_kernels_with_frame_index(cuda, pyramid, k):
    """Levels of 3 frames [3, H_l, W_l] and 3 x 37 stream-major boxes:
    one launch, equal to the plain version (1e-5), bit-equal to the 4-tap
    mirror and to one launch per frame."""
    frames = _stacked_frames(cuda, 3, pyramid)
    levels = t_roi.build_pyramid(frames)
    assert levels[0].shape == (3, H, W) and levels[0].dtype == pyramid
    boxes = torch.as_tensor(np.concatenate(
        [_scales_boxes(37)[::-1], _scales_boxes(37),
         _scales_boxes(37)[::2].repeat(2, 0)[:37]]), device=cuda)
    before = t_roi.launches, t_roi.launches_scales
    if k == 1:
        got = t_roi.extract_patches(None, boxes, 2.5, 64, levels=levels,
                                    frame_hw=(H, W))
        want = t_roi.extract_patches_ref(None, boxes, 2.5, 64, levels=levels,
                                         frame_hw=(H, W))
        lvl, r0, c0, ys, xs = t_roi.sample_coords(boxes, 2.5, 64, (H, W))
        mirror = t_roi.four_tap_mirror(levels, (H, W), lvl, r0, c0,
                                       ys[None], xs[None])[0]
        one = [t_roi.extract_patches(None, boxes[37 * f:37 * (f + 1)], 2.5,
                                     64, levels=[lv[f] for lv in levels],
                                     frame_hw=(H, W)) for f in range(3)]
        whole = torch.cat(one)
        assert t_roi.launches == before[0] + 4
    else:
        got = t_roi.extract_patches_scales(None, boxes, 2.5, 64, SCALES,
                                           levels=levels, frame_hw=(H, W))
        want = t_roi.extract_patches_scales_ref(
            None, boxes, 2.5, 64, SCALES, levels=levels, frame_hw=(H, W))
        mirror = t_roi.four_tap_mirror(levels, (H, W), *t_roi.
                                       sample_coords_scales(
                                           boxes, 2.5, 64, SCALES, (H, W)))
        one = [t_roi.extract_patches_scales(
            None, boxes[37 * f:37 * (f + 1)], 2.5, 64, SCALES,
            levels=[lv[f] for lv in levels], frame_hw=(H, W))
            for f in range(3)]
        whole = torch.cat(one, dim=1)
        assert t_roi.launches_scales == before[1] + 4
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got, mirror) and torch.equal(got, whole)


@pytest.mark.parametrize("n,batch", [(128, 8), (160, 3), (5, 3), (161, 3),
                                     (7, 1), (256, 8), (257, 3)])
def test_auction_kernel_over_a_batch(cuda, n, batch):
    """[S, n, n] in one launch, one CTA a problem: each problem's col_of
    and iters equal the plain version's and a single launch's (odd n: the
    per-problem scalar staging; n = 128 the bulk copy; n = 256 and 257 the
    rows from global memory)."""
    rng = np.random.default_rng(n + batch)
    cost = torch.as_tensor(rng.uniform(0, 1, (batch, n, n)).astype(
        np.float32), device=cuda)
    feas = torch.as_tensor(rng.random((batch, n, n)) < 0.8, device=cuda)
    b = t_assign.build_benefits(cost, feas, t_assign.DEFAULT_EPS)
    before = t_auction.launches
    col, it = t_auction.auction_solve(b, t_assign.DEFAULT_EPS, 2000)
    assert t_auction.launches == before + 1
    assert col.shape == (batch, n) and it.shape == (batch,)
    want_col, want_it = t_auction.auction_solve_ref(b, t_assign.DEFAULT_EPS,
                                                    2000)
    assert torch.equal(col, want_col) and torch.equal(it, want_it)
    for p in range(batch):
        c1, i1 = t_auction.auction_solve(b[p].contiguous(),
                                         t_assign.DEFAULT_EPS, 2000)
        assert torch.equal(col[p], c1) and int(it[p]) == int(i1)


@pytest.mark.parametrize("mode", ["default", "HF", "AW"])
def test_multi_stream_step_on_card_equals_single_steps(cuda, mode):
    """Three streams stepped together on the card against each stream
    stepped alone on the card: ids, valid, state and matches equal, boxes
    within 1e-4 px (cuFFT may pick another algorithm for another batch)."""
    h, w, n_str, n = 240, 320, 3, 6
    cls = mode == "AW"
    frames, d, v = [], [], []
    for s in range(n_str):
        rng = np.random.default_rng(20 + s)
        objs = synthetic.make_objects(8, h, w, rng, max_speed=2.0,
                                      n_classes=3 if cls else 1)
        fr, boxes, vis = synthetic.render_sequence(objs, n, h, w, seed=s)
        kw = dict(classes=np.array([o.cls for o in objs])) if cls else {}
        dl = synthetic.detections_from_gt(boxes, vis, seed=s,
                                          frame_hw=(h, w), **kw)
        dd = np.zeros((n, 16, 6 if cls else 5), np.float32)
        vv = np.zeros((n, 16), bool)
        for f in range(n):
            dd[f], vv[f] = t_api.pad_detections(dl[f], 16,
                                                width=6 if cls else 5)
        frames.append((fr * 255).astype(np.uint8))
        d.append(dd)
        v.append(vv)
    frames, d, v = (torch.as_tensor(np.stack(x), device=cuda)
                    for x in (frames, d, v))
    cfg = TrackerConfig(max_tracks=32, max_detections=16, frame_height=h,
                        frame_width=w)
    if mode == "HF":
        cfg = cfg.replace(kcf=KCFConfig(feature_type="hog", cell_size=4,
                                        scale_step=1.05),
                          kcf_impl="pallas", train_site="refined")
    elif mode == "AW":
        cfg = cfg.replace(class_aware=True, appearance_weight=0.3,
                          auction_warm_start=True)
    banks = t_serve.make_stream_banks(n_str, cfg, device=cuda)
    singles = [t_bank.empty_bank(cfg, device=cuda) for _ in range(n_str)]
    for f in range(n):
        before = t_roi.launches
        banks, out = t_serve.multi_stream_step(banks, frames[:, f], d[:, f],
                                               v[:, f], cfg)
        assert t_roi.launches == before + 1     # K1 once for all streams
        for s in range(n_str):
            singles[s], o = t_step.step(singles[s], frames[s, f], d[s, f],
                                        v[s, f], cfg)
            for name in ("ids", "valid", "matched_det", "assign_iters"):
                assert torch.equal(getattr(out, name)[s], getattr(o, name))
            assert (out.boxes[s] - o.boxes).abs().max().item() <= 1e-4


@pytest.mark.parametrize("mode", ["default", "HF"])
def test_multi_stream_step_makes_no_host_sync(cuda, mode):
    """After a first step (kernel builds, per-device constants) the
    serving step queues its work without waiting for the card: no call
    under torch's sync debug mode "error" synchronises.  (The warm-started
    auction tests its loops on the host, so AW is left out.)"""
    h, w, n_str, n = 240, 320, 3, 4
    frames, d, v = [], [], []
    for s in range(n_str):
        rng = np.random.default_rng(30 + s)
        objs = synthetic.make_objects(8, h, w, rng, max_speed=2.0)
        fr, boxes, vis = synthetic.render_sequence(objs, n, h, w, seed=s)
        dl = synthetic.detections_from_gt(boxes, vis, seed=s,
                                          frame_hw=(h, w))
        pads = [t_api.pad_detections(dl[f], 16, width=5) for f in range(n)]
        frames.append((fr * 255).astype(np.uint8))
        d.append(np.stack([p[0] for p in pads]))
        v.append(np.stack([p[1] for p in pads]))
    frames, d, v = (torch.as_tensor(np.stack(x), device=cuda)
                    for x in (frames, d, v))
    cfg = TrackerConfig(max_tracks=32, max_detections=16, frame_height=h,
                        frame_width=w)
    if mode == "HF":
        cfg = cfg.replace(kcf=KCFConfig(feature_type="hog", cell_size=4,
                                        scale_step=1.05),
                          kcf_impl="pallas", train_site="refined")
    banks = t_serve.make_stream_banks(n_str, cfg, device=cuda)
    banks, _ = t_serve.multi_stream_step(banks, frames[:, 0], d[:, 0],
                                         v[:, 0], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in range(1, n):
            banks, out = t_serve.multi_stream_step(banks, frames[:, f],
                                                   d[:, f], v[:, f], cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out.n_alive.sum()) > 0


def test_train_step_on_card_matches_cpu(cuda):
    """One train step of yolov2-tiny (64 px, 3 classes, momentum 0.9) on
    the card against the same step on the CPU from the same weights: the
    loss 1e-5 relative, every gradient leaf within 1e-3 of its largest
    magnitude (cuDNN's and oneDNN's float32 backward; deep BatchNorm
    gradients are only known to ~1e-3 in float32), the running
    statistics 1e-5."""
    from tpu_mot_torch import interop
    from tpu_mot_torch.parallel import train as t_train

    spec = t_yolo.YoloSpec("yolov2-tiny", num_classes=3, input_size=64,
                           bn_momentum=0.9)
    sd = interop.yolo_params_from_jax(interop.numpy_yolo_params(spec, 1))
    rng = np.random.default_rng(0)
    images = rng.random((4, 64, 64, 3)).astype(np.float32)
    gb = np.concatenate([rng.uniform(4, 60, (4, 5, 2)),
                         rng.uniform(6, 40, (4, 5, 2))], -1)
    tgt = t_train.build_targets(spec, gb, rng.integers(0, 3, (4, 5)),
                                np.ones((4, 5), bool))
    out = {}
    for dev in ("cpu", cuda):
        state = t_train.train_state_from_params(
            spec, lambda p: torch.optim.Adam(p, lr=1e-3), sd, device=dev)
        state.optimizer.zero_grad()
        loss = t_train.yolo_loss(state.model,
                                 torch.as_tensor(images, device=dev), tgt,
                                 spec, train=True)
        loss.backward()
        out[str(dev)] = (float(loss.detach()),
                         {n: p.grad.cpu() for n, p in
                          state.model.named_parameters()},
                         {k: v.cpu() for k, v in
                          state.model.state_dict().items() if "running" in k})
    (lc, gc, sc), (lg, gg, sg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for k in gc:
        assert float((gg[k] - gc[k]).abs().max()) <= 1e-3 * float(
            gc[k].abs().max()), k
    for k in sc:
        assert torch.allclose(sg[k], sc[k], rtol=0, atol=1e-5), k


def test_cli_mot_on_card(cuda, capsys):
    """`mot --synthetic` on the card (the default device): one K1 and one K2
    launch a frame, and the metrics of the CPU run within 0.01 MOTA."""
    import json

    from tpu_mot_torch import cli

    args = ["mot", "--synthetic", "--objects", "16", "--frames", "16",
            "--chunk", "16", "--score"]
    t_roi.launches = t_auction.launches = 0
    assert cli.main(args) == 0
    assert (t_roi.launches, t_auction.launches) == (16, 16)
    card = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    cpu = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert card["mota"] >= cpu["mota"] - 0.01


# K7, the ConvBlock epilogue: every result compared as float32 words.
EPILOGUE_SHAPES = [(2, 32, 64, 64), (2, 1024, 19, 19), (2, 255, 13, 13),
                   (3, 1, 1, 1), (2, 3, 40, 33), (1, 64, 152, 152)]


def _epilogue_inputs(dev, shape, skip, seed=0):
    """y with negatives, +-0, values near float32's largest and NaN; mean,
    mul = rsqrt(var + eps) * weight and bias per channel; skip or None."""
    rng = np.random.default_rng(seed)
    c = shape[1]
    y = (rng.standard_normal(shape) * 3).astype(np.float32)
    flat = y.reshape(-1)
    k = rng.permutation(flat.size)[:min(flat.size, 10)]
    flat[k] = np.array([0.0, -0.0, 3e38, -3e38, np.nan, 1e-40, -1e-40,
                        np.inf, -np.inf, np.nan], np.float32)[:k.size]
    mean, var, weight, bias = (torch.as_tensor(v, device=dev) for v in (
        rng.standard_normal(c), rng.random(c), rng.standard_normal(c),
        rng.standard_normal(c)))
    mul = torch.rsqrt(var.float() + 1e-5) * weight.float()
    s = (torch.as_tensor((rng.standard_normal(shape) * 2).astype(
        np.float32), device=dev) if skip else None)
    return (torch.as_tensor(y, device=dev), mean.float(), mul, bias.float(),
            s)


def _words(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "skip"])
@pytest.mark.parametrize("shape", EPILOGUE_SHAPES, ids=str)
def test_epilogue_kernel_equals_the_chain(cuda, shape, skip):
    """K7 in place into y, one launch, bit for bit the chain on the card."""
    y, mean, mul, bias, s = _epilogue_inputs(cuda, shape, skip)
    want = t_epi.epilogue_ref(y, mean, mul, bias, s)
    before = t_epi.launches
    y2 = y.clone()
    got = t_epi.fused(y2, mean, mul, bias, s)
    torch.cuda.synchronize()
    assert t_epi.launches == before + 1
    assert got.data_ptr() == y2.data_ptr()
    assert torch.equal(_words(got), _words(want))
    assert t_epi.vector_path(y, s) == (shape[2] * shape[3] % 4 == 0)


@pytest.mark.parametrize("skip", [False, True], ids=["plain", "skip"])
def test_epilogue_kernel_takes_unaligned_tensors(cuda, skip):
    """A plane that is a multiple of 4 at an address that is not 16-byte
    aligned takes the scalar path, bit for bit the chain."""
    shape = (2, 8, 16, 16)
    y, mean, mul, bias, s = _epilogue_inputs(cuda, shape, skip, seed=1)
    off = torch.empty(y.numel() + 1, device=cuda)[1:].view(shape)
    off.copy_(y)
    assert not t_epi.vector_path(off, s)
    got = t_epi.fused(off, mean, mul, bias, s)
    assert torch.equal(_words(got),
                       _words(t_epi.epilogue_ref(y, mean, mul, bias, s)))


@pytest.mark.parametrize("case", ["kernel", "train", "bfloat16", "float64",
                                  "non_contiguous", "requires_grad"])
def test_epilogue_route_on_card(cuda, case):
    """A float32 eval block on the card launches K7; each other case, where
    only the named condition differs, runs the chain (a chain block, no
    launch)."""
    blk = t_yolo.ConvBlock(4, 5, dtype="bfloat16" if case == "bfloat16"
                           else "float32").to(cuda).eval()
    x = torch.randn(2, 4, 8, 8, device=cuda)
    if case == "float64":
        blk, x = blk.double(), x.double()
    if case == "non_contiguous":
        x = x.contiguous(memory_format=torch.channels_last)
    if case == "train":
        blk.train()
    before = (t_epi.launches, t_epi.chain_blocks)
    with torch.set_grad_enabled(case == "requires_grad"):
        blk(x)
    torch.cuda.synchronize()
    kernel = case == "kernel"
    assert (t_epi.launches - before[0],
            t_epi.chain_blocks - before[1]) == (int(kernel), int(not kernel))


@pytest.mark.parametrize("name,bn_blocks", [("yolov3", 72),
                                            ("yolov3-tiny", 11),
                                            ("yolov2", 22),
                                            ("yolov2-tiny", 8)])
def test_yolo_heads_on_card_equal_the_chains(cuda, monkeypatch, name,
                                             bn_blocks):
    """A forward on the card launches K7 in every BatchNorm block and runs
    no chain; its heads equal, bit for bit, the same forward with the chain
    in every block."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = small_detector(name, cuda).model
    x = torch.as_tensor(np.random.default_rng(2).random(
        (2, 1, 64, 64)).astype(np.float32), device=cuda)
    before = (t_epi.launches, t_epi.chain_blocks)
    with torch.no_grad():
        got = model(x)
    assert (t_epi.launches - before[0],
            t_epi.chain_blocks - before[1]) == (bn_blocks, 0)
    monkeypatch.setattr(t_epi, "takes", lambda *a: False)
    with torch.no_grad():
        want = model(x)
    for a, b in zip(want, got):
        assert torch.equal(_words(b), _words(a))


def test_epilogue_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    y, mean, mul, bias, s = _epilogue_inputs(cuda, (2, 4, 8, 8), True)
    cases = [
        (dict(mean=mean[:3]), "mean"),
        (dict(mul=mul.double()), "mul"),
        (dict(bias=bias.cpu()), "bias"),
        (dict(y=y.transpose(2, 3)), "contiguous"),
        (dict(skip=s[:1]), "one shape"),
        (dict(y=y.clone().requires_grad_()), "gradient"),
    ]
    for change, match in cases:
        kw = dict(dict(y=y.clone(), mean=mean, mul=mul, bias=bias, skip=s),
                  **change)
        with pytest.raises(ValueError, match=match):
            t_epi.fused(**kw)
