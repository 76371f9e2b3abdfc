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
amplifies float32 error where k^ is small); the tracker on the card
against the tracker on the CPU: ids and valid exact, boxes 1e-3 (cuFFT
and the kernels' own transforms against pocketfft).
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
from tpu_mot_torch.ops import assignment as t_assign
from tpu_mot_torch.ops import iou as t_iou
from tpu_mot_torch.ops import kcf as t_kcf
from tpu_mot_torch.tracker import api as t_api
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import scan as t_scan

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


# n7, n33, n159: rows that are no multiple of 16 bytes (scalar staging,
# padded rows); nmax: the largest matrix; ties*: equal bids; n159 needs
# over 50 rounds (131 on the CPU).
@pytest.mark.parametrize("case", ["mot", "n1", "n8", "n40", "n160",
                                  "capped", "n7", "n33", "n159", "nmax",
                                  "ties40", "ties160", "ties159"])
def test_auction_kernel_matches_plain_version(cuda, case):
    rng = np.random.default_rng(7)
    max_iters = 3 if case == "capped" else 2000
    if case in ("mot", "capped"):
        b = _mot_benefits(rng, cuda)
    elif case.startswith("ties"):
        b = _quantised_benefits(rng, int(case[4:]), cuda)
    else:
        n = t_auction.max_n() if case == "nmax" else int(case[1:])
        cost = torch.as_tensor(rng.uniform(0, 1, (n, n)).astype(np.float32),
                               device=cuda)
        feas = torch.as_tensor(rng.random((n, n)) < 0.8, device=cuda)
        b = t_assign.build_benefits(cost, feas, t_assign.DEFAULT_EPS)
    before = t_auction.launches
    col, it = t_auction.auction_solve(b, t_assign.DEFAULT_EPS, max_iters)
    want_col, want_it = t_auction.auction_solve_ref(b, t_assign.DEFAULT_EPS,
                                                    max_iters)
    torch.cuda.synchronize()
    assert t_auction.launches == before + 1
    assert torch.equal(col, want_col) and int(it) == int(want_it)
    assert (case == "capped") == bool((col < 0).any())
    if case == "n159":
        assert int(it) >= 50


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


def test_auction_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    n_max = t_auction.max_n()
    assert 160 <= n_max < 240
    for bad in (torch.zeros((n_max + 1, n_max + 1), device=cuda),
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
    _, got = t_scan.run_sequence(t_bank.empty_bank(cfg, device=cuda),
                                 frames_u8.to(cuda), d.to(cuda), v.to(cuda),
                                 cfg)
    torch.cuda.synchronize()
    assert (t_roi.launches - roi0, t_auction.launches - auc0) == (8, 8)
    assert torch.equal(got.ids.cpu(), want.ids)
    assert torch.equal(got.valid.cpu(), want.valid)
    assert (got.boxes.cpu() - want.boxes).abs().max().item() <= 1e-3


SCALES = (1 / 1.05, 1.0, 1.05)


@pytest.mark.parametrize("pyramid", [torch.uint8, torch.float32])
def test_roi_scales_kernel_matches_plain_version(cuda, pyramid):
    frame = torch.as_tensor(np.random.default_rng(8).integers(
        0, 256, (H, W), dtype=np.uint8), device=cuda)
    if pyramid == torch.float32:
        frame = frame.float() / 255.0
    levels = t_roi.build_pyramid(frame)
    # Straddling box: 2.5 * 50 = 125 px at unit scale, 131 px at 1.05.
    boxes = torch.as_tensor(np.concatenate(
        [BOXES, [[300.0, 240.0, 50.0, 50.0]]]).astype(np.float32),
        device=cuda)
    before = t_roi.launches_scales
    got = t_roi.extract_patches_scales(None, boxes, 2.5, 64, SCALES,
                                       levels=levels, frame_hw=(H, W))
    want = t_roi.extract_patches_scales_ref(None, boxes, 2.5, 64, SCALES,
                                            levels=levels, frame_hw=(H, W))
    torch.cuda.synchronize()
    assert t_roi.launches_scales == before + 1
    assert got.shape == (3, boxes.shape[0], 64, 64)
    assert (got - want).abs().max().item() <= 1e-5


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


@pytest.mark.parametrize("c,s", [(31, 16), (1, 64), (3, 32)])
def test_kcf_train_kernel_matches_plain_version(cuda, c, s):
    model, feat, yf = _kcf_inputs(cuda, 128, c, s, seed=1)
    lr = torch.tensor([1.0, 0.075, 0.0, 0.5], device=cuda).repeat(32)
    before = t_kcfk.launches_train
    got = t_kcfk.train_fused(model, feat, yf, 0.2, 1e-4, lr)
    want = t_kcfk.train_fused_ref(model, feat, yf, 0.2, 1e-4, lr)
    torch.cuda.synchronize()
    assert t_kcfk.launches_train == before + 1
    assert _rel_err(got.xf, want.xf) <= 1e-4
    assert _rel_err(got.alphaf, want.alphaf) <= 1e-3
    assert torch.equal(got.xf[2], model.xf[2])            # lr = 0 keeps


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
