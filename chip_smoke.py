"""Smoke test of the PyTorch/CUDA port (tpu_mot_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing lines tagged with its name (any failure raises:
nonzero exit, no "ok" line):
  device     a CUDA card, its name and power limit (nvidia-smi);
  build      nvcc builds tpu_mot_torch/csrc, one process per source;
  roi        K1 (ROI kernel) against its plain version on a 1080p u8 bench
             frame, the fixture's 128 first-frame boxes plus edge cases,
             u8 and f32 pyramids (max |diff| 1e-5);
  roi3       K3 (3-scale ROI kernel) against its plain version: the 128
             bench boxes at scales 1/1.05, 1, 1.05, plus the edge cases
             and a box straddling a level boundary, u8 and f32 pyramids
             (max |diff| 1e-5);
  auction    K2 against its plain version: benefit matrices of the bench
             run's first frames, random n in {8, 40, 160}, all-infeasible,
             dead rows, a capped solve, odd n (7, 33, 159: padded rows,
             scalar staging; 159 needs over 50 rounds), n = max_n(), and
             tie-heavy matrices quantised to a grid of 0.25 (col_of and
             iters exactly equal);
  kcf        K4 (fused detect) and K5 (fused train + blend) against their
             plain versions, relative to each tensor's largest magnitude
             (1e-4 response and xf, 1e-3 alphaf): inputs captured from the
             first frames of an HF run ([384, 31, 16, 16] features, a
             [128, ...] bank; K4's FFT path) and at the gray shape (S=64,
             C=1, T=128; the direct path); K4 alone at C=3, S=12 (direct
             path) and twice on the HF inputs (bit-equal);
  e2e        the default configuration on bench.py's fixture (seed 0, 128
             objects, 64 frames, 1080p u8) through tracker.scan.run_sequence
             on cuda:0: MOTA >= the JAX reference's MOTA - 0.01, exactly 64
             launches of K1 and K2 and none of K3-K5; then MultiTracker.init
             + 4 updates must give run_sequence's confirmed ids and boxes;
  e2e-heavy  the heavy configuration, fHOG-31 + 3-scale, in modes H (K3,
             K2 64 launches each, the FFT chain) and HF (K1-K5 64 each) on
             the same fixture: the MOTA gate, the exact launch counts, and
             ids, valid and boxes per frame against a dump of the JAX run
             (tests/golden/bench_heavy_jax_v1.npz);
  times      run_sequence frames/s (default: median of 5; H, HF: median of
             3); each kernel against its plain version: the median ms per
             call from a CUDA event pair around each call
             (plain/kernel/kernel/plain; it includes the wrapper's host
             time, which bounds a short kernel) and the device ms per call
             from the profiler; the least time the card could take (bound);
             K2 also on the init frame's matrix and capped at 0 rounds
             (launch and staging alone); for K2 and K4 the code path,
             registers, shared memory and CTAs per SM;
  profile    where device time goes over 16 frames, default and HF.
The line before the last is {"kernels": [...]}: per kernel its launches
in the path that runs it (K1, K2: default; K3-K5: HF), "max_abs_err" the
largest difference from the plain version (K2: in col_of and iters; K4,
K5: relative to the largest magnitude, see "err_kind"), "ms"/"plain_ms"
the event times, "device_ms"/"plain_device_ms" the profiler's, "bound_ms"
and "bound_by" from this run's shapes and data at 3.35 TB/s and 67 TFLOP/s
float32, and "library_ms" null (no single PyTorch call computes any of
them).  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpu_mot_torch.config import KCFConfig, TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.kernels import _build
from tpu_mot_torch.kernels import auction as auction_k
from tpu_mot_torch.kernels import kcf as kcf_k
from tpu_mot_torch.kernels import roi as roi_k
from tpu_mot_torch.ops import assignment
from tpu_mot_torch.ops import features as feat_ops
from tpu_mot_torch.ops import kcf as kcf_ops
from tpu_mot_torch.tracker import api
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import scan
from tpu_mot_torch.utils import metrics

# MOTA / HOTA of the JAX reference (tpu_mot, jax 0.9.0 on the CPU,
# JAX_PLATFORMS=cpu) on this fixture, from bench.py's correctness block
# (bench.py:76-124) run unchanged.  The heavy modes score the same on the
# JAX reference (tpu_mot on the CPU, roi_impl="pallas").
M_REF = 0.984375
HOTA_REF = 0.937445222418187

HEIGHT, WIDTH, N_OBJ, N_FRAMES = 1080, 1920, 128, 64
ROI_TOL = 1e-5
EPS = assignment.DEFAULT_EPS
SCALES = (1.0 / 1.05, 1.0, 1.05)
KCF_TOL = {"response": 1e-4, "xf": 1e-4, "alphaf": 1e-3}

# The heavy configuration (tools/bench_variants.py "fhog31 + 3-scale"; the
# heavy golden's KCFConfig) and its two modes: H (defaults otherwise) and
# HF (the fused KCF kernels with refined-site training).
HEAVY_KCF = dict(feature_type="hog", cell_size=4, scale_step=1.05)
HEAVY = {"H": {}, "HF": dict(kcf_impl="pallas", train_site="refined")}
# ids, valid and boxes of the JAX reference (tpu_mot on the CPU,
# roi_impl="pallas") tracking the bench fixture in H and HF; regenerate
# with `python tests/test_torch_heavy.py regen-bench-dump`.
HEAVY_DUMP = (Path(__file__).resolve().parent / "tests" / "golden"
              / "bench_heavy_jax_v1.npz")

# Published H100 SXM peaks (the least-time bound of each kernel).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

KERNELS = ("roi_extract", "roi_extract_scales", "auction_solve",
           "kcf_detect", "kcf_train")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def reset_counts() -> None:
    roi_k.launches = roi_k.launches_scales = 0
    auction_k.launches = 0
    kcf_k.launches_detect = kcf_k.launches_train = 0


def read_counts() -> dict:
    return dict(zip(KERNELS, (roi_k.launches, roi_k.launches_scales,
                              auction_k.launches, kcf_k.launches_detect,
                              kcf_k.launches_train)))


def bench_fixture():
    """bench.py:76-104: the same objects, frames, detections and config."""
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(N_OBJ, HEIGHT, WIDTH, rng, min_size=24,
                                  max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(
        objs, N_FRAMES, HEIGHT, WIDTH, seed=0, noise=0.01)
    dets_list = synthetic.detections_from_gt(boxes, vis, seed=0,
                                             frame_hw=(HEIGHT, WIDTH))
    cfg = TrackerConfig(max_tracks=128, max_detections=160,
                        frame_height=HEIGHT, frame_width=WIDTH)
    d = np.zeros((N_FRAMES, cfg.max_detections, 5), np.float32)
    v = np.zeros((N_FRAMES, cfg.max_detections), bool)
    for f in range(N_FRAMES):
        d[f], v[f] = api.pad_detections(dets_list[f], cfg.max_detections)
    frames_u8 = (frames * 255).astype(np.uint8)
    return frames_u8, d, v, boxes, vis, dets_list, cfg


def heavy_config(cfg: TrackerConfig, name: str) -> TrackerConfig:
    """The bench config in heavy mode `name` ("H" or "HF")."""
    return cfg.replace(kcf=KCFConfig(**HEAVY_KCF), **HEAVY[name])


def edge_boxes() -> np.ndarray:
    """Corners, degenerate sizes, off-frame, level boundaries (128 px
    window = level 0/1 edge) and windows over 1024 px (block truncation)."""
    return np.array([
        [0.0, 0.0, 20.0, 20.0], [WIDTH - 1.0, HEIGHT - 1.0, 30.0, 18.0],
        [0.0, HEIGHT - 1.0, 40.0, 40.0], [WIDTH - 1.0, 0.0, 25.0, 33.0],
        [500.0, 400.0, 0.0, 0.0], [700.0, 300.0, -4.0, 12.0],
        [5000.0, -300.0, 20.0, 20.0], [300.0, 200.0, 51.2, 10.0],
        [310.0, 210.0, 51.21, 10.0], [900.0, 500.0, 102.4, 60.0],
        [950.0, 550.0, 102.5, 60.0], [1200.0, 700.0, 30.0, 204.8],
        [1000.0, 580.0, 600.0, 600.0], [1050.0, 540.0, 1000.0, 100.0],
        [960.0, 540.0, 900.0, 500.0], [1500.0, 900.0, 420.0, 300.0],
    ], np.float32)


# A window of 2.5 x 50 = 125 px at unit scale and 131 px at 1.05: its
# scales straddle the level 0/1 boundary (K3 samples level 1 for all).
STRADDLE = np.array([[300.0, 240.0, 50.0, 50.0]], np.float32)


def event_ms(fn, reps: int) -> list[float]:
    """ms of each of `reps` calls of fn, from a CUDA event pair around each
    call.  The stream idles while the host runs the wrapper's Python, so a
    call shorter than its launch overhead reads as host-bound time."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    fn()
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in pairs]


def in_turns(plain, kernel, reps: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain; the median per-call ms of each."""
    p = event_ms(plain, reps)
    k = event_ms(kernel, reps)
    k += event_ms(kernel, reps)
    p += event_ms(plain, reps)
    return statistics.median(k), statistics.median(p)


def device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, self device us, count) of each CUDA kernel a profile saw,
    busiest first."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def device_ms(fn, reps: int) -> float:
    """Device ms per call of fn: the kernel time of `reps` calls under the
    profiler, summed over every kernel fn launches, divided by reps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # Now and then the profiler loses device records, for a few passes in
    # a row: all of them, or some (seen on the H100: 10 calls, 0 or 8
    # records).  A pass counts only if every kernel kind was recorded a
    # whole number of times per call; otherwise it is taken again.
    for attempt in range(30):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = device_kernels(prof)
        if rows and all(count % reps == 0 for _, _, count in rows):
            return sum(us for _, us, _ in rows) / 1e3 / reps
        log("times", f"profiler pass {attempt + 1} lost device records "
                     f"({sum(count for _, _, count in rows)} kept of {reps} "
                     "calls); taken again")
        time.sleep(0.05)
    raise RuntimeError("the profiler lost device records in 30 passes")


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least ms the card could take: the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def touched_pixels(lvl: torch.Tensor, ys: torch.Tensor,
                   xs: torch.Tensor) -> int:
    """Distinct pyramid pixels that windows with level lvl [N] and level
    coordinates ys, xs [N, S] read with a nonzero bilinear weight."""
    def taps(c):
        f = torch.floor(c)
        a = f.long()
        return torch.cat([a, torch.where(c > f, a + 1, a)], dim=1)

    code = ((lvl.long()[:, None, None] * 4096 + taps(ys)[:, :, None]) * 4096
            + taps(xs)[:, None, :])
    return int(torch.unique(code).numel())


def fft_flops(s: int) -> float:
    """Operations of one real 2-D FFT of s x s points (2.5 N log2 N)."""
    n = s * s
    return 2.5 * n * math.log2(n)


def phase_roi(dev, frame_u8, boxes0):
    levels_u8 = roi_k.build_pyramid(frame_u8)
    gray = frame_u8.to(torch.float32) / 255.0
    levels_f32 = roi_k.build_pyramid(gray)
    hw = (HEIGHT, WIDTH)
    max_err = 0.0
    for pyr_name, levels in (("u8", levels_u8), ("f32", levels_f32)):
        for box_name, b in (("bench", boxes0),
                            ("edges", torch.as_tensor(edge_boxes(),
                                                      device=dev))):
            got = roi_k.extract_patches(None, b, 2.5, 64, levels=levels,
                                        frame_hw=hw)
            want = roi_k.extract_patches_ref(None, b, 2.5, 64, levels=levels,
                                             frame_hw=hw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lv = sorted(set(roi_k.sample_coords(b, 2.5, 64, hw)[0].tolist()))
            if not (err <= ROI_TOL and torch.isfinite(got).all().item()):
                raise AssertionError(f"ROI kernel {pyr_name}/{box_name}: max "
                                     f"|kernel - plain| {err} > {ROI_TOL}")
            max_err = max(max_err, err)
            log("roi", f"{pyr_name} pyramid, {box_name} boxes "
                       f"T={b.shape[0]} levels {lv}: max |kernel - plain| "
                       f"{err:.3g}")
    return levels_u8, levels_f32, max_err


def phase_roi3(dev, levels_u8, levels_f32, boxes0):
    hw = (HEIGHT, WIDTH)
    extra = torch.as_tensor(np.concatenate([edge_boxes(), STRADDLE]),
                            device=dev)
    max_err = 0.0
    for pyr_name, levels in (("u8", levels_u8), ("f32", levels_f32)):
        for box_name, b in (("bench", boxes0), ("edges+straddle", extra)):
            got = roi_k.extract_patches_scales(None, b, 2.5, 64, SCALES,
                                               levels=levels, frame_hw=hw)
            want = roi_k.extract_patches_scales_ref(
                None, b, 2.5, 64, SCALES, levels=levels, frame_hw=hw)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            lv = sorted(set(roi_k.sample_coords_scales(
                b, 2.5, 64, SCALES, hw)[0].tolist()))
            if not (got.shape == (3, b.shape[0], 64, 64) and err <= ROI_TOL
                    and torch.isfinite(got).all().item()):
                raise AssertionError(
                    f"3-scale ROI kernel {pyr_name}/{box_name}: shape "
                    f"{tuple(got.shape)}, max |kernel - plain| {err}")
            max_err = max(max_err, err)
            log("roi3", f"{pyr_name} pyramid, {box_name} boxes "
                        f"T={b.shape[0]} x 3 scales, levels {lv}: max "
                        f"|kernel - plain| {err:.3g}")
    return max_err


def phase_auction(dev, bench_benefits):
    rng = np.random.default_rng(1)
    cases = [(f"bench frame {i} n={b.shape[0]}", b, 2000)
             for i, b in enumerate(bench_benefits)]
    for n in (8, 40, 160):
        cost = torch.as_tensor(rng.uniform(0, 1, (n, n)).astype(np.float32),
                               device=dev)
        feas = torch.as_tensor(rng.random((n, n)) < 0.8, device=dev)
        cases.append((f"random n={n}", assignment.build_benefits(
            cost, feas, EPS), 2000))
    ones = torch.ones((160, 128), device=dev)
    cases.append(("all infeasible 160x128", assignment.build_benefits(
        ones, torch.zeros_like(ones, dtype=torch.bool), EPS), 2000))
    feas = torch.as_tensor(rng.random((128, 160)) < 0.1, device=dev)
    feas[::3] = False
    cases.append(("dead rows 128x160", assignment.build_benefits(
        torch.as_tensor(rng.uniform(0, 1, (128, 160)).astype(np.float32),
                        device=dev), feas, EPS), 2000))
    cases.append(("capped max_iters=3, random n=160",
                  cases[len(bench_benefits) + 2][1], 3))

    def random_b(n, grid=None):
        cost = rng.uniform(0, 1, (n, n))
        if grid:    # costs and benefits on a grid: many equal bids
            cost = np.round(cost * grid) / grid
        b = assignment.build_benefits(
            torch.as_tensor(cost.astype(np.float32), device=dev),
            torch.as_tensor(rng.random((n, n)) < 0.8, device=dev), EPS)
        return torch.round(b * grid) / grid if grid else b

    for n in (7, 33, 159, auction_k.max_n()):
        cases.append((f"random n={n} "
                      f"({auction_k.launch_info(n)['path']})",
                      random_b(n), 2000))
    for n in (40, 159, 160):
        cases.append((f"ties (grid 0.25) n={n}", random_b(n, 4), 2000))
    max_err = 0
    most_rounds = 0
    for name, b, max_iters in cases:
        col, it = auction_k.auction_solve(b, EPS, max_iters)
        want_col, want_it = auction_k.auction_solve_ref(b, EPS, max_iters)
        torch.cuda.synchronize()
        err = max(int((col - want_col).abs().max()),
                  abs(int(it) - int(want_it)))
        if not (torch.equal(col, want_col) and int(it) == int(want_it)):
            raise AssertionError(f"auction kernel {name}: col_of/iters differ "
                                 f"from the plain version ({int(it)} vs "
                                 f"{int(want_it)} rounds)")
        max_err = max(max_err, err)
        most_rounds = max(most_rounds, int(it))
        log("auction", f"{name}: col_of and iters ({int(it)}) exactly equal, "
                       f"{int((col < 0).sum())} unassigned rows")
    if most_rounds < 50:
        raise AssertionError("auction: no case needed 50 rounds (most: "
                             f"{most_rounds})")
    return max_err


def record_benefits(frames, d, v, cfg, n_frames: int):
    """Benefit matrices the bench run hands the auction on its first
    frames (captured by wrapping the solve; not a counted run)."""
    seen = []
    solve = auction_k.auction_solve

    def capture(b, eps, max_iters):
        seen.append(b.clone())
        return solve(b, eps, max_iters)

    auction_k.auction_solve = capture
    try:
        scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                          frames[:n_frames], d[:n_frames], v[:n_frames], cfg)
    finally:
        auction_k.auction_solve = solve
    return seen


def record_kcf_inputs(frames, d, v, cfg, n_frames: int):
    """The inputs an HF run hands the fused detect and train on its first
    frames (captured by wrapping the wrappers; not a counted run): the last
    frame's (model, feat) for detect and (model, feat, yf, lr) for train."""
    seen = {}
    detect, train = kcf_k.detect_fused, kcf_k.train_fused

    def cap_detect(model, feat, sigma):
        seen["detect"] = (kcf_ops.KCFModel(*[x.clone() for x in model]),
                          feat.clone())
        return detect(model, feat, sigma)

    def cap_train(model, feat, yf, sigma, lambda_, lr):
        seen["train"] = (kcf_ops.KCFModel(*[x.clone() for x in model]),
                         feat.clone(), yf.clone(), lr.clone())
        return train(model, feat, yf, sigma, lambda_, lr)

    kcf_k.detect_fused, kcf_k.train_fused = cap_detect, cap_train
    try:
        scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                          frames[:n_frames], d[:n_frames], v[:n_frames], cfg)
    finally:
        kcf_k.detect_fused, kcf_k.train_fused = detect, train
    return seen


def rel_err(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def gray_kcf_inputs(frames, boxes0, cfg):
    """Gray-shape (S=64, C=1, T=128) inputs: a bank trained on frame 0's
    bench windows, features of frame 1 at the same boxes."""
    dev = frames.device
    s = cfg.kcf.feature_size
    yf = kcf_ops.make_yf(s, cfg.kcf.padding, cfg.kcf.output_sigma_factor,
                         device=dev)
    feats = [feat_ops.extract_features(roi_k.extract_patches_ref(
        frames[f], boxes0, cfg.kcf.padding, cfg.kcf.template_size),
        cfg.kcf).contiguous() for f in (0, 1)]
    model = kcf_ops.KCFModel(*[x.contiguous() for x in kcf_ops.train(
        feats[0], yf, cfg.kcf.kernel_sigma, cfg.kcf.lambda_)])
    lr = torch.tensor([1.0, 0.075, 0.0, 0.5], device=dev).repeat(
        boxes0.shape[0] // 4)
    return model, feats[1], yf, lr


def phase_kcf(hf_inputs, gray_inputs, cfg_hf, cfg):
    errs = {"response": 0.0, "xf": 0.0, "alphaf": 0.0}
    model, feat = hf_inputs["detect"]
    cases = [("HF", cfg_hf, model, feat, *hf_inputs["train"]),
             ("gray", cfg, gray_inputs[0], gray_inputs[1], gray_inputs[0],
              gray_inputs[1], *gray_inputs[2:])]
    for name, c, d_model, d_feat, t_model, t_feat, yf, lr in cases:
        sigma, lam = c.kcf.kernel_sigma, c.kcf.lambda_
        got = kcf_k.detect_fused(d_model, d_feat, sigma)
        want = kcf_k.detect_fused_ref(d_model, d_feat, sigma)
        new = kcf_k.train_fused(t_model, t_feat, yf, sigma, lam, lr)
        new_ref = kcf_k.train_fused_ref(t_model, t_feat, yf, sigma, lam, lr)
        torch.cuda.synchronize()
        e = {"response": rel_err(got, want), "xf": rel_err(new.xf,
                                                           new_ref.xf),
             "alphaf": rel_err(new.alphaf, new_ref.alphaf)}
        ok = all(torch.isfinite(x).all().item()
                 for x in (got, new.xf, new.alphaf))
        log("kcf", f"{name}: detect feat {tuple(d_feat.shape)} vs model "
                   f"{tuple(d_model.xf.shape)}, train feat "
                   f"{tuple(t_feat.shape)}; largest error relative to the "
                   f"largest magnitude: response {e['response']:.3g}, xf "
                   f"{e['xf']:.3g}, alphaf {e['alphaf']:.3g}")
        for k, tol in KCF_TOL.items():
            if not (ok and e[k] <= tol):
                raise AssertionError(f"fused KCF {name}: {k} relative error "
                                     f"{e[k]} > {tol} (finite: {ok})")
            errs[k] = max(errs[k], e[k])

    # K4 alone: a shape with no specialised path, and run-to-run equality.
    dev = feat.device
    rng = np.random.default_rng(2)
    c, s, t = 3, 12, 128
    feats = [torch.as_tensor(
        rng.standard_normal((n, c, s, s)).astype(np.float32) * 0.3,
        device=dev) for n in (t, 2 * t)]
    yf = kcf_ops.make_yf(s, cfg.kcf.padding, cfg.kcf.output_sigma_factor,
                         device=dev)
    small = kcf_ops.KCFModel(*[x.contiguous() for x in kcf_ops.train(
        feats[0], yf, cfg.kcf.kernel_sigma, cfg.kcf.lambda_)])
    for name, m, f in (("generic", small, feats[1]), ("HF", model, feat)):
        path = kcf_k.detect_launch_info(f.shape[1], f.shape[2])["path"]
        got = kcf_k.detect_fused(m, f, cfg.kcf.kernel_sigma)
        again = kcf_k.detect_fused(m, f, cfg.kcf.kernel_sigma)
        want = kcf_k.detect_fused_ref(m, f, cfg.kcf.kernel_sigma)
        torch.cuda.synchronize()
        e = rel_err(got, want)
        same = torch.equal(got, again)
        log("kcf", f"{name}: detect feat {tuple(f.shape)} by {path}: "
                   f"response error {e:.3g}; two runs bit-equal: {same}")
        if not (e <= KCF_TOL["response"] and same
                and torch.isfinite(got).all().item()):
            raise AssertionError(f"fused KCF detect {name}: error {e}, "
                                 f"bit-equal {same}")
        errs["response"] = max(errs["response"], e)
    return errs


def tracks_of(out, n_frames):
    ids = out.ids.cpu().numpy()
    boxes = out.boxes.cpu().numpy()
    valid = out.valid.cpu().numpy()
    return [(ids[f, valid[f]], boxes[f, valid[f]]) for f in range(n_frames)]


def score(out, gt_boxes, vis):
    hyp = tracks_of(out, N_FRAMES)
    gt = [(np.where(vis[f])[0], gt_boxes[f, np.where(vis[f])[0]])
          for f in range(N_FRAMES)]
    return hyp, metrics.clear_mot(gt, hyp)["mota"], metrics.hota(gt, hyp)


def counted_run(frames, d, v, cfg):
    """run_sequence with every launch count set to 0 just before it and
    read just after."""
    reset_counts()
    t0 = time.perf_counter()
    _, out = scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                               frames, d, v, cfg)
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0


def check_output(out, cfg, what):
    boxes_np = out.boxes.cpu().numpy()
    if boxes_np.shape != (N_FRAMES, cfg.max_tracks, 4) or not np.isfinite(
            boxes_np).all():
        raise AssertionError(f"{what}: bad output boxes {boxes_np.shape}")


def phase_e2e(frames, d, v, cfg, gt_boxes, vis, dets_list, frames_np):
    out, launches, wall = counted_run(frames, d, v, cfg)
    log("e2e", f"run_sequence {N_FRAMES} frames in {wall:.3f} s (first run); "
               f"kernel launches {launches}")
    want = {k: 0 for k in KERNELS}
    want.update(roi_extract=N_FRAMES, auction_solve=N_FRAMES)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    check_output(out, cfg, "e2e")
    iters = out.assign_iters.cpu().numpy().astype(int).tolist()
    log("e2e", f"auction rounds per frame over {N_FRAMES} frames: min "
               f"{min(iters)}, median {statistics.median(iters)}, max "
               f"{max(iters)} (frame 0: {iters[0]})")
    hyp, mota, h_all = score(out, gt_boxes, vis)
    log("e2e", f"MOTA {mota} (JAX reference {M_REF}), HOTA "
               f"{h_all['hota']} (JAX reference {HOTA_REF}), DetA "
               f"{h_all['deta']}, AssA {h_all['assa']}, LocA {h_all['loca']}")
    if not mota >= M_REF - 0.01:
        raise AssertionError(f"MOTA {mota} < {M_REF} - 0.01")

    # The public API on the same fixture: init + 4 updates.
    mt = api.MultiTracker(cfg, device=frames.device)
    got = [mt.init(frames_np[0], dets_list[0])]
    got += [mt.update(frames_np[f], dets_list[f]) for f in range(1, 5)]
    for f, tracks in enumerate(got):
        ids, boxes = hyp[f]
        t_ids = [t[0] for t in tracks]
        t_boxes = np.array([t[1] for t in tracks], np.float32).reshape(-1, 4)
        if t_ids != ids.tolist() or not np.allclose(t_boxes, boxes, rtol=0,
                                                    atol=1e-4):
            raise AssertionError(f"MultiTracker frame {f} differs from "
                                 "run_sequence")
    log("e2e", f"MultiTracker init + 4 updates: confirmed ids and boxes equal"
               f" run_sequence's on frames 0-4 ({len(got[-1])} tracks)")
    return launches, float(mota), h_all


def phase_e2e_heavy(frames, d, v, cfg, gt_boxes, vis):
    dump = np.load(HEAVY_DUMP)
    launches = {}
    for name in HEAVY:
        hcfg = heavy_config(cfg, name)
        out, counts, wall = counted_run(frames, d, v, hcfg)
        want = {k: 0 for k in KERNELS}
        want.update(roi_extract_scales=N_FRAMES, auction_solve=N_FRAMES)
        if name == "HF":
            want.update(roi_extract=N_FRAMES, kcf_detect=N_FRAMES,
                        kcf_train=N_FRAMES)
        log("e2e-heavy", f"{name}: run_sequence {N_FRAMES} frames in "
                         f"{wall:.3f} s (first run); kernel launches "
                         f"{counts}")
        if counts != want:
            raise AssertionError(f"{name}: expected launches {want}, got "
                                 f"{counts}")
        check_output(out, hcfg, f"e2e-heavy {name}")
        _, mota, h_all = score(out, gt_boxes, vis)
        log("e2e-heavy", f"{name}: MOTA {mota} (JAX reference {M_REF}), "
                         f"HOTA {h_all['hota']}, DetA {h_all['deta']}, AssA "
                         f"{h_all['assa']}, LocA {h_all['loca']}")
        if not mota >= M_REF - 0.01:
            raise AssertionError(f"{name}: MOTA {mota} < {M_REF} - 0.01")
        key = name.lower()
        ids = out.ids.cpu().numpy()
        valid = out.valid.cpu().numpy()
        boxes = out.boxes.cpu().numpy()
        same = [bool(np.array_equal(ids[f], dump[f"{key}_ids"][f])
                     and np.array_equal(valid[f], dump[f"{key}_valid"][f]))
                for f in range(N_FRAMES)]
        both = valid & dump[f"{key}_valid"]
        box_diff = float(np.abs(boxes - dump[f"{key}_boxes"])[both].max())
        first = same.index(False) if not all(same) else None
        log("e2e-heavy", f"{name}: against the JAX run's dump, ids and valid "
                         f"equal on {sum(same)}/{N_FRAMES} frames (first "
                         f"differing frame: {first}); largest box "
                         f"difference on slots valid in both {box_diff:.3g}")
        if first is not None:
            slots = np.where((ids[first] != dump[f"{key}_ids"][first])
                             | (valid[first]
                                != dump[f"{key}_valid"][first]))[0]
            log("e2e-heavy", f"{name}: frame {first} differs at slots "
                             f"{slots.tolist()}")
        launches[name] = counts
    return launches


def timed_runs(frames, d, v, cfg, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan.run_sequence(bank_mod.empty_bank(cfg, device=frames.device),
                          frames, d, v, cfg)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def kernel_line(name: str, info: dict) -> str:
    return (f"{name} launches: path {info['path']}; {info['threads']} "
            f"threads per CTA, {info['registers']} registers per thread, "
            f"{info['smem_bytes']} bytes of shared memory per CTA, "
            f"{info['ctas_per_sm']} CTAs fit on an SM")


def phase_times(frames, d, v, cfg, levels_u8, boxes0, bench_bs, hf_inputs):
    bench_b = bench_bs[-1]          # steady state; bench_bs[0]: init frame
    for name, c, reps in (("default", cfg, 5),
                          ("H", heavy_config(cfg, "H"), 3),
                          ("HF", heavy_config(cfg, "HF"), 3)):
        runs = timed_runs(frames, d, v, c, reps)
        med = statistics.median(runs)
        log("times", f"run_sequence {name}: {N_FRAMES / med:.1f} frames/s, "
                     f"{1000 * med / N_FRAMES:.3f} ms/frame (median of "
                     f"{[round(r, 4) for r in runs]} s per {N_FRAMES} "
                     "frames)")
    hw = (HEIGHT, WIDTH)
    t = boxes0.shape[0]
    s1 = cfg.kcf.template_size
    coords = roi_k.sample_coords(boxes0, 2.5, s1, hw)
    coords3 = roi_k.sample_coords_scales(boxes0, 2.5, s1, SCALES, hw)
    rounds = int(auction_k.auction_solve(bench_b, EPS, 2000)[1])
    n = bench_b.shape[0]
    d_model, d_feat = hf_inputs["detect"]
    t_model, t_feat, yf, lr = hf_inputs["train"]
    hcfg = heavy_config(cfg, "HF")
    sigma, lam = hcfg.kcf.kernel_sigma, hcfg.kcf.lambda_
    ni, c, s, _ = d_feat.shape
    sf = s // 2 + 1
    nt = t_model.xf.shape[0]
    lvl3 = coords3[0].repeat(3)
    bounds = {
        # outputs + coordinates + the pixels read with nonzero weight
        "roi_extract": bound(
            t * s1 * s1 * 4 + t * (3 + 2 * s1) * 4
            + touched_pixels(*coords[0:1], *coords[3:5]), 10 * t * s1 * s1),
        "roi_extract_scales": bound(
            3 * t * s1 * s1 * 4 + t * 3 * 4 + 3 * t * 2 * s1 * 4
            + touched_pixels(lvl3, coords3[3].reshape(3 * t, s1),
                             coords3[4].reshape(3 * t, s1)),
            30 * t * s1 * s1),
        # the benefit matrix in, col_of and iters out; ~4 n^2 per round
        "auction_solve": bound(n * n * 4 + n * 4 + 4, rounds * 4 * n * n),
        # features, the model rows, the response; FFT-based operations
        "kcf_detect": bound(
            ni * c * s * s * 4 + nt * (c + 1) * s * sf * 8 + ni * s * s * 4,
            ni * (c * fft_flops(s) + 8 * c * s * sf + 3 * fft_flops(s)
                  + 10 * s * s + 6 * s * sf)),
        "kcf_train": bound(
            nt * c * s * s * 4 + 2 * nt * (c + 1) * s * sf * 8
            + s * sf * 8 + nt * 4,
            nt * (c * fft_flops(s) + 8 * c * s * sf + 2 * fft_flops(s)
                  + 10 * s * s + 16 * s * sf)),
    }
    pairs = {
        "roi_extract": (f"K1 ROI resample T={t} u8 1080p",
                        lambda: roi_k._resample_ref(levels_u8, hw, *coords),
                        lambda: roi_k._resample_cuda(levels_u8, hw, *coords),
                        50),
        "roi_extract_scales": (
            f"K3 3-scale ROI resample T={t} x 3 u8 1080p",
            lambda: roi_k._resample_scales_ref(levels_u8, hw, *coords3),
            lambda: roi_k._resample_scales_cuda(levels_u8, hw, *coords3),
            50),
        "auction_solve": (
            f"K2 auction n={n} (bench frame 2, {rounds} rounds)",
            lambda: auction_k.auction_solve_ref(bench_b, EPS, 2000),
            lambda: auction_k.auction_solve(bench_b, EPS, 2000), 10),
        "kcf_detect": (
            f"K4 fused detect feat {tuple(d_feat.shape)} (HF frame 2)",
            lambda: kcf_k.detect_fused_ref(d_model, d_feat, sigma),
            lambda: kcf_k.detect_fused(d_model, d_feat, sigma), 50),
        "kcf_train": (
            f"K5 fused train feat {tuple(t_feat.shape)} (HF frame 2)",
            lambda: kcf_k.train_fused_ref(t_model, t_feat, yf, sigma, lam,
                                          lr),
            lambda: kcf_k.train_fused(t_model, t_feat, yf, sigma, lam, lr),
            50),
    }
    times = {}
    for key, (what, plain, kernel, reps) in pairs.items():
        ms, plain_ms = in_turns(plain, kernel, reps)
        dev_ms, plain_dev_ms = device_ms(kernel, reps), device_ms(plain, reps)
        b_ms, b_by = bounds[key]
        times[key] = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                      "plain_device_ms": plain_dev_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None}
        log("times", f"{what}: per call (median of CUDA event pairs, host "
                     f"launch time included) kernel {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms; device time per call (profiler) "
                     f"kernel {dev_ms:.4f} ms, plain {plain_dev_ms:.4f} ms; "
                     f"bound {b_ms:.5f} ms ({b_by})")

    # K2 by rounds: the init frame's matrix, and solves capped at 0 rounds
    # (launch and staging alone) and at half the rounds.
    init_b = bench_bs[0]
    init_rounds = int(auction_k.auction_solve(init_b, EPS, 2000)[1])
    extra = {"rounds": rounds, "init_frame_rounds": init_rounds}
    for key, what, b, cap in (
            ("init_frame_device_ms",
             f"init frame's matrix, {init_rounds} rounds", init_b, 2000),
            ("half_rounds_device_ms",
             f"bench frame 2 capped at {rounds // 2} rounds", bench_b,
             rounds // 2),
            ("no_rounds_device_ms",
             "capped at 0 rounds: launch and staging", bench_b, 0)):
        extra[key] = device_ms(
            lambda: auction_k.auction_solve(b, EPS, cap), 10)
        log("times", f"K2 auction n={b.shape[0]}, {what}: device time per "
                     f"call (profiler) {extra[key]:.4f} ms")
    per_round = ((times["auction_solve"]["device_ms"]
                  - extra["no_rounds_device_ms"]) / rounds)
    log("times", f"K2 per round at n={n}: {1000 * per_round:.2f} us "
                 f"((device time at {rounds} rounds - at 0 rounds) / "
                 f"{rounds})")
    times["auction_solve"].update(extra)
    k2, k4 = auction_k.launch_info(n), kcf_k.detect_launch_info(c, s)
    log("times", kernel_line(f"K2 auction n={n}", k2))
    log("times", kernel_line(f"K4 fused detect C={c} S={s}", k4))
    times["auction_solve"]["launch"] = k2
    times["kcf_detect"]["launch"] = k4
    return times


OUR_KERNELS = ("roi_kernel", "roi_scales_kernel", "auction_kernel",
               "kcf_detect_kernel", "kcf_detect_fft16_kernel",
               "kcf_train_kernel")


def phase_profile(frames, d, v, cfg, name, n_frames: int = 16):
    """Device time by kernel over a short run_sequence window."""
    from torch.profiler import ProfilerActivity, profile

    dev = frames.device
    bank = bank_mod.empty_bank(cfg, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scan.run_sequence(bank, frames[:n_frames], d[:n_frames],
                          v[:n_frames], cfg)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = device_kernels(prof)
    busy = sum(r[1] for r in kernels)
    ours = {k: sum(us for key, us, _ in kernels if k in key)
            for k in OUR_KERNELS}
    ours_txt = ", ".join(f"{k} {us / 1e3:.3f} ms" for k, us in ours.items()
                         if us > 0)
    log("profile", f"{name}, {n_frames} frames: device kernels "
                   f"{busy / 1e3:.3f} ms of {wall_us / 1e3:.3f} ms wall under "
                   f"the profiler ({100 * busy / wall_us:.1f}% busy), "
                   f"{len(kernels)} kernel kinds; {ours_txt}")
    for key, us, count in kernels[:12]:
        log("profile", f"  {us / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")


def main() -> int:
    # device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke test runs only on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    card = card_line()
    log("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {card}; "
                  f"torch {torch.__version__} CUDA {torch.version.cuda}")

    # build
    path, secs, out = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in out.splitlines()
             if "registers" in ln or "Compiling entry" in ln
             or "bytes smem" in ln or "spill" in ln]
    log("build", f"{path.name}: nvcc {secs:.1f} s; ptxas: "
                 f"{' | '.join(ptxas) or 'reused build'}")

    t0 = time.perf_counter()
    frames_np, d_np, v_np, gt_boxes, vis, dets_list, cfg = bench_fixture()
    frames = torch.as_tensor(frames_np, device=dev)
    d = torch.as_tensor(d_np, device=dev)
    v = torch.as_tensor(v_np, device=dev)
    log("data", f"bench fixture {frames_np.shape} u8 rendered and uploaded in "
                f"{time.perf_counter() - t0:.1f} s")

    # kernels against their plain versions
    boxes0 = torch.as_tensor(gt_boxes[0], device=dev)
    levels_u8, levels_f32, roi_err = phase_roi(dev, frames[0], boxes0)
    roi3_err = phase_roi3(dev, levels_u8, levels_f32, boxes0)
    bench_b = record_benefits(frames, d, v, cfg, 3)
    auction_err = phase_auction(dev, bench_b)
    cfg_hf = heavy_config(cfg, "HF")
    hf_inputs = record_kcf_inputs(frames, d, v, cfg_hf, 3)
    kcf_err = phase_kcf(hf_inputs, gray_kcf_inputs(frames, boxes0, cfg),
                        cfg_hf, cfg)

    # end to end: default, then the heavy modes
    launches, mota, h_all = phase_e2e(frames, d, v, cfg, gt_boxes, vis,
                                      dets_list, frames_np)
    heavy_launches = phase_e2e_heavy(frames, d, v, cfg, gt_boxes, vis)

    # times
    times = phase_times(frames, d, v, cfg, levels_u8, boxes0, bench_b,
                        hf_inputs)
    phase_profile(frames, d, v, cfg, "default")
    phase_profile(frames, d, v, cfg_hf, "HF")

    hf = heavy_launches["HF"]
    rows = [
        ("roi_extract", "tpu_mot_torch/csrc/roi.cu",
         "tpu_mot/kernels/roi.py:465", launches["roi_extract"], roi_err, {}),
        ("roi_extract_scales", "tpu_mot_torch/csrc/roi.cu",
         "tpu_mot/kernels/roi.py:346", hf["roi_extract_scales"], roi3_err,
         {}),
        ("auction_solve", "tpu_mot_torch/csrc/auction.cu",
         "tpu_mot/kernels/auction.py:107", launches["auction_solve"],
         auction_err, {"err_kind": "col_of and iters"}),
        ("kcf_detect", "tpu_mot_torch/csrc/kcf.cu",
         "tpu_mot/kernels/kcf.py:260", hf["kcf_detect"],
         kcf_err["response"],
         {"err_kind": "relative to the largest |response|"}),
        ("kcf_train", "tpu_mot_torch/csrc/kcf.cu",
         "tpu_mot/kernels/kcf.py:295", hf["kcf_train"],
         max(kcf_err["xf"], kcf_err["alphaf"]),
         {"err_kind": "relative to the largest |xf| and |alphaf|",
          "rel_err_xf": kcf_err["xf"], "rel_err_alphaf": kcf_err["alphaf"]}),
    ]
    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": err, **times[name], **extra}
        for name, src, rep, n, err, extra in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
