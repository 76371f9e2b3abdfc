"""Costs of the redesigned kernels' launches on one CUDA card: the auction
kernel (K2) by rounds, the host cost of the K1-K5 wrappers, and the ROI
kernels (K1, K3) and the fused train kernel (K5) by size.

    python -m tpu_mot_torch.tools.kernel_cost [n]

1. Solves one seeded MOT-shaped benefit matrix (128 tracks x n detections,
   100 jittered matches, the rest clutter; n = 160 by default) capped at
   0, 1, 2, ... rounds up to its full solve, and prints the profiler's
   device time per call at each cap: the time at 0 rounds is launch and
   staging alone, the differences are the rounds.
2. Calls `auction_solve` (that matrix), the ROI resample and the 3-scale
   ROI resample (128 seeded boxes of 24-64 px, x 3 scales for K3, on a
   seeded 1080p u8 pyramid, S = 64; the resample wrappers alone, their
   coordinates made once),
   `detect_fused` ([384, 31, 16, 16] against 128 model rows) and
   `train_fused` ([128, 31, 16, 16]) 2000 times each, back to back on
   seeded random inputs, and prints the wall
   time per call with one synchronise at the end.  Where a call's host work
   (argument checks, ctypes, the launch) takes longer than its kernel, the
   stream runs dry between launches and this is the wrapper's host cost;
   the device time per call is printed beside it to tell the cases apart.

3. Runs K1 at 43, 128 and 384 rows (384: 128 boxes x 3 per-track scales,
   the single-object bank's 3-scale search), K3 at 43, 128 and 384 tracks
   x 3 scales and K5 at 32, 128, 264 and 396 tracks (one CTA per track:
   128 is under one CTA per SM, 396 three) and prints the profiler's
   device time per call: a time that does not grow with the size is launch
   and the latency of one CTA's chain, the growth is throughput.  Where the
   package has them, K1's variants with a thread owning 4, 2 and 1 output
   rows (128, 256 and 512 CTAs at 128 rows) are timed in turns at 128 and
   384 rows.

It uses only the wrappers' signatures, so it times whichever
tpu_mot_torch package is first on the path: run it by path with PYTHONPATH
set to another checkout to time that one.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpu_mot_torch.kernels import auction, kcf, roi
from tpu_mot_torch.ops import assignment, iou
from tpu_mot_torch.ops import kcf as kcf_ops

REPS = 20           # profiled calls per device time
CALLS = 2000        # back-to-back calls per wall time
REPEATS = 5


def benefits(n_det: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(7)
    tracks = rng.uniform(50, 1800, (128, 4)).astype(np.float32)
    tracks[:, 1] = rng.uniform(50, 1000, 128)
    tracks[:, 2:] = rng.uniform(24, 64, (128, 2))
    dets = np.concatenate([
        tracks[:100] + rng.normal(0, 3, (100, 4)),
        rng.uniform(50, 1000, (n_det - 100, 4))]).astype(np.float32)
    cost = iou.association_cost(
        torch.as_tensor(tracks, device=dev), torch.as_tensor(dets, device=dev),
        torch.ones(128, dtype=torch.bool, device=dev),
        torch.ones(n_det, dtype=torch.bool, device=dev), 0.1, 1e4)
    return assignment.build_benefits(cost, cost < 1e3,
                                     assignment.DEFAULT_EPS)


def device_ms(fn) -> float:
    """Device ms per call from the profiler.  It now and then loses records
    for some passes in a row; a pass counts only if every kernel kind was
    recorded a whole number of times per call, or, after ten passes, if it
    lost under a tenth of each kind's records (a kind's time per call is
    then its mean recorded time times its launches per call)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(30):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        if rows and all(e.count % REPS == 0 for e in rows):
            return sum(e.self_device_time_total for e in rows) / 1e3 / REPS
        per_call = [math.ceil(e.count / REPS) for e in rows]
        if attempt >= 10 and rows and all(
                e.count >= 0.9 * n * REPS for e, n in zip(rows, per_call)):
            return sum(e.self_device_time_total / e.count * n
                       for e, n in zip(rows, per_call)) / 1e3
        time.sleep(0.05)
    raise RuntimeError("the profiler lost device records in 30 passes")


def wall_us(fn) -> list[float]:
    """Wall microseconds per call of CALLS back-to-back calls, REPEATS
    times."""
    out = []
    for _ in range(REPEATS):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / CALLS * 1e6)
    return out


def rounds_part(b: torch.Tensor, eps: float) -> None:
    rounds = int(auction.auction_solve(b, eps, 2000)[1])
    print(f"n = {b.shape[0]}, full solve {rounds} rounds")
    last = None
    for cap in range(rounds + 1):
        ms = device_ms(lambda: auction.auction_solve(b, eps, cap))
        step = "" if last is None else f"  (+{1000 * (ms - last):.2f} us)"
        print(f"capped at {cap:2d} rounds: {ms:.4f} ms per call{step}")
        last = ms


HW = (1080, 1920)
C, S = 31, 16       # fHOG-31 at cell size 4 on a 64 x 64 template


def kcf_inputs(rng, t: int, dev):
    """A trained bank of t rows, fresh features [3t, ...] and [t, ...], yf
    and a per-track learning rate."""
    def features(n):
        return torch.as_tensor(
            rng.standard_normal((n, C, S, S)).astype(np.float32) * 0.3,
            device=dev)

    yf = kcf_ops.make_yf(S, 2.5, 0.125, device=dev)
    model = kcf_ops.KCFModel(*[x.contiguous() for x in kcf_ops.train(
        features(t), yf, 0.2, 1e-4)])
    return (model, features(3 * t), features(t), yf,
            torch.full((t,), 0.075, device=dev))


SCALES = (1 / 1.05, 1.0, 1.05)


def roi_inputs(rng, t: int, dev):
    """A seeded 1080p u8 pyramid and t boxes of 24-64 px."""
    levels = roi.build_pyramid(torch.as_tensor(
        rng.integers(0, 256, HW, dtype=np.uint8), device=dev))
    boxes = torch.as_tensor(np.stack(
        [rng.uniform(0, HW[1], t), rng.uniform(0, HW[0], t),
         rng.uniform(24, 64, t), rng.uniform(24, 64, t)],
        axis=1).astype(np.float32), device=dev)
    return levels, boxes


def coords_scales(boxes):
    """K3's coordinates of the boxes at the three scales."""
    return roi.sample_coords_scales(boxes, 2.5, 64, SCALES, HW)


def coords_rows(boxes, three: bool = False):
    """K1's coordinates: one row per box, or (three) the boxes x 3
    per-track scales, scale-major, as the single-object bank asks."""
    if not three:
        return roi.sample_coords(boxes, 2.5, 64, HW)
    scales = torch.tensor(SCALES, device=boxes.device).repeat_interleave(
        boxes.shape[0])
    return roi.sample_coords(boxes.repeat(3, 1), 2.5, 64, HW, scales)


def wrappers_part(b: torch.Tensor, eps: float) -> None:
    dev = b.device
    rng = np.random.default_rng(0)
    t = 128
    model, feat3, feat1, yf, lr = kcf_inputs(rng, t, dev)
    levels, boxes = roi_inputs(rng, t, dev)
    coords, coords1 = coords_scales(boxes), coords_rows(boxes)
    for name, fn in (
            (f"auction_solve n={b.shape[0]}",
             lambda: auction.auction_solve(b, eps, 2000)),
            (f"ROI resample [{t}, 64, 64] u8 1080p",
             lambda: roi._resample_cuda(levels, HW, *coords1)),
            (f"3-scale ROI resample [3, {t}, 64, 64] u8 1080p",
             lambda: roi._resample_scales_cuda(levels, HW, *coords)),
            (f"detect_fused [{3 * t}, {C}, {S}, {S}]",
             lambda: kcf.detect_fused(model, feat3, 0.2)),
            (f"train_fused [{t}, {C}, {S}, {S}]",
             lambda: kcf.train_fused(model, feat1, yf, 0.2, 1e-4, lr))):
        runs = wall_us(fn)
        print(f"{name}: {statistics.median(runs):.2f} us per call back to "
              f"back (median of {[round(r, 2) for r in runs]}); device "
              f"{1000 * device_ms(fn):.2f} us per call")


def sizes_part(dev) -> None:
    rng = np.random.default_rng(1)
    for t in (43, 128, 384):
        levels, boxes = roi_inputs(rng, t, dev)
        coords = coords_scales(boxes)
        ms = device_ms(lambda: roi._resample_scales_cuda(levels, HW,
                                                         *coords))
        print(f"3-scale ROI resample [3, {t}, 64, 64]: device "
              f"{1000 * ms:.2f} us per call")
    levels, boxes = roi_inputs(rng, 128, dev)
    rows = {43: coords_rows(boxes[:43]), 128: coords_rows(boxes),
            384: coords_rows(boxes, three=True)}
    for t, coords in rows.items():
        ms = device_ms(lambda: roi._resample_cuda(levels, HW, *coords))
        print(f"ROI resample [{t}, 64, 64]: device {1000 * ms:.2f} us per "
              "call")
    # A package whose K1 has one variant has no launch_info.
    for t in (128, 384) if hasattr(roi, "launch_info") else ():
        # 4, 2, 1, 1, 2, 4: each variant in two turns.
        times = {r: [] for r in (4, 2, 1)}
        for r in (4, 2, 1, 1, 2, 4):
            times[r].append(1000 * device_ms(lambda: roi._resample_cuda(
                levels, HW, *rows[t], rows_per_thread=r)))
        print(f"ROI resample [{t}, 64, 64] by rows per thread: " + "; ".join(
            f"{r} rows ({t * 4 // r} CTAs) "
            f"{' and '.join(f'{x:.2f}' for x in ts)} us"
            for r, ts in times.items()))
    if hasattr(roi, "launch_info"):
        print(f"ROI resample as the library launches it: "
              f"{roi.launch_info(True, 64)}")
    if hasattr(roi, "scales_launch_info"):
        print(f"3-scale ROI resample as the library launches it: "
              f"{roi.scales_launch_info(True, 64)}")
    for t in (32, 128, 264, 396):
        model, _, feat, yf, lr = kcf_inputs(rng, t, dev)
        ms = device_ms(lambda: kcf.train_fused(model, feat, yf, 0.2, 1e-4,
                                               lr))
        print(f"train_fused [{t}, {C}, {S}, {S}]: device {1000 * ms:.2f} us "
              "per call")


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_cost: needs a CUDA card", file=sys.stderr)
        return 1
    n_det = int(sys.argv[1]) if len(sys.argv) > 1 else 160
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"package: {auction.__file__}")
    b = benefits(n_det, torch.device("cuda:0"))
    rounds_part(b, assignment.DEFAULT_EPS)
    wrappers_part(b, assignment.DEFAULT_EPS)
    sizes_part(b.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
