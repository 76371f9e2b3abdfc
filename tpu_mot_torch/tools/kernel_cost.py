"""Costs of the redesigned kernels' launches on one CUDA card: the auction
kernel (K2) by rounds, and the host cost of the K2, K4 and K5 wrappers.

    python -m tpu_mot_torch.tools.kernel_cost [n]

1. Solves one seeded MOT-shaped benefit matrix (128 tracks x n detections,
   100 jittered matches, the rest clutter; n = 160 by default) capped at
   0, 1, 2, ... rounds up to its full solve, and prints the profiler's
   device time per call at each cap: the time at 0 rounds is launch and
   staging alone, the differences are the rounds.
2. Calls `auction_solve` (that matrix), `detect_fused` ([384, 31, 16, 16]
   against 128 model rows) and `train_fused` ([128, 31, 16, 16]) 2000
   times each, back to back on seeded random inputs, and prints the wall
   time per call with one synchronise at the end.  Where a call's host work
   (argument checks, ctypes, the launch) takes longer than its kernel, the
   stream runs dry between launches and this is the wrapper's host cost;
   the device time per call is printed beside it to tell the cases apart.

It uses only the wrappers' public signatures, so it times whichever
tpu_mot_torch package is first on the path: run it by path with PYTHONPATH
set to another checkout to time that one.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpu_mot_torch.kernels import auction, kcf
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
    for a few passes in a row; a pass counts only if every kernel kind was
    recorded a whole number of times per call."""
    fn()
    torch.cuda.synchronize()
    for _ in range(30):
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


def wrappers_part(b: torch.Tensor, eps: float) -> None:
    dev = b.device
    rng = np.random.default_rng(0)
    t, c, s = 128, 31, 16

    def features(n):
        return torch.as_tensor(
            rng.standard_normal((n, c, s, s)).astype(np.float32) * 0.3,
            device=dev)

    yf = kcf_ops.make_yf(s, 2.5, 0.125, device=dev)
    model = kcf_ops.KCFModel(*[x.contiguous() for x in kcf_ops.train(
        features(t), yf, 0.2, 1e-4)])
    feat3, feat1 = features(3 * t), features(t)
    lr = torch.full((t,), 0.075, device=dev)
    for name, fn in (
            (f"auction_solve n={b.shape[0]}",
             lambda: auction.auction_solve(b, eps, 2000)),
            ("detect_fused [384, 31, 16, 16]",
             lambda: kcf.detect_fused(model, feat3, 0.2)),
            ("train_fused [128, 31, 16, 16]",
             lambda: kcf.train_fused(model, feat1, yf, 0.2, 1e-4, lr))):
        runs = wall_us(fn)
        print(f"{name}: {statistics.median(runs):.2f} us per call back to "
              f"back (median of {[round(r, 2) for r in runs]}); device "
              f"{1000 * device_ms(fn):.2f} us per call")


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
    return 0


if __name__ == "__main__":
    sys.exit(main())
