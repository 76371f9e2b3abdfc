"""The port's twin of the repo's `tools/bench_hard_fixture.py`: tracking
accuracy under detector dropouts, false positives and jitter at the bench
scale (1080p, 128 objects), the accuracy fixture that is not saturated, on
the CUDA card.

    python -m tpu_mot_torch.tools.bench_hard_fixture [--samples 3] [--sweep]
    python -m tpu_mot_torch.tools.bench_hard_fixture --device cpu --small

The fixture is `tools/bench_hard_fixture.py:78-94`'s: `bench.py`'s
generator (seed 0, 128 objects of 24-64 px, speed up to 3 px a frame) over
64 u8 frames of 1080x1920, detections `detections_from_gt(seed=0,
jitter=2.0, drop_prob=0.25, fp_per_frame=4.0)` padded to 168 slots (the
objects + 40), and `TrackerConfig(max_tracks=256)` (twice the objects, at
least 64).  The auction's matrix is [256, 256] a frame: the kernel K2
reads its rows from global memory at that size (`kernels/auction.py`).

The tiers (`tools/bench_hard_fixture.py:96-145`): the oracle, per frame
an optimal IoU >= 0.5 matching of the detections onto the ground truth
(scipy's Hungarian on the host), hypothesis ids the matched ground-truth
ids and false positives dropped, the ceiling of a perfect associator
without coasting; sort-only (`use_kcf=False`: Kalman, IoU and the
auction, no KCF); the shipped defaults; and `output_max_tsu=1` (only the
tracks matched on the frame are emitted).  `--sweep` adds n_init in (1,
2, 3) x max_age_tentative in (1, 2).  Each tracker tier runs
`tracker.scan.run_sequence` from an empty bank once (its scores against
the ground truth: HOTA, DetA, AssA, LocA, MOTA, IDF1, ID switches), then
`--samples` dependent runs, each tracking the clip from the bank the
previous one left and ended by a synchronise and one small fetch: `fps`
is the frames over the median run, `spread_fps` the slowest and fastest.

One JSON line a tier with the JAX tool's keys (tier, hota, deta, assa,
loca, mota, idf1, idsw and, for a tracker tier, cfg) plus fps,
spread_fps, n_samples and device (the card's name and power limit) for
the tracker tiers.  `--small` (240x320, 16 objects, 24 frames; the JAX
tool's TPU_MOT_HARD_SMALL=1) is for tests on the CPU and is refused on
the card.
"""

from __future__ import annotations

import json
import statistics
from typing import NamedTuple

import numpy as np
import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.tools import bench
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker.api import pad_detections
from tpu_mot_torch.utils import metrics

FULL = dict(height=1080, width=1920, n_obj=128, n_frames=64)
SMALL = dict(height=240, width=320, n_obj=16, n_frames=24)
NOISE = dict(jitter=2.0, drop_prob=0.25, fp_per_frame=4.0)
ORACLE = "oracle (IoU-match, FPs discarded)"
TIERS = {"sort-only (use_kcf=False)": dict(use_kcf=False),
         "shipped defaults": {},
         "shipped + output_max_tsu=1": dict(output_max_tsu=1)}
SWEEP = {f"sweep n_init={n_init} max_age_tentative={mat}":
         dict(n_init=n_init, max_age_tentative=mat)
         for n_init in (1, 2, 3) for mat in (1, 2)}


class Fixture(NamedTuple):
    frames: np.ndarray      # [N, H, W] uint8
    dets: np.ndarray        # [N, D, 5] float32, padded detections
    valid: np.ndarray       # [N, D] bool
    dets_list: list         # per frame [D_f, 5]
    gt: list                # per frame (ids [K_f], boxes [K_f, 4])
    n_obj: int
    small: bool = False

    def config(self, **kw) -> TrackerConfig:
        _, h, w = self.frames.shape
        return TrackerConfig(max_tracks=max(2 * self.n_obj, 64),
                             max_detections=self.dets.shape[1],
                             frame_height=h, frame_width=w, **kw)


def fixture(small: bool = False) -> Fixture:
    """`tools/bench_hard_fixture.py:78-94` and its padded detections."""
    sz = SMALL if small else FULL
    h, w, n_obj, n_frames = (sz["height"], sz["width"], sz["n_obj"],
                             sz["n_frames"])
    max_dets = n_obj + 40
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(n_obj, h, w, rng, min_size=24,
                                  max_size=64, max_speed=3.0)
    frames, boxes, vis = synthetic.render_sequence(objs, n_frames, h, w,
                                                   seed=0, noise=0.01)
    dets_list = synthetic.detections_from_gt(boxes, vis, seed=0,
                                             frame_hw=(h, w), **NOISE)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]
    d = np.zeros((n_frames, max_dets, 5), np.float32)
    v = np.zeros((n_frames, max_dets), bool)
    for f in range(n_frames):
        d[f], v[f] = pad_detections(dets_list[f], max_dets)
    return Fixture((frames * 255).astype(np.uint8), d, v, dets_list, gt,
                   n_obj, small)


def oracle(gt, dets_list, iou_thr: float = 0.5) -> list:
    """Per frame an optimal IoU matching of the detections onto the ground
    truth (scipy's Hungarian on the host; the ceiling, not the pipeline):
    [(matched ground-truth ids, their detections' boxes)]."""
    from scipy.optimize import linear_sum_assignment

    hyp = []
    for (gids, gboxes), dets in zip(gt, dets_list):
        d = dets[:, :4]
        if len(gids) == 0 or len(d) == 0:
            hyp.append((np.zeros(0, np.int64), np.zeros((0, 4))))
            continue
        m = metrics._iou_matrix(d, gboxes)
        ri, ci = linear_sum_assignment(-m)
        keep = m[ri, ci] >= iou_thr
        hyp.append((gids[ci[keep]], d[ri[keep]]))
    return hyp


def hypotheses(out) -> list:
    """A run's confirmed tracks a frame: [(ids, boxes)]."""
    ids, boxes, valid = (x.cpu().numpy()
                         for x in (out.ids, out.boxes, out.valid))
    return [(ids[f, valid[f]], boxes[f, valid[f]]) for f in range(len(ids))]


def scores(gt, hyp, tier: str) -> dict:
    h = metrics.hota(gt, hyp)
    cm = metrics.clear_mot(gt, hyp)
    return {"tier": tier, "hota": round(float(h["hota"]), 4),
            "deta": round(float(h["deta"]), 4),
            "assa": round(float(h["assa"]), 4),
            "loca": round(float(h["loca"]), 4),
            "mota": round(float(cm["mota"]), 4),
            "idf1": round(float(cm["idf1"]), 4),
            "idsw": int(cm["idsw"])}


def run(fx: Fixture, tiers: dict, samples: int = 3, device=None):
    """Each tracker tier in turn: yields (tier, its cfg keywords, the run
    from an empty bank (StepOutput), seconds of each dependent sample)."""
    dev = bank_mod.resolve_device(device)
    frames, d, v = (torch.as_tensor(x, device=dev)
                    for x in (fx.frames, fx.dets, fx.valid))
    for tier, kw in tiers.items():
        out, secs = bench.run_tensors(frames, d, v, fx.config(**kw), samples)
        yield tier, kw, out, secs


def tier_line(fx: Fixture, tier: str, kw: dict, out, secs: list[float],
              dev: torch.device) -> dict:
    n = len(fx.frames)
    line = scores(fx.gt, hypotheses(out), tier)
    line["cfg"] = kw and str(kw) or "defaults"
    line.update(fps=round(n / statistics.median(secs), 1),
                spread_fps=bench.spread(n, secs), n_samples=len(secs),
                device=bench.device_name(dev))
    return line


def main(argv=None) -> tuple[list[dict], dict]:
    """Print one JSON line a tier; returns (the lines, {tracker tier: its
    run from an empty bank})."""
    p = bench.parser(__doc__.splitlines()[0])
    p.add_argument("--sweep", action="store_true",
                   help="add the n_init x max_age_tentative sweep")
    p.set_defaults(samples=3)
    args = p.parse_args(argv)
    dev = bench.device_of(args)
    fx = fixture(args.small)
    lines = [scores(fx.gt, oracle(fx.gt, fx.dets_list), ORACLE)]
    print(json.dumps(lines[-1]), flush=True)
    outs = {}
    tiers = {**TIERS, **(SWEEP if args.sweep else {})}
    for tier, kw, out, secs in run(fx, tiers, args.samples, dev):
        outs[tier] = out
        lines.append(tier_line(fx, tier, kw, out, secs, dev))
        print(json.dumps(lines[-1]), flush=True)
    return lines, outs


if __name__ == "__main__":
    main()
