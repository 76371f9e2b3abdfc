"""Class-aware MOT on the PyTorch port: the 6-column detection form end to
end (the port's twin of examples/class_aware_mot.py).

Two visually identical targets of different detector classes approach
head-on and bounce off each other: constant-velocity prediction continues
past the bounce, so IoU pairs each track with the other object, and KCF
refinement cannot help because the pixels match.  The detector class id,
a sixth detection column, is the one signal that tells them apart:
cfg.class_aware makes a cross-class match infeasible.  Three operating
points, scored with CLEAR-MOT and HOTA: class-blind; the class gate alone;
the gate with assoc_box="best".

    python examples/class_aware_mot_torch.py               # the card
    python examples/class_aware_mot_torch.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_mot_torch.config import TrackerConfig  # noqa: E402
from tpu_mot_torch.data import synthetic  # noqa: E402
from tpu_mot_torch.tracker import bank as bank_mod  # noqa: E402
from tpu_mot_torch.tracker import scan  # noqa: E402
from tpu_mot_torch.tracker.api import pad_detections  # noqa: E402
from tpu_mot_torch.utils import metrics  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cpu, or the card (default)")
    args = p.parse_args(argv)
    dev = bank_mod.resolve_device(args.device)

    h, w, n_frames = 240, 320, 40
    speed, meet, y = 4.0, 160.0, 120.0
    f_meet = n_frames // 2
    t = np.arange(n_frames)
    cx1 = np.where(t <= f_meet, meet - speed * (f_meet - t),
                   meet - speed * (t - f_meet))    # approach, then bounce
    centers = np.zeros((n_frames, 2, 2))
    centers[:, 0] = np.stack([cx1, np.full(n_frames, y - 1.0)], -1)
    centers[:, 1] = np.stack([2 * meet - cx1,
                              np.full(n_frames, y + 1.0)], -1)
    sizes = np.asarray([[20.0, 20.0], [20.0, 20.0]])
    classes = np.asarray([0, 1], np.int64)
    frames, boxes, vis = synthetic.render_trajectories(
        centers, sizes, h, w, seed=42, tex_levels=[0.45, 0.45])
    # simulated detector output with the class column ([D, 6]); a real
    # detector gives the same form through models.detector.detect_batch
    # and dets_with_classes
    dets_list = synthetic.detections_from_gt(
        boxes, vis, seed=1, jitter=1.0, frame_hw=(h, w), classes=classes)
    gt = [(np.where(vis[f])[0], boxes[f, np.where(vis[f])[0]])
          for f in range(n_frames)]
    d = np.zeros((n_frames, 16, 6), np.float32)
    v = np.zeros((n_frames, 16), bool)
    for f in range(n_frames):
        d[f], v[f] = pad_detections(dets_list[f], 16)
    frames_t = torch.as_tensor(frames, device=dev)
    valid_t = torch.as_tensor(v, device=dev)

    for aware, abox in ((False, "refined"), (True, "refined"),
                        (True, "best")):
        cfg = TrackerConfig(max_tracks=16, max_detections=16,
                            frame_height=h, frame_width=w, n_init=2,
                            roi_impl="xla", class_aware=aware,
                            assoc_box=abox)
        dets = torch.as_tensor(d if aware else d[..., :5], device=dev)
        _, outs = scan.run_sequence(bank_mod.empty_bank(cfg, device=dev),
                                    frames_t, dets, valid_t, cfg)
        ids, bxs, val = (outs.ids.cpu().numpy(), outs.boxes.cpu().numpy(),
                         outs.valid.cpu().numpy())
        hyp = [(ids[f, val[f]], bxs[f, val[f]]) for f in range(n_frames)]
        m = metrics.clear_mot(gt, hyp)
        ho = metrics.hota(gt, hyp)
        print(f"class_aware={aware!s:5} assoc_box={abox:9}"
              f"  MOTA {m['mota']:.3f}  "
              f"IDF1 {m['idf1']:.3f}  HOTA {ho['hota']:.3f}  "
              f"(DetA {ho['deta']:.3f} / AssA {ho['assa']:.3f})  "
              f"IDSW {m['idsw']}  ({dev})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
