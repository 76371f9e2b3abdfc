"""The port's twin of the repo's `tools/train_e2e_mota.py`: fine-tune
yolov3-tiny on the synthetic scenes, then score it (held-out mAP, the
served-dtype mAPs) and run detect -> track with the trained detector in the
loop, scored by MOTA against the ground truth, on the CUDA card.

    python -m tpu_mot_torch.tools.train_e2e_mota [--steps 600] [--batch 8]
        [--classes 1] [--save params.npz] [--load params.npz]
    python -m tpu_mot_torch.tools.train_e2e_mota --device cpu --small

What it runs is `tools/train_e2e_mota.py:71-317`'s:
  * the scenes: 240x320 float frames, 10 objects of 16-40 px (speed up to
    2.5 px a frame, `--classes` families), noise 0.02; scene s is seeded s.
  * train: yolov3-tiny at input 256 with the tool's two-head anchors
    (((40, 40), (64, 64), (96, 96)), ((12, 12), (20, 20), (30, 30))),
    BatchNorm momentum 0.9; scenes 0-47 of 24 frames (1152 images, gray
    repeated to 3 channels, antialiased bilinear resize to 256, boxes
    scaled to the input); `--steps` Adam steps at batch `--batch`, the
    batches' indices drawn by `default_rng(0)`; the learning rate is
    optax's cosine_decay_schedule(1e-3, steps, alpha=0.05): at update t
    (from 0) 1e-3 * ((1 - 0.05) * (1 + cos(pi * t / steps)) / 2 + 0.05).
    The initial weights are `parallel.train.init_params(spec, 0)`: flax's
    initialisation scheme (the JAX tool's) drawn by torch, so not the JAX
    run's numbers.  The whole set sits on the device; the losses are read
    once, after the last step.
  * map: scenes 100-101 of 12 frames, detections at score 0.05 into 64
    slots, mAP@0.5 (utils.metrics.detection_map) and the detection F1 at
    score thresholds 0.1-0.8, the best of which feeds the tracker.
  * quant_map: the same weights served in bfloat16 and int8.
  * stem_map: the port composes the direct stem for every `stem` value
    (models/yolo.py), so the JAX tool's s2d4 rows are the direct rows here;
    the line keeps the JAX tool's keys, prints those rows and says so in
    its `note`, and runs no second detector pass.
  * SUMMARY: scene 200 over 40 frames, the detector at the chosen
    threshold into 32 slots, `TrackerConfig(max_tracks=32,
    max_detections=32, output_max_tsu=1)`; class-aware too when
    `--classes` > 1: MOTA, IDF1, HOTA, ID switches.

`--save` writes the trained weights in the JAX package's layout as a .npz
(utils.checkpoint.save_pytree of interop.yolo_params_to_jax), `--load`
reads one and skips training; the JAX tool's flax msgpack has no reader
here.  One JSON line a phase with the JAX tool's keys, plus `device` (the
card's name and power limit) on the SUMMARY line.  The fine-tune is
chaotic in float32 (6000 steps of it reach different nets on different
hardware), so its numbers are compared by floors, not equality.

The JAX tool on the CPU (`python tools/train_e2e_mota.py --cpu`, jax
0.9.0) printed, at 600 steps: loss 19.3013 -> 0.5445, mAP@50 0.3946
(bf16 0.4027, int8 0.4171), chosen threshold 0.2, MOTA -0.145, IDF1
0.4485, HOTA 0.4089, 23 ID switches.

Without a card it raises unless `--device cpu` is given.  `--small` (input
64, 2 training scenes of 4 frames, 4 steps at batch 2, 2 held-out frames,
an 8-frame tracking scene) is for tests on the CPU and is refused on the
card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_mot_torch import interop
from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.models.detector import (YoloDetector, detect_batch,
                                           dets_with_classes)
from tpu_mot_torch.models.yolo import YoloSpec
from tpu_mot_torch.parallel import train as train_mod
from tpu_mot_torch.tools import bench
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import scan
from tpu_mot_torch.utils import checkpoint, metrics

METRIC = "e2e detect+track MOTA with trained detector in loop"
H, W = 240, 320
N_OBJ = 10
ANCHORS = (((40, 40), (64, 64), (96, 96)), ((12, 12), (20, 20), (30, 30)))
LR, ALPHA = 1e-3, 0.05
THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)
# input size, training scenes x frames, held-out scenes x frames, tracking
# frames, default steps and batch
FULL = dict(input_size=256, train=(48, 24), val=((100, 101), 12),
            track=40, steps=600, batch=8)
SMALL = dict(input_size=64, train=(2, 4), val=((100,), 2), track=8, steps=4,
             batch=2)
STEM_NOTE = ("the port composes the direct stem for every stem value: "
             "these are the float32 and bfloat16 direct-stem rows; no s2d4 "
             "pass runs")


def scenes(seeds, n_frames: int, n_classes: int = 1) -> list:
    """`tools/train_e2e_mota.py:29-41`: per seed (frames [N, H, W], boxes
    [N, K, 4], visible [N, K], classes [K])."""
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        objs = synthetic.make_objects(N_OBJ, H, W, rng, min_size=16,
                                      max_size=40, max_speed=2.5,
                                      n_classes=n_classes)
        frames, boxes, vis = synthetic.render_sequence(
            objs, n_frames, H, W, seed=seed, noise=0.02)
        out.append((frames, boxes, vis,
                    np.asarray([o.cls for o in objs], np.int64)))
    return out


def to_input_px(boxes, input_size: int) -> np.ndarray:
    """Frame-pixel cxcywh -> input-pixel cxcywh (the detector's resize maps
    the whole frame onto input x input, anisotropically)."""
    b = np.asarray(boxes, np.float32).copy()
    b[..., 0] *= input_size / W
    b[..., 2] *= input_size / W
    b[..., 1] *= input_size / H
    b[..., 3] *= input_size / H
    return b


def det_f1(dets, valid, gboxes, gvis, thr: float) -> float:
    """Detection F1 at score threshold thr: greedy IoU >= 0.5 matching in
    score order (`tools/train_e2e_mota.py:191-207`)."""
    tp = fp = fn = 0
    for f in range(len(dets)):
        pb = dets[f, valid[f] & (dets[f, :, 4] >= thr), :4]
        gb = gboxes[f, gvis[f]]
        used = np.zeros(len(gb), bool)
        for b in pb:
            ious = metrics._iou_matrix(b[None], gb)[0]
            j = int(np.argmax(ious)) if len(gb) else -1
            if j >= 0 and ious[j] >= 0.5 and not used[j]:
                used[j] = True
                tp += 1
            else:
                fp += 1
        fn += int((~used).sum())
    return 2 * tp / max(2 * tp + fp + fn, 1)


def spec_for(input_size: int, n_classes: int = 1) -> YoloSpec:
    return YoloSpec("yolov3-tiny", num_classes=n_classes, stem="direct",
                    input_size=input_size, anchors=ANCHORS, bn_momentum=0.9)


def cosine_lr(t: int, steps: int) -> float:
    """optax.cosine_decay_schedule(LR, steps, ALPHA) at update count t."""
    decay = 0.5 * (1 + math.cos(math.pi * min(t, steps) / steps))
    return LR * ((1 - ALPHA) * decay + ALPHA)


def adam(params) -> torch.optim.Adam:
    """The optimizer at the schedule's first rate; `train` steps it."""
    return torch.optim.Adam(params, lr=LR)


def train_images(frames, input_size: int, device) -> torch.Tensor:
    """Gray frames [n, H, W] -> the net's input [n, s, s, 3] NHWC:
    antialiased bilinear resize (jax.image.resize "bilinear"), the channel
    repeated."""
    x = torch.as_tensor(frames, device=device)[:, None]
    x = F.interpolate(x, size=(input_size, input_size), mode="bilinear",
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1).repeat(1, 1, 1, 3).contiguous()


def train_set(sz: dict, n_classes: int, device):
    """The training images [n, s, s, 3] on the device and per-head targets
    (tensors on the device), from scenes 0.. of sz["train"]."""
    n_scenes, n_frames = sz["train"]
    sc = scenes(range(n_scenes), n_frames, n_classes)
    frames = np.concatenate([s[0] for s in sc])
    boxes = np.concatenate([s[1] for s in sc])
    vis = np.concatenate([s[2] for s in sc])
    cls = np.concatenate([np.tile(s[3], (len(s[0]), 1)) for s in sc])
    spec = spec_for(sz["input_size"], n_classes)
    tgts = train_mod.build_targets(spec, to_input_px(boxes, spec.input_size),
                                   cls, vis)
    return (train_images(frames, spec.input_size, device),
            [torch.as_tensor(t, device=device) for t in tgts])


def train(state, images, targets, spec: YoloSpec, batch_idx
          ) -> tuple[torch.Tensor, list[float]]:
    """One step of the state's optimizer (`adam`) a row of batch_idx
    [steps, batch], its learning rate set by cosine_lr over those steps
    (a LambdaLR stepped after every update).  Returns the losses [steps]
    (on the device, not read) and the learning rate of each update."""
    steps = len(batch_idx)
    schedule = torch.optim.lr_scheduler.LambdaLR(
        state.optimizer, lambda t: cosine_lr(t, steps) / LR)
    step = train_mod.make_train_step(spec)
    idx = torch.as_tensor(batch_idx, device=images.device)
    losses, lrs = [], []
    for i in range(steps):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state, loss = step(state, images[idx[i]], [t[idx[i]]
                                                   for t in targets])
        schedule.step()
        losses.append(loss)
    return torch.stack(losses), lrs


def detections(model, frames, max_out: int, score_thr: float):
    """detect_batch at IoU 0.45 -> NumPy (dets, valid, classes)."""
    out = detect_batch(model, frames, (H, W), max_out, 0.45, score_thr)
    return tuple(x.cpu().numpy() for x in out)


def served(spec: YoloSpec, state_dict, dev, **repl):
    """The same weights in a replaced spec (dtype), as a net on dev."""
    return YoloDetector(dataclasses.replace(spec, **repl), state_dict,
                        device=dev).model


def map50(model, vframes, gt, n_classes: int):
    """mAP@0.5 of `model` on the held-out frames (score 0.05, 64 slots);
    returns (mAP, (dets, valid, classes))."""
    d, v, c = detections(model, vframes, 64, 0.05)
    pred = [(d[f, v[f], :4], d[f, v[f], 4], c[f, v[f]])
            for f in range(len(d))]
    return metrics.detection_map(pred, gt, num_classes=n_classes)["map"], \
        (d, v, c)


def track_and_score(model, eframes, eboxes, evis, thr: float,
                    class_aware: bool) -> dict:
    """Detect at thr into 32 slots, track (32 tracks, output_max_tsu=1),
    score against the ground truth: clear_mot's keys plus hota."""
    dev = eframes.device
    d, v, c = detect_batch(model, eframes, (H, W), 32, 0.45, thr)
    cfg = TrackerConfig(max_tracks=32, max_detections=32, frame_height=H,
                        frame_width=W, output_max_tsu=1,
                        class_aware=class_aware)
    if class_aware:
        d = dets_with_classes(d, c)
    _, outs = scan.run_sequence(bank_mod.empty_bank(cfg, device=dev),
                                eframes, d, v, cfg)
    ids, boxes, valid = (x.cpu().numpy()
                         for x in (outs.ids, outs.boxes, outs.valid))
    hyp = [(ids[f, valid[f]], boxes[f, valid[f]]) for f in range(len(ids))]
    gt = [(np.where(evis[f])[0], eboxes[f, np.where(evis[f])[0]])
          for f in range(len(ids))]
    m = metrics.clear_mot(gt, hyp)
    m["hota"] = metrics.hota(gt, hyp)["hota"]
    return m


def main(argv=None) -> tuple[list[dict], dict]:
    """Print one JSON line a phase; returns (the lines, {"losses": the
    per-step losses (NumPy, empty with --load), "model": the trained net})."""
    p = bench.parser(__doc__.splitlines()[0], samples=False)
    p.add_argument("--steps", type=int, default=None,
                   help="Adam steps (default 600; 4 with --small)")
    p.add_argument("--batch", type=int, default=None,
                   help="images a step (default 8; 2 with --small)")
    p.add_argument("--classes", type=int, default=1,
                   help="detector classes; > 1 keys object textures by "
                        "class and adds a class-aware tracking score")
    p.add_argument("--save", default=None,
                   help="write the trained weights here (.npz)")
    p.add_argument("--load", default=None,
                   help="skip training; load weights written by --save")
    args = p.parse_args(argv)
    dev = bench.device_of(args)
    sz = SMALL if args.small else FULL
    steps = args.steps or sz["steps"]
    batch = args.batch or sz["batch"]
    n_cls = args.classes
    spec = spec_for(sz["input_size"], n_cls)
    lines = []

    def say(line):
        lines.append(line)
        print(json.dumps(line), flush=True)

    # -- train ---------------------------------------------------------------
    losses = np.zeros(0, np.float32)
    if args.load:
        like = interop.yolo_params_to_jax(
            train_mod.init_params(spec, 0))
        sd = interop.yolo_params_from_jax(
            checkpoint.load_pytree(args.load, like))
        model = served(spec, sd, dev)
        say({"phase": "train", "loaded": args.load})
    else:
        images, targets = train_set(sz, n_cls, dev)
        batch_idx = np.random.default_rng(0).integers(
            0, images.shape[0], (steps, batch))
        state = train_mod.init_train_state(spec, adam, seed=0, device=dev)
        t0 = time.time()
        losses = train(state, images, targets, spec,
                       batch_idx)[0].cpu().numpy()
        seconds = time.time() - t0
        del images, targets
        model = state.model.eval()
        say({"phase": "train", "steps": steps,
             "loss_first": round(float(losses[0]), 4),
             "loss_final": round(float(losses[-1]), 4),
             "seconds": round(seconds, 1)})
        if args.save:
            checkpoint.save_pytree(args.save, interop.yolo_params_to_jax(
                model.state_dict()))
    sd = model.state_dict()

    # -- held-out mAP and the operating point --------------------------------
    seeds, n_val = sz["val"]
    val = scenes(seeds, n_val, n_cls)
    vframes = torch.as_tensor(np.concatenate([s[0] for s in val]),
                              device=dev)
    vboxes = np.concatenate([s[1] for s in val])
    vvis = np.concatenate([s[2] for s in val])
    vcls = np.concatenate([np.tile(s[3], (len(s[0]), 1)) for s in val])
    gt = [(vboxes[f, vvis[f]], vcls[f, vvis[f]]) for f in range(len(vboxes))]
    m_ap, (dets, valid, _) = map50(model, vframes, gt, n_cls)
    f1s = [det_f1(dets, valid, vboxes, vvis, t) for t in THRESHOLDS]
    best_thr = THRESHOLDS[int(np.argmax(f1s))]
    say({"phase": "map", "map@50": round(m_ap, 4),
         "frames": len(vboxes),
         "val_f1_by_thr": {str(t): round(v, 3)
                           for t, v in zip(THRESHOLDS, f1s)},
         "chosen_score_thr": best_thr})

    # -- the same weights served in bfloat16 and int8 ------------------------
    quant = {"float32": round(m_ap, 4)}
    for dt in ("bfloat16", "int8"):
        quant[dt] = round(map50(served(spec, sd, dev, dtype=dt), vframes, gt,
                                n_cls)[0], 4)
    say({"phase": "quant_map", "map@50": quant,
         "delta_int8": round(quant["int8"] - quant["float32"], 4),
         "delta_bf16": round(quant["bfloat16"] - quant["float32"], 4)})
    say({"phase": "stem_map",
         "map@50": {"f32+s2d4": quant["float32"],
                    "bf16+s2d4": quant["bfloat16"]},
         "delta_f32_s2d4": 0.0, "delta_bf16_s2d4": 0.0, "note": STEM_NOTE})

    # -- detect -> track, scored ---------------------------------------------
    eframes, eboxes, evis, _ = scenes((200,), sz["track"], n_cls)[0]
    eframes = torch.as_tensor(eframes, device=dev)
    m = track_and_score(model, eframes, eboxes, evis, best_thr, False)
    summary = {"phase": "SUMMARY",
               "metric": bench.metric_name(METRIC, dev, args.small),
               "classes": n_cls, "map@50": round(m_ap, 4),
               "mota": round(m["mota"], 4), "idf1": round(m["idf1"], 4),
               "hota": round(m["hota"], 4), "idsw": int(m["idsw"]),
               "train_steps": steps,
               "device": bench.device_name(dev)}
    if n_cls > 1:
        ma = track_and_score(model, eframes, eboxes, evis, best_thr, True)
        summary["class_aware"] = {
            "mota": round(ma["mota"], 4), "idf1": round(ma["idf1"], 4),
            "hota": round(ma["hota"], 4), "idsw": int(ma["idsw"])}
    say(summary)
    return lines, {"losses": losses, "model": model}


if __name__ == "__main__":
    main()
