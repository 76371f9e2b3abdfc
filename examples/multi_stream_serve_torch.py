"""Multi-stream serving on the PyTorch port: BASELINE.json configs[4] in
miniature.

Synthetic streams tracked over a "stream" mesh of ranks
(tpu_mot_torch.parallel.mesh), each rank owning the TrackBanks of its
block of streams.  Three stages, as in examples/multi_stream_serve.py:
precomputed detections; one step with the shared YOLO batch (every rank's
frames all-gathered, one forward, each rank keeping its own streams'
detections); then scheduler-fed serving, decoder threads pushing frames
into the native StreamScheduler of each rank.

    python examples/multi_stream_serve_torch.py                  # the card
    python examples/multi_stream_serve_torch.py --device cpu --world 4
    torchrun --nproc-per-node 4 \\
        examples/multi_stream_serve_torch.py --device cpu
    python examples/multi_stream_serve_torch.py --world 2 --backend gloo

--world n starts n ranks itself (mesh.spawn); under torchrun the world is
torchrun's.  On cards NCCL takes one rank per card; --backend gloo puts
several ranks on one card.
"""

import argparse
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpu_mot_torch.config import TrackerConfig  # noqa: E402
from tpu_mot_torch.data import synthetic  # noqa: E402
from tpu_mot_torch.models import detector  # noqa: E402
from tpu_mot_torch.models.yolo import YOLOV2_TINY_ANCHORS  # noqa: E402
from tpu_mot_torch.models.yolo import YoloSpec  # noqa: E402
from tpu_mot_torch.native import StreamScheduler  # noqa: E402
from tpu_mot_torch.parallel import mesh as mesh_mod  # noqa: E402
from tpu_mot_torch.parallel import serve  # noqa: E402
from tpu_mot_torch.tracker.api import pad_detections  # noqa: E402
from tpu_mot_torch.utils.profiling import FpsMeter  # noqa: E402

D_CAP = 16


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cpu, or the card (default)")
    p.add_argument("--world", type=int, default=1,
                   help="ranks to start (ignored under torchrun)")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl on cards, gloo on the CPU")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    return p.parse_args(argv)


def serve_rank(rank: int, world: int, args) -> None:
    """One rank: its block of streams through the three stages."""
    dev = (torch.device("cpu") if args.device == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    m = (mesh_mod.stream_mesh(world, device=dev, backend=args.backend)
         if world > 1 else None)
    h, w, n_frames = args.height, args.width, args.frames
    cfg = TrackerConfig(max_tracks=32, max_detections=D_CAP,
                        frame_height=h, frame_width=w, n_init=2)
    if args.streams % world:
        raise SystemExit(f"{args.streams} streams do not split over "
                         f"{world} ranks")
    k = args.streams // world
    mine = range(rank * k, (rank + 1) * k)
    tag = f"[rank {rank}/{world}, {dev}, streams {mine.start}-{mine.stop - 1}]"
    print(f"{tag} backend "
          f"{'none' if m is None else torch.distributed.get_backend()}",
          flush=True)

    # independent synthetic scenes, stream s at seed s, rendered here
    scenes = []
    for sid in mine:
        objs = synthetic.make_objects(8, h, w, np.random.default_rng(sid),
                                      max_speed=2.0)
        frames, boxes, vis = synthetic.render_sequence(objs, n_frames, h, w,
                                                       seed=sid)
        dets = synthetic.detections_from_gt(boxes, vis, seed=sid,
                                            frame_hw=(h, w))
        scenes.append((frames, dets))

    # 1. precomputed detections
    banks = serve.make_stream_banks(args.streams, cfg, m, device=dev)
    meter = FpsMeter()
    for f in range(n_frames):
        frames = torch.as_tensor(np.stack([s[0][f] for s in scenes]),
                                 device=dev)
        padded = [pad_detections(s[1][f], D_CAP) for s in scenes]
        d = torch.as_tensor(np.stack([p[0] for p in padded]), device=dev)
        v = torch.as_tensor(np.stack([p[1] for p in padded]), device=dev)
        banks, out = serve.multi_stream_step(banks, frames, d, v, cfg)
        meter.tick(k)
        if f % 10 == 9 or f == n_frames - 1:
            print(f"{tag} frame {f + 1}: alive per stream "
                  f"{out.n_alive.tolist()} {meter.stats()}", flush=True)

    # 2. the shared detector batch: one forward over every rank's frames
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = detector.YoloDetector.random_init(spec, seed=0, device=dev,
                                            max_out=D_CAP, score_thr=0.0)

    def detect_fn(model, fr):
        return detector.detect_batch(model, fr, (h, w), D_CAP, 0.45, 0.0)

    frames = torch.as_tensor(np.stack([s[0][0] for s in scenes]), device=dev)
    _, out2 = serve.detect_then_track_step_shared(
        det.model, serve.make_stream_banks(args.streams, cfg, m, device=dev),
        frames, cfg, detect_fn, m)
    print(f"{tag} shared-detector step ok: alive per stream "
          f"{out2.n_alive.tolist()}", flush=True)

    # 3. host ingest: decoder threads -> StreamScheduler -> the step; late
    # streams repeat their last frame (serving never blocks)
    sched = StreamScheduler(k, frame_shape=(h, w), capacity=4,
                            dtype=np.uint8)

    def decoder(i):
        for f in range(n_frames):
            sched.push(i, (scenes[i][0][f] * 255).astype(np.uint8))
            time.sleep(0.001 * (1 + i % 3))             # uneven rates

    threads = [threading.Thread(target=decoder, args=(i,), daemon=True)
               for i in range(k)]
    for t in threads:
        t.start()
    banks3 = serve.make_stream_banks(args.streams, cfg, m, device=dev)
    empty_d = torch.zeros((k, D_CAP, 5), device=dev)
    empty_v = torch.zeros((k, D_CAP), dtype=torch.bool, device=dev)
    steps = 0
    while steps < min(10, n_frames):
        got = sched.gather()
        if got is None:
            time.sleep(0.001)
            continue
        batch, _ = got
        banks3, _ = serve.multi_stream_step(
            banks3, torch.as_tensor(batch, device=dev), empty_d, empty_v,
            cfg)
        steps += 1
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise RuntimeError("a decoder thread did not finish")
    print(f"{tag} scheduler-fed serving ok: {sched.stats()}", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.world > 1 and "RANK" not in os.environ:
        mesh_mod.spawn(serve_rank, args.world, args,
                       device=args.device or "cuda", backend=args.backend)
    else:                                  # one process, or torchrun's rank
        dev = mesh_mod.local_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        serve_rank(int(os.environ.get("RANK", 0)),
                   int(os.environ.get("WORLD_SIZE", 1)), args)
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
