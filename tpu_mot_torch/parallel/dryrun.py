"""The port's counterparts of `__graft_entry__.py`: `entry`, the flagship
forward step (`__graft_entry__.entry`), and the multi-device dry run
(`__graft_entry__.dryrun_multichip` and its body, `_dryrun_body`).

    fn, args = entry(device="cpu")         # one step on a 128-slot bank
    new_bank, out = fn(*args)

    dryrun_multichip(4, device="cpu")      # 4 gloo ranks on the CPU
    dryrun_multichip(1)                    # one NCCL rank on the card
    dryrun_multichip(4, device="cuda:0", backend="gloo")   # 4 ranks, 1 card

Through parallel/mesh.spawn it runs, on n ranks and at the JAX package's
shapes: (1) the stream-sharded tracking step, each rank's streams held to
single-stream steps; (2) serve.dryrun_shared_detector, the shared detector
batch against the per-shard data-parallel detector; (3) one data-parallel
train step of yolov2-tiny at 64 on a global batch of n images, whose loss
and parameters must agree on every rank.  Any failure raises.

There is no self-provisioning: the JAX package re-executes itself on
virtual CPU devices when it sees too few; here CPU ranks are asked for
with device="cpu", and on a card n must not exceed the cards unless
backend="gloo" puts several ranks on one card.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.parallel import mesh as mesh_mod
from tpu_mot_torch.parallel import serve, train
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import step as step_mod


def entry(device=None):
    """The fused per-frame step (KCF detect, Kalman, auction association,
    lifecycle, retrain) on an empty 128-slot bank at the JAX entry's inputs:
    a seed-0 480 x 640 float frame and 8 detections in 64 slots.  Returns
    (fn, args): fn(bank, frame, dets, det_valid) -> (new bank, StepOutput),
    args on `device` (default: the CUDA card; see bank.resolve_device)."""
    dev = bank_mod.resolve_device(device)
    cfg = TrackerConfig(max_tracks=128, max_detections=64,
                        frame_height=480, frame_width=640)
    rng = np.random.default_rng(0)
    frame = rng.random((480, 640)).astype(np.float32)
    dets = np.zeros((64, 5), np.float32)
    dets[:8, :2] = rng.uniform(100, 400, (8, 2))
    dets[:8, 2:4] = rng.uniform(16, 48, (8, 2))
    dets[:8, 4] = 1.0
    valid = np.zeros((64,), bool)
    valid[:8] = True

    def fn(bank, frame, dets, det_valid):
        return step_mod.step(bank, frame, dets, det_valid, cfg)

    return fn, (bank_mod.empty_bank(cfg, device=dev),
                *(torch.as_tensor(x, device=dev)
                  for x in (frame, dets, valid)))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _body(rank: int, world: int, device_type: str, backend: str) -> dict:
    """One rank of the dry run (on the card spawn set, or the CPU);
    returns what it saw."""
    from tpu_mot_torch.models.yolo import YOLOV2_TINY_ANCHORS, YoloSpec

    dev = (torch.device("cpu") if device_type == "cpu"
           else torch.device("cuda", torch.cuda.current_device()))
    n = world

    # 1. the stream-sharded multi-stream tracking step
    cfg = TrackerConfig(max_tracks=16, max_detections=8, frame_height=64,
                        frame_width=96, roi_impl="xla")
    m = mesh_mod.stream_mesh(n, device=dev, backend=backend)
    rng = np.random.default_rng(0)
    frames = rng.random((n, 64, 96)).astype(np.float32)
    dets = np.zeros((n, 8, 5), np.float32)
    dets[:, :3, :2] = rng.uniform(16, 60, (n, 3, 2))
    dets[:, :3, 2:4] = rng.uniform(8, 16, (n, 3, 2))
    dets[:, :3, 4] = 1.0
    valid = np.zeros((n, 8), bool)
    valid[:, :3] = True
    frames, dets, valid = (mesh_mod.shard_leading(
        torch.as_tensor(x, device=dev), m) for x in (frames, dets, valid))
    banks = serve.make_stream_banks(n, cfg, m, device=dev)
    _, outs = serve.multi_stream_step(banks, frames, dets, valid, cfg)
    _check(bool(torch.isfinite(outs.boxes).all()), "non-finite boxes")
    _check(bool((outs.n_alive == 3).all()),
           f"rank {rank}: n_alive {outs.n_alive.tolist()}, expected 3")
    for s in range(frames.shape[0]):
        _, one = step_mod.step(bank_mod.empty_bank(cfg, device=dev),
                               frames[s], dets[s], valid[s], cfg)
        _check(torch.equal(outs.ids[s], one.ids)
               and float((outs.boxes[s] - one.boxes).abs().max()) <= 1e-4,
               f"rank {rank}, stream {s}: the sharded step differs from "
               "the single-stream step")

    # 2. the shared-detector serving step (configs[4])
    serve.dryrun_shared_detector(m, dev)

    # 3. one data-parallel train step
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    bm = mesh_mod.batch_mesh(n, device=dev, backend=backend)
    state = train.init_train_state(
        spec, lambda p: torch.optim.SGD(p, lr=1e-3), device=dev, mesh=bm)
    images = rng.random((n, 64, 64, 3)).astype(np.float32)
    gt_boxes = rng.uniform(8, 56, (n, 2, 4)).astype(np.float32)
    gt_boxes[..., 2:] = rng.uniform(8, 24, (n, 2, 2))
    gt_classes = rng.integers(0, 2, (n, 2))
    targets = [mesh_mod.shard_leading(torch.as_tensor(t, device=dev), bm)
               for t in train.build_targets(spec, gt_boxes, gt_classes,
                                            np.ones((n, 2), bool))]
    state, loss = train.make_train_step(spec, bm)(
        state, mesh_mod.shard_leading(torch.as_tensor(images, device=dev),
                                      bm), targets)
    losses = mesh_mod.all_gather_leading(loss.reshape(1), bm)
    w0 = next(state.model.parameters()).detach()
    w0s = mesh_mod.all_gather_leading(w0[None], bm)
    _check(bool(torch.isfinite(loss)), f"loss {float(loss)}")
    _check(bool((losses == losses[0]).all()
                and (w0s == w0s[0]).all()),
           f"ranks disagree after the train step: losses {losses.tolist()}")
    return dict(rank=rank, backend=backend, device=str(dev),
                n_alive=outs.n_alive.tolist(), loss=float(loss))


def dryrun_multichip(n_devices: int, device=None,
                     backend: str | None = None) -> list[dict]:
    """Run the dry run on n_devices ranks and return each rank's summary
    (its backend, device, tracks alive, the train step's loss); raises on
    any failure.  device: "cpu" for gloo ranks on the CPU, else the cards
    (default; raises without one).  On cards n_devices may exceed the
    cards only with backend="gloo" (several ranks on one card)."""
    dev = bank_mod.resolve_device(device)
    backend = backend or mesh_mod.default_backend(dev)
    if (dev.type == "cuda" and backend != "gloo"
            and n_devices > torch.cuda.device_count()):
        raise RuntimeError(
            f"dryrun_multichip({n_devices}): this machine shows "
            f"{torch.cuda.device_count()} CUDA card(s), and NCCL takes one "
            "rank per card; pass backend='gloo' to share cards")
    return mesh_mod.spawn(_body, n_devices, dev.type, backend,
                          device=str(dev), backend=backend)
