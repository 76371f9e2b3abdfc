"""Multi-stream serving (counterpart of tpu_mot/parallel/serve.py), on one
card or over a "stream" mesh of ranks (parallel/mesh.py).

BASELINE.json configs[4] is "8 concurrent 1080p streams sharded across a
v5e-8, shared detector batch".

  * The banks of S streams are one TrackBank whose every field has a
    leading [S] (`make_stream_banks`), and one step of all streams is one
    set of launches (`tracker.step.step_streams`: per-track math on
    [S*T] rows, the ROI kernels with a frame index, the auction kernel
    over a batch of S problems).  The JAX package gets the same from
    jax.vmap(step); stream s's results are those of the single-stream
    step on stream s.
  * Over a mesh of n ranks each rank owns a contiguous block of S/n
    streams (rank r: streams [r*S/n, (r+1)*S/n), as P("stream") splits a
    global array) and steps them alone: the tracker needs no collective,
    as GSPMD partitions the JAX vmap.  Frames, detections and outputs are
    this rank's block; gathering them in rank order gives the one-process
    result.
  * The detector runs as ONE batched forward over all streams' frames.
    `shared_detector_detect` with a mesh is configs[4]'s shared batch:
    all-gather every rank's frames, one forward over all S on every rank,
    keep this rank's rows.  Without a mesh the forward covers the frames
    it is given: on one card that is every stream (the shared batch and
    the data-parallel forward are the same), on a rank its own streams
    (the JAX package's per-shard data-parallel mode, no collective).
  * `dryrun_shared_detector` holds the two modes to each other on the
    calling rank's mesh at tiny shapes.

detect_fn(model, frames [S, H, W]) -> (dets [S, D, 5], valid [S, D],
classes [S, D]); typically models.detector.detect_batch closed over its
arguments.
"""

from __future__ import annotations

import torch

from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.models.detector import dets_with_classes
from tpu_mot_torch.parallel import mesh as mesh_mod
from tpu_mot_torch.tracker import bank as bank_mod
from tpu_mot_torch.tracker import step as step_mod


def make_stream_banks(n_streams: int, cfg: TrackerConfig, mesh=None,
                      device=None) -> bank_mod.TrackBank:
    """One empty TrackBank per stream, stacked on a leading axis, on
    `device` (default: the CUDA card; see bank.resolve_device).  Without a
    mesh the axis holds all n_streams; over a mesh of n ranks it holds this
    rank's n_streams / n, and n must divide n_streams."""
    if mesh is not None:
        n = mesh.size()
        if n_streams % n:
            raise ValueError(f"{n_streams} streams do not split over the "
                             f"{n} ranks of the stream mesh")
        n_streams //= n
    one = bank_mod.empty_bank(cfg, device=device)
    return bank_mod.map_bank(
        lambda x: x[None].expand((n_streams,) + x.shape).clone(), one)


def _fold_classes(dets, classes, cfg: TrackerConfig):
    """Append the detector class column under cfg.class_aware (the [.., 6]
    detection form the step's class gate consumes)."""
    if not cfg.class_aware:
        return dets
    return dets_with_classes(dets, classes)


def _stack(outs: list) -> step_mod.StepOutput:
    """Per-frame StepOutputs of S streams -> fields stacked [S, N, ...]."""
    return step_mod.StepOutput(*[torch.stack(xs, dim=1)
                                 for xs in zip(*outs)])


def multi_stream_step(banks: bank_mod.TrackBank, frames: torch.Tensor,
                      dets: torch.Tensor, det_valid: torch.Tensor,
                      cfg: TrackerConfig):
    """One tracking frame for every stream.

    banks     : TrackBank with a leading [S] axis (make_stream_banks).
    frames    : [S, H, W] (or [S, H, W, 3]).
    dets      : [S, D, 5|6], det_valid [S, D].
    Returns (banks, StepOutput with a leading [S]).  Over a mesh S is this
    rank's streams: no collective."""
    return step_mod.step_streams(banks, frames, dets, det_valid, cfg)


def multi_stream_sequence(banks: bank_mod.TrackBank, frames: torch.Tensor,
                          dets: torch.Tensor, det_valid: torch.Tensor,
                          cfg: TrackerConfig):
    """Track a clip per stream: frames [S, N, H, W], dets [S, N, D, 5|6],
    det_valid [S, N, D] -> (banks, StepOutput stacked [S, N, ...]).  Over a
    mesh every argument is this rank's block of streams."""
    outs = []
    for i in range(frames.shape[1]):
        banks, out = multi_stream_step(banks, frames[:, i], dets[:, i],
                                       det_valid[:, i], cfg)
        outs.append(out)
    return banks, _stack(outs)


def multi_stream_sequence_strided(model, banks: bank_mod.TrackBank,
                                  frames: torch.Tensor, cfg: TrackerConfig,
                                  detect_fn, stride: int, mesh=None):
    """Strided-detector serving over a chunk of multi-stream frames.

    frames [N, S, H, W] (time-major); the detector runs on the frames with
    i % stride == 0 and the steps in between get empty detections (the KCF
    correlation carries the tracks).  N must be a positive multiple of
    stride (serving chunks are sized by the caller), as in the JAX
    package's grouped lowering.  mesh None: one forward over the S frames
    given (on a rank, its own streams: per-shard data parallelism); mesh
    given: the shared detector batch over every rank's streams
    (shared_detector_detect), S being this rank's.
    Returns (banks, StepOutput stacked [S, N, ...]), the axis order of
    multi_stream_sequence, which it equals when fed the same detections.
    """
    n = frames.shape[0]
    if stride < 1 or n % stride:
        raise ValueError(
            f"chunk length {n} must be a positive multiple of "
            f"stride {stride}")
    s_streams = frames.shape[1]
    d_cap = cfg.max_detections
    empty_d = torch.zeros((s_streams, d_cap, 6 if cfg.class_aware else 5),
                          dtype=torch.float32, device=frames.device)
    empty_v = torch.zeros((s_streams, d_cap), dtype=torch.bool,
                          device=frames.device)
    outs = []
    for i in range(n):
        if i % stride == 0:
            d, v = shared_detector_detect(model, frames[i], detect_fn, mesh,
                                          with_classes=cfg.class_aware)
        else:
            d, v = empty_d, empty_v
        banks, out = multi_stream_step(banks, frames[i], d, v, cfg)
        outs.append(out)
    return banks, _stack(outs)


def detect_then_track_step(model, banks: bank_mod.TrackBank,
                           frames: torch.Tensor, cfg: TrackerConfig,
                           detect_fn):
    """The fused detect -> track serving step: one batched detector
    forward over the frames [S, H, W] given, then every stream's tracker on
    its own detections.  On a rank of a mesh: its own streams, no
    collective (the JAX package's per-shard data-parallel mode)."""
    dets, valid, cls = detect_fn(model, frames)
    return multi_stream_step(banks, frames, _fold_classes(dets, cls, cfg),
                             valid, cfg)


def shared_detector_detect(model, frames: torch.Tensor, detect_fn, mesh=None,
                           with_classes: bool = False):
    """The shared detector batch of configs[4]:

        all-gather frames  ->  ONE batched forward  ->  keep this rank's rows

    frames [k, H, W] are this rank's streams.  Over a "stream" mesh of n
    ranks every rank gathers all n*k frames in rank order, runs detect_fn
    over them (the same forward on every rank, as the JAX package's
    shard_map body does) and keeps rows [r*k, (r+1)*k).  Without a mesh
    the frames are all there is: one forward over them.  Returns
    (dets [k, D, 5], valid [k, D]); with_classes appends the class column
    ([k, D, 6], the cfg.class_aware form)."""
    k = frames.shape[0]
    if mesh is not None:
        frames = mesh_mod.all_gather_leading(frames, mesh)
    dets, valid, cls = detect_fn(model, frames)
    if with_classes:
        dets = dets_with_classes(dets, cls)
    if mesh is not None:
        r = mesh.get_local_rank()
        dets, valid = dets[r * k:(r + 1) * k], valid[r * k:(r + 1) * k]
    return dets, valid


def detect_then_track_step_shared(model, banks: bank_mod.TrackBank,
                                  frames: torch.Tensor, cfg: TrackerConfig,
                                  detect_fn, mesh=None):
    """The fused serving step with the shared detector batch over `mesh`
    (without one: the same forward as detect_then_track_step)."""
    dets, valid = shared_detector_detect(model, frames, detect_fn, mesh,
                                         with_classes=cfg.class_aware)
    return multi_stream_step(banks, frames, dets, valid, cfg)


def dryrun_shared_detector(mesh, device=None) -> None:
    """The configs[4] collective path at the JAX package's tiny shapes
    (yolov2-tiny at 64, 2 classes, random weights from seed 0; 8 tracks,
    one 64 x 96 frame a rank), on the calling rank's "stream" mesh: the
    shared-detector step against the per-shard data-parallel step from
    the same banks.  Raises (AssertionError) when this rank's boxes differ
    by more than rtol 1e-5, atol 1e-4 or its ids differ."""
    import numpy as np

    from tpu_mot_torch.models.detector import YoloDetector, detect_batch
    from tpu_mot_torch.models.yolo import YOLOV2_TINY_ANCHORS, YoloSpec

    device = mesh_mod.local_device(device)
    n = mesh.size()
    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, seed=0, device=device, max_out=8,
                                   score_thr=0.0)
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=64,
                        frame_width=96, roi_impl="xla")
    frames = torch.as_tensor(np.random.default_rng(3).random(
        (n, 64, 96)).astype(np.float32), device=device)
    frames = mesh_mod.shard_leading(frames, mesh)

    def detect_fn(model, fr):
        return detect_batch(model, fr, (64, 96), 8, 0.45, 0.0)

    _, shared = detect_then_track_step_shared(
        det.model, make_stream_banks(n, cfg, mesh, device), frames, cfg,
        detect_fn, mesh)
    _, dp = detect_then_track_step(
        det.model, make_stream_banks(n, cfg, mesh, device), frames, cfg,
        detect_fn)
    np.testing.assert_allclose(shared.boxes.cpu().numpy(),
                               dp.boxes.cpu().numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(shared.ids.cpu().numpy(),
                                  dp.ids.cpu().numpy())
