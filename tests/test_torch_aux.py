"""The port's aux modules (tpu_mot_torch.utils.supervisor, .profiling)
against their JAX counterparts' behaviour: the ports of
tests/test_aux.py:24-97 on device="cpu", output_healthy agreeing with
JAX's on the same outputs, and the program's spans in a torch.profiler
capture."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_config import both_configs
from tpu_mot.tracker import bank as j_bank
from tpu_mot.tracker import step as j_step
from tpu_mot.utils import supervisor as j_sup
from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.tracker.api import pad_detections
from tpu_mot_torch.utils import profiling
from tpu_mot_torch.utils.profiling import DeviceTimer, FpsMeter
from tpu_mot_torch.utils.supervisor import StreamSupervisor, output_healthy

torch.set_num_threads(1)


def _scene(n_frames=12):
    rng = np.random.default_rng(0)
    objs = synthetic.make_objects(4, 120, 160, rng)
    frames, boxes, vis = synthetic.render_sequence(objs, n_frames, 120,
                                                   160, seed=0)
    dets = synthetic.detections_from_gt(boxes, vis, seed=0,
                                        frame_hw=(120, 160))
    return frames, dets


def _cfg(**kw):
    return TrackerConfig(max_tracks=8, max_detections=8, frame_height=120,
                         frame_width=160, **kw)


def test_supervisor_normal_flow():
    frames, dets = _scene()
    sup = StreamSupervisor(_cfg(n_init=1), snapshot_every=4, device="cpu")
    for f in range(len(frames)):
        d, v = pad_detections(dets[f], 8)
        out = sup.step(frames[f], d, v)
    assert sup.failures == 0
    assert int(out.n_alive) == 4


def test_supervisor_recovers_from_poisoned_state():
    frames, dets = _scene()
    sup = StreamSupervisor(_cfg(n_init=1), snapshot_every=2, device="cpu")
    for f in range(6):
        d, v = pad_detections(dets[f], 8)
        sup.step(frames[f], d, v)
    snap = sup._snapshot.kf_mean.clone()
    # Poison the live bank (simulated corruption / device fault).
    kf = sup.bank.kf_mean.clone()
    kf[:, 0] = float("nan")
    sup.bank = sup.bank._replace(kf_mean=kf)
    d, v = pad_detections(dets[6], 8)
    out = sup.step(frames[6], d, v)
    assert sup.failures == 1 and sup.last_recovery_frame == 6
    assert torch.isfinite(out.boxes).all()
    # the snapshot is a copy the poison did not reach
    assert torch.isfinite(snap).all()
    # Keeps tracking afterwards.
    for f in range(7, len(frames)):
        d, v = pad_detections(dets[f], 8)
        out = sup.step(frames[f], d, v)
    assert int(out.n_alive) >= 4
    assert sup.failures == 1


def test_supervisor_skips_a_poisoned_frame():
    """A NaN frame is an input fault: the stream keeps its snapshot and
    emits an output without valid tracks; the next frame tracks again."""
    frames, dets = _scene()
    sup = StreamSupervisor(_cfg(n_init=1), snapshot_every=1, device="cpu")
    for f in range(4):
        d, v = pad_detections(dets[f], 8)
        sup.step(frames[f], d, v)
    d, v = pad_detections(dets[4], 8)
    bad = np.full_like(frames[4], np.nan)
    d_bad = d.copy()
    d_bad[:, :4] = np.nan
    out = sup.step(bad, d_bad, v)
    assert sup.failures == 1 and output_healthy(out, (120, 160))
    out = sup.step(frames[5], *pad_detections(dets[5], 8))
    assert sup.failures == 1 and int(out.n_alive) >= 4


def test_supervisor_defaults_to_the_card():
    if torch.cuda.is_available():
        assert StreamSupervisor(_cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            StreamSupervisor(_cfg())


def test_output_healthy_flags_nans_and_agrees_with_jax():
    frames, dets = _scene(2)
    jcfg, tcfg = both_configs(max_tracks=8, max_detections=8,
                              frame_height=120, frame_width=160, n_init=1)
    d, v = pad_detections(dets[0], 8)
    sup = StreamSupervisor(tcfg, device="cpu")
    sup.step(frames[0], d, v)
    out = sup.step(frames[1], *pad_detections(dets[1], 8))
    assert out.valid.any()
    _, jout = j_step.step(j_bank.empty_bank(jcfg), jnp.asarray(frames[0]),
                          jnp.asarray(d), jnp.asarray(v), jcfg)
    assert output_healthy(out, (120, 160))
    boxes = out.boxes.clone()
    boxes[0, 0] = float("nan")
    far = out.boxes.clone()
    far[out.valid.nonzero()[0, 0], 0] = 1e5
    for boxes_case, healthy in ((out.boxes, True), (boxes, False),
                                (far, False)):
        case = out._replace(boxes=boxes_case)
        jcase = jout._replace(boxes=jnp.asarray(boxes_case.numpy()),
                              valid=jnp.asarray(out.valid.numpy()))
        assert output_healthy(case, (120, 160)) is healthy
        assert j_sup.output_healthy(jcase, (120, 160)) is healthy


def test_fault_injection_hooks():
    """detections_from_gt exposes drop/false-positive injection."""
    rng = np.random.default_rng(1)
    objs = synthetic.make_objects(6, 120, 160, rng)
    _, boxes, vis = synthetic.render_sequence(objs, 20, 120, 160, seed=1)
    clean = synthetic.detections_from_gt(boxes, vis, seed=1,
                                         frame_hw=(120, 160))
    faulty = synthetic.detections_from_gt(boxes, vis, seed=1,
                                          drop_prob=0.5, fp_per_frame=2.0,
                                          frame_hw=(120, 160))
    assert sum(len(d) for d in faulty) != sum(len(d) for d in clean)


def test_device_timer_and_fps_meter():
    with DeviceTimer() as t:
        x = torch.ones((256, 256)) @ torch.ones((256, 256))
        t.observe({"x": [x]})
    assert t.elapsed > 0
    m = FpsMeter()
    for _ in range(5):
        m.tick(2)
    assert m.n_frames == 10
    assert m.stats()["frames"] == 10 and m.fps > 0


STAGES = ["tracker.frames", "tracker.predict", "tracker.kcf_detect",
          "tracker.cost", "tracker.assign", "tracker.correct",
          "tracker.lifecycle", "tracker.kcf_train"]


def _spans(path):
    """(name, parent name or None) of each of the program's spans in a
    written Chrome trace, in start order; the parent is the innermost span
    that encloses it on its thread."""
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and e["name"].split(".")[0] in ("serve", "detector",
                                               "tracker")]
    out, stack = [], []
    for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        out.append((e["name"], stack[-1]["name"] if stack else None))
        stack.append(e)
    return out


def _traced(tmp_path, fn):
    with profiling.trace(str(tmp_path)):
        fn()
    return _spans(tmp_path / profiling.TRACE_NAME)


def _tiny_streams(**kw):
    """2 streams x 8 slots at 64 x 96 on the gather path, one detection a
    stream."""
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=64,
                        frame_width=96, roi_impl="xla", **kw)
    frames = torch.rand((2, 64, 96),
                        generator=torch.Generator().manual_seed(0))
    dets = torch.tensor([[30.0, 30.0, 12.0, 14.0, 0.9]]).repeat(2, 8, 1)
    valid = torch.zeros((2, 8), dtype=torch.bool)
    valid[:, 0] = True
    return cfg, frames, dets, valid


def test_span_without_a_capture_is_one_shared_null_context(monkeypatch):
    """With no profiler running, span() makes no record_function: it gives
    the one shared null context, whatever the name."""
    made = []
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: made.append(name))
    a, b = profiling.span("tracker.step"), profiling.span("serve.step")
    assert a is b
    with a:
        with b:
            pass
    assert made == []
    from torch.profiler import profile
    with profile():
        profiling.span("tracker.step")
    assert made == ["tracker.step"]


@pytest.mark.parametrize("scale_step", [1.0, 1.05])
def test_step_streams_records_the_eight_stages_in_order(tmp_path,
                                                        scale_step):
    """Two steps of a tiny step_streams under torch.profiler: tracker.step
    once a step, its eight stage spans inside it in stage order (unit
    scale, and the 3-scale search's branch of tracker.kcf_detect)."""
    from tpu_mot_torch.config import KCFConfig
    from tpu_mot_torch.tracker import step as step_mod
    from tpu_mot_torch.tracker.bank import empty_bank, map_bank

    cfg, frames, dets, valid = _tiny_streams(
        kcf=KCFConfig(scale_step=scale_step))
    one = empty_bank(cfg, device="cpu")
    bank = map_bank(lambda x: x[None].expand((2,) + x.shape).clone(), one)

    def two_steps():
        b = bank
        for _ in range(2):
            b, _ = step_mod.step_streams(b, frames, dets, valid, cfg)

    spans = _traced(tmp_path, two_steps)
    one_step = [("tracker.step", None)] + [(s, "tracker.step")
                                           for s in STAGES]
    assert spans == one_step * 2


@pytest.mark.parametrize("shared", [False, True])
def test_detect_then_track_records_the_detector_then_the_tracker(tmp_path,
                                                                 shared):
    """The fused step at dryrun_shared_detector's tiny shapes: serve.detect
    holds detector.detect and its four stages (the net's backbone and head
    inside detector.forward), then serve.step holds tracker.step."""
    from tpu_mot_torch.models.detector import YoloDetector, detect_batch
    from tpu_mot_torch.models.yolo import YOLOV2_TINY_ANCHORS, YoloSpec
    from tpu_mot_torch.parallel import serve

    spec = YoloSpec("yolov2-tiny", num_classes=2, input_size=64,
                    anchors=YOLOV2_TINY_ANCHORS)
    det = YoloDetector.random_init(spec, seed=0, device="cpu", max_out=8,
                                   score_thr=0.0)
    cfg, frames, _, _ = _tiny_streams()
    banks = serve.make_stream_banks(2, cfg, device="cpu")

    def detect_fn(model, fr):
        return detect_batch(model, fr, (64, 96), 8, 0.45, 0.0)

    def fused():
        if shared:
            serve.detect_then_track_step_shared(det.model, banks, frames,
                                                cfg, detect_fn)
        else:
            serve.detect_then_track_step(det.model, banks, frames, cfg,
                                         detect_fn)

    spans = _traced(tmp_path, fused)
    assert spans[:8] == [
        ("serve.detect", None), ("detector.detect", "serve.detect"),
        ("detector.preprocess", "detector.detect"),
        ("detector.forward", "detector.detect"),
        ("detector.backbone", "detector.forward"),
        ("detector.head0", "detector.forward"),
        ("detector.decode", "detector.detect"),
        ("detector.nms", "detector.detect")]
    assert spans[8:10] == [("serve.step", None),
                           ("tracker.step", "serve.step")]
    assert [n for n, _ in spans[10:]] == STAGES


def test_trace_writes_the_programs_spans(tmp_path):
    """trace() writes a Chrome trace that holds the program's spans: a
    serving step is serve.step around tracker.step and its stages."""
    from tpu_mot_torch.parallel import serve

    cfg, frames, dets, valid = _tiny_streams()
    banks = serve.make_stream_banks(2, cfg, device="cpu")
    with profiling.trace(str(tmp_path / "run")):
        serve.multi_stream_step(banks, frames, dets, valid, cfg)
    path = tmp_path / "run" / profiling.TRACE_NAME
    assert path.exists()
    assert _spans(path) == ([("serve.step", None),
                             ("tracker.step", "serve.step")]
                            + [(s, "tracker.step") for s in STAGES])
