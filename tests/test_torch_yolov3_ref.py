"""The port's full YOLOv3 (tpu_mot_torch.models.yolo.YoloV3) against the
benchmark's plain reference (portbench/reference/yolov3.py) on the CPU, at
its published widths (80 classes, all 75 convs) and small inputs, on the
seeded weights the benchmark draws (portbench/drivers/detect.weights,
BatchNorm statistics calibrated by the reference); plus the reference's
conv list against darknet's published FLOP counts, the program's counters
of detector work and its spans inside `detector.forward`.

Tolerances:
  heads      max |diff| <= 1e-5 of the head's largest |value|: float32
             convs sum in orders the backend picks (oneDNN with several
             threads differs in the last bits), over 75 layers and 23
             shortcut adds; a head is O(1), so this is ~100 ulps;
  detect     same classes, boxes within 1e-4 px, scores within 1e-6,
             matched as sets (benchmark's match_sets) at 96 with score_thr
             0.3: rounding of that size moves no decision on these frames;
  FLOPs      darknet prints 140.692 / 65.864 BFLOPs for yolov3.cfg at
             608 / 416 (RGB), to 3 decimals: within 0.01%.
"""

import json

import pytest
import torch

from portbench import gen
from portbench.drivers.detect import match_sets, weights
from portbench.reference import yolov3 as ref
from tpu_mot_torch.models import detector as t_det
from tpu_mot_torch.models import yolo as t_yolo
from tpu_mot_torch.utils import profiling

torch.set_num_threads(1)

SEED = 2 ** 31 + 20


def _spec(size, name="yolov3"):
    return t_yolo.YoloSpec(name, num_classes=80, input_size=size)


def _frames(n, seed=SEED, hw=(120, 160)):
    """n gray u8 frames of the benchmark's generator (objects on noise)."""
    return gen.render(seed, n, 1, *hw, 12, 16, 40, 3.0, 0.01, 12,
                      "cpu").frames[0]


_PARAMS = {}


def _params(size, name="yolov3"):
    """Seeded weights as the benchmark draws them; yolov3's BatchNorm
    statistics calibrated on four frames by the reference."""
    if (size, name) not in _PARAMS:
        with torch.device("meta"):
            shapes = [(k, tuple(v.shape)) for k, v in
                      t_yolo.build_model(_spec(size, name)).state_dict()
                      .items()]
        p = weights(shapes, SEED, torch.device("cpu"))
        if name == "yolov3":
            p = ref.calibrate(p, _frames(4, SEED + 1), size)
        _PARAMS[size, name] = p
    return _PARAMS[size, name]


def _model(size, name="yolov3"):
    return t_det.YoloDetector(_spec(size, name), _params(size, name),
                              device="cpu").model


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
def test_heads_equal_the_reference(size, gray):
    frames = _frames(2)
    if not gray:
        g = torch.Generator().manual_seed(SEED)
        frames = torch.stack([frames, torch.randint(0, 256, frames.shape,
                                                    generator=g,
                                                    dtype=torch.uint8),
                              frames.flip(-1)], dim=-1)
    spec = _spec(size)
    with torch.no_grad():
        got = _model(size)(t_det.preprocess(frames, spec))
        want = ref.heads(_params(size), frames, size)
    assert len(got) == 3
    for g_, w_, stride in zip(got, want, ref.STRIDES):
        assert g_.shape == w_.shape == (2, size // stride, size // stride,
                                        255)
        scale = float(w_.abs().amax())
        if gray:        # calibrated on gray frames: neither 0 nor 1e4
            assert 0.5 < scale < 100.0
        assert float((g_ - w_).abs().amax()) <= 1e-5 * scale


def test_detect_batch_equals_the_reference_as_sets():
    frames = _frames(3)
    hw = tuple(frames.shape[1:])
    got = t_det.detect_batch(_model(96), frames, hw, 64, 0.45, 0.3)
    want = ref.detect(_params(96), frames, hw, 64, size=96)
    assert int(want[1].sum()) > 3 * 20
    unmatched, box_gap, score_gap = match_sets(*got, *want, 1.0)
    assert unmatched == 0
    assert box_gap <= 1e-4 and score_gap <= 1e-6
    for b in range(3):
        assert sorted(got[2][b][got[1][b]].tolist()) == sorted(
            want[2][b][want[1][b]].tolist())


@pytest.mark.parametrize("size,gray,gflop", [(608, False, 140.692),
                                             (416, False, 65.864),
                                             (608, True, 140.266)])
def test_conv_list_gives_darknets_flops(size, gray, gflop):
    assert len(ref.conv_layers(size, gray)) == 75
    assert ref.conv_flops(size, gray) / 1e9 == pytest.approx(gflop,
                                                             rel=1e-4)


def test_conv_list_is_the_ports_topology():
    """The reference's (cin, cout, k) list, written from the cfg, is the
    port's conv list in construction order."""
    port = [(ci, co, kh) for _, (kh, _, ci, co), _ in
            t_yolo.layer_shapes(_spec(608))]
    assert port == [(ci, co, k) for ci, co, k, _ in
                    ref.conv_layers(608, gray=False)]


def test_forward_counts_23_shortcuts():
    model = _model(64)
    before = t_yolo.shortcuts
    with torch.no_grad():
        model(t_det.preprocess(_frames(2), _spec(64)))
        assert t_yolo.shortcuts - before == 23
        model(t_det.preprocess(_frames(1), _spec(64)))
    assert t_yolo.shortcuts - before == 46


@pytest.mark.parametrize("batch", [1, 3])
def test_decode_counts_the_candidates(batch):
    before = t_det.candidates
    boxes, scores, _ = t_det.decode_frames(_model(96), _frames(batch),
                                           (120, 160))
    assert scores.shape == (batch, 567)     # 3 x (3^2 + 6^2 + 12^2)
    assert t_det.candidates - before == batch * 567


def _spans(path):
    """(name, parent name) of the detector's spans in a Chrome trace."""
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"]
               if e.get("ph") == "X" and e.get("cat") == "user_annotation"
               and e["name"].startswith("detector.")]
    out, stack = [], []
    for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        out.append((e["name"], stack[-1]["name"] if stack else None))
        stack.append(e)
    return out


@pytest.mark.parametrize("name,heads", [("yolov3", 3), ("yolov3-tiny", 2),
                                        ("yolov2", 1), ("yolov2-tiny", 1)])
def test_forward_spans_nest_in_detector_forward(tmp_path, name, heads):
    model = _model(64, name)
    with profiling.trace(str(tmp_path)):
        t_det.detect_batch(model, _frames(1), (120, 160), 8)
    spans = _spans(tmp_path / profiling.TRACE_NAME)
    inner = [("detector.backbone", "detector.forward")] + [
        (f"detector.head{i}", "detector.forward") for i in range(heads)]
    assert spans == ([("detector.detect", None),
                      ("detector.preprocess", "detector.detect"),
                      ("detector.forward", "detector.detect")] + inner
                     + [("detector.decode", "detector.detect"),
                        ("detector.nms", "detector.detect")])
