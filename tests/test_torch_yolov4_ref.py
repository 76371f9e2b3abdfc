"""The port's YOLOv4 (tpu_mot_torch.models.yolo.YoloV4) against the
benchmark's plain reference (portbench/reference/yolov4.py) on the CPU, at
its published widths (80 classes, all 110 convs) and small inputs, on the
seeded weights the benchmark draws (portbench/drivers/detect.weights,
BatchNorm statistics calibrated by the reference); plus the reference's
conv list against darknet's published FLOP counts, the grid-sensitive
decode, the darknet weights layout, the program's counters of detector
work and its spans inside `detector.forward`.  The JAX package has no
YOLOv4: the reference is the yardstick here.

Tolerances:
  heads      max |diff| <= 1e-5 of the head's largest |value|: float32
             convs sum in orders the backend picks, over 110 layers and 23
             shortcut adds (on one CPU thread both sides run the same
             operations and agree to the bit);
  detect     same classes, boxes within 1e-4 px, scores within 1e-6,
             matched as sets (benchmark's match_sets) at 96 with score_thr
             0.3;
  FLOPs      darknet prints 128.459 / 60.137 BFLOPs for yolov4.cfg at
             608 / 416 (RGB, its max pools and shortcuts counted), to 3
             decimals: within 0.01%;
  decode     the grid-sensitive centre against darknet's formula written
             out, within 1e-4 px (float32 rounding of a different order).
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import gen
from portbench.drivers.detect import match_sets, weights
from portbench.reference import yolov4 as ref
from tpu_mot_torch.models import detector as t_det
from tpu_mot_torch.models import epilogue as t_epi
from tpu_mot_torch.models import yolo as t_yolo
from tpu_mot_torch.utils import profiling

torch.set_num_threads(1)

SEED = 2 ** 31 + 24


def _spec(size, **kw):
    return t_yolo.YoloSpec("yolov4", num_classes=80, input_size=size, **kw)


def _frames(n, seed=SEED, hw=(120, 160)):
    """n gray u8 frames of the benchmark's generator (objects on noise)."""
    return gen.render(seed, n, 1, *hw, 12, 16, 40, 3.0, 0.01, 12,
                      "cpu").frames[0]


def _rgb(frames):
    g = torch.Generator().manual_seed(SEED)
    return torch.stack([frames, torch.randint(0, 256, frames.shape,
                                              generator=g,
                                              dtype=torch.uint8),
                        frames.flip(-1)], dim=-1)


_PARAMS = {}


def _params(size):
    """Seeded weights as the benchmark draws them, the BatchNorm statistics
    calibrated on four frames by the reference."""
    if size not in _PARAMS:
        with torch.device("meta"):
            shapes = [(k, tuple(v.shape)) for k, v in
                      t_yolo.build_model(_spec(size)).state_dict().items()]
        p = weights(shapes, SEED, torch.device("cpu"))
        _PARAMS[size] = ref.calibrate(p, _frames(4, SEED + 1), size)
    return _PARAMS[size]


def _model(size):
    return t_det.YoloDetector(_spec(size), _params(size),
                              device="cpu").model


def _close(got, want, size):
    assert len(got) == len(want) == 3
    for g_, w_, stride in zip(got, want, ref.STRIDES):
        assert g_.shape == w_.shape == (w_.shape[0], size // stride,
                                        size // stride, 255)
        scale = float(w_.abs().amax())
        assert float((g_ - w_).abs().amax()) <= 1e-5 * scale


@pytest.mark.parametrize("size", [64, 96])
@pytest.mark.parametrize("gray", [True, False], ids=["gray", "rgb"])
def test_heads_equal_the_reference(size, gray):
    frames = _frames(2) if gray else _rgb(_frames(2))
    with torch.no_grad():
        got = _model(size)(t_det.preprocess(frames, _spec(size)))
        want = ref.heads(_params(size), frames, size)
    _close(got, want, size)


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


@pytest.mark.parametrize("size,gray,gflop,darknet", [
    (608, False, 128.389, 128.459), (416, False, 60.105, 60.137),
    (608, True, 127.964, None), (416, True, 59.905, None)])
def test_conv_list_gives_darknets_flops(size, gray, gflop, darknet):
    assert ref.conv_flops(size, gray) / 1e9 == pytest.approx(gflop,
                                                             rel=1e-4)
    if darknet is not None:
        assert (ref.conv_flops(size, gray) + ref.other_flops(size)) / 1e9 \
            == pytest.approx(darknet, rel=1e-4)


def test_conv_list_counts_the_cfgs_layers():
    layers = ref.conv_layers(608, gray=False)
    acts = [act for *_, act, _ in layers]
    assert len(layers) == 110
    assert (acts.count("mish"), acts.count("leaky"),
            acts.count("linear")) == (72, 35, 3)
    assert acts[:72] == ["mish"] * 72
    assert sum(skip for *_, skip in layers) == 23
    # every BatchNorm output read and written, every skip read: 124.6 GB at
    # the cell's 128 frames
    assert 128 * ref.epilogue_bytes(608) / 1e9 == pytest.approx(124.633,
                                                                rel=1e-4)


def test_conv_list_is_the_ports_topology():
    """The reference's (cin, cout, k, activation) list, written from the
    cfg, is the port's conv list in construction order."""
    spec = _spec(608)
    with torch.device("meta"):
        model = t_yolo.build_model(spec)
    port = [(ci, co, kh, (model.get_submodule(name).act or "linear"))
            for name, (kh, _, ci, co), _ in t_yolo.layer_shapes(spec)]
    assert port == [(ci, co, k, act) for ci, co, k, _, act, _ in
                    ref.conv_layers(608, gray=False)]


def test_forward_counts_23_shortcuts_and_72_mish_blocks():
    model = _model(64)
    mish = []
    for blk in model.children():
        if blk.act == "mish":
            blk.register_forward_hook(lambda *_: mish.append(1))
    before = (t_yolo.shortcuts, t_epi.chain_blocks)
    with torch.no_grad():
        model(t_det.preprocess(_frames(2), _spec(64)))
    assert (t_yolo.shortcuts - before[0], len(mish),
            t_epi.chain_blocks - before[1]) == (23, 72, 107)


def test_decode_counts_the_candidates():
    before = t_det.candidates
    _, scores, _ = t_det.decode_frames(_model(96), _frames(2), (120, 160))
    assert scores.shape == (2, 567)         # 3 x (3^2 + 6^2 + 12^2)
    assert t_det.candidates - before == 2 * 567


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


def test_forward_spans_nest_in_detector_forward(tmp_path):
    with profiling.trace(str(tmp_path)):
        t_det.detect_batch(_model(64), _frames(1), (120, 160), 8)
    inner = [(f"detector.{s}", "detector.forward") for s in
             ("backbone", "spp", "pan", "head2", "head1", "head0")]
    assert _spans(tmp_path / profiling.TRACE_NAME) == (
        [("detector.detect", None),
         ("detector.preprocess", "detector.detect"),
         ("detector.forward", "detector.detect")] + inner
        + [("detector.decode", "detector.detect"),
           ("detector.nms", "detector.detect")])


def _raw(seed, hg=5, wg=7, a=3, c=80):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((2, hg, wg, a * (5 + c)), generator=g) * 3


@pytest.mark.parametrize("s", [1.05, 1.1, 1.2])
def test_decode_head_grid_sensitivity_is_darknets(s):
    """darknet's forward_yolo_layer: x <- sigmoid(t) * s - 0.5 * (s - 1),
    then (column + x) / lw of the input width."""
    raw = _raw(int(s * 100))
    anchors = ref.ANCHORS[0]
    boxes, scores, classes = t_yolo.decode_head(raw, anchors, 32, 80, 224,
                                                cls_act="sigmoid",
                                                scale_xy=s)
    plain = t_yolo.decode_head(raw, anchors, 32, 80, 224, cls_act="sigmoid")
    r = raw.double().reshape(2, 5, 7, 3, 85)
    x = torch.sigmoid(r[..., 0]) * s - 0.5 * (s - 1)
    y = torch.sigmoid(r[..., 1]) * s - 0.5 * (s - 1)
    col = torch.arange(7, dtype=torch.float64)[None, None, :, None]
    row = torch.arange(5, dtype=torch.float64)[None, :, None, None]
    want_x = ((col + x) / 7 * 224).reshape(2, -1)
    want_y = ((row + y) / 5 * 160).reshape(2, -1)
    assert float((boxes[..., 0] - want_x).abs().max()) <= 1e-4
    assert float((boxes[..., 1] - want_y).abs().max()) <= 1e-4
    # only the centres move; the boxes reach s/2 - 1/2 cells further out
    assert torch.equal(boxes[..., 2:], plain[0][..., 2:])
    assert torch.equal(scores, plain[1]) and torch.equal(classes, plain[2])
    lo = (boxes[..., 0] / 32 - torch.arange(7).repeat_interleave(3)
          .repeat(5)).min()
    assert float(lo) < 0.0


@pytest.mark.parametrize("name,cls_act", [("yolov3", "sigmoid"),
                                          ("yolov2", "softmax")])
def test_decode_head_at_one_is_the_plain_decode(name, cls_act):
    """scale_xy 1.0 adds no operation: bit for bit the decode without it
    (sigmoid xy plus the cell, times the stride)."""
    spec = t_yolo.YoloSpec(name, num_classes=80)
    assert spec.scale_x_y == (1.0,) * len(spec.anchors)
    assert spec.cls_activation == cls_act
    a = len(spec.anchors[0])
    raw = _raw(3, a=a)
    got = t_yolo.decode_head(raw, spec.anchors[0], 32, 80, 224, cls_act,
                             scale_xy=1.0)
    want = t_yolo.decode_head(raw, spec.anchors[0], 32, 80, 224, cls_act)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    r = raw.reshape(2, 5, 7, a, 85)
    col = torch.arange(7, dtype=torch.float32)[None, None, :, None]
    assert torch.equal(got[0][..., 0], ((col + torch.sigmoid(r[..., 0]))
                                        * 32).reshape(2, -1))


def test_spec():
    spec = _spec(608)
    assert spec.anchors == ref.ANCHORS == t_yolo.YOLOV4_ANCHORS
    assert spec.strides == ref.STRIDES
    assert spec.scale_x_y == ref.SCALE_X_Y
    assert spec.cls_activation == "sigmoid"
    for train in (False, True):
        assert t_yolo.resolved_stem(spec, train, (608, 608)) == "direct"
    with pytest.raises(ValueError, match="yolov4's strided-conv stem"):
        _spec(608, stem="s2d4")
    assert t_yolo.resolved_stem(_spec(608, stem="direct")) == "direct"


def test_darknets_softplus_threshold_changes_no_float32_value():
    """Darknet's softplus returns x above 20 and exp(x) below -20, where
    the reference's Mish (F.mish) takes log1p(exp(x)) everywhere: below
    -20 log1p(exp(x)) is exp(x) to the bit (checked down to -80: within a
    few times float32's smallest normal the CPU's vectorised log1p loses
    bits), above 20 tanh of either is 1."""
    lo = torch.linspace(-80.0, -20.0, 20001)
    e = torch.exp(lo)
    assert torch.equal(torch.log1p(e).view(torch.int32), e.view(torch.int32))
    hi = torch.linspace(20.0, 88.0, 20001)
    assert torch.equal(torch.tanh(hi), torch.ones_like(hi))
    assert torch.equal(torch.tanh(torch.log1p(torch.exp(hi))),
                       torch.ones_like(hi))
    assert torch.equal(F.mish(hi), hi)


def test_darknet_weights_file_loads_in_cfg_order(tmp_path):
    """A .weights file written in cfg/yolov4.cfg's order from the
    reference's conv list loads through load_darknet_weights and gives the
    reference's heads."""
    rng = np.random.default_rng(5)
    layers = ref.conv_layers(64, gray=False)
    names, bn_i, head_i = [], 0, iter((2, 1, 0))
    for *_, act, _ in layers:
        if act == "linear":
            names.append(f"head{next(head_i)}")
        else:
            names.append(f"ConvBlock_{bn_i}")
            bn_i += 1
    p, chunks = {}, [np.array([0, 2, 5], np.int32).tobytes(),
                     np.array([64000], np.int64).tobytes()]
    for name, (ci, co, k, _, act, _) in zip(names, layers):
        w = (rng.standard_normal((co, ci, k, k))
             / np.sqrt(ci * k * k)).astype(np.float32)
        if act == "linear":
            fields = {"conv.bias": 0.1 * rng.standard_normal(co)}
        else:
            fields = {"bn.bias": 0.1 * rng.standard_normal(co),
                      "bn.weight": rng.uniform(0.5, 1.5, co),
                      "bn.running_mean": 0.1 * rng.standard_normal(co),
                      "bn.running_var": rng.uniform(0.5, 1.5, co)}
        for key, v in fields.items():
            v = v.astype(np.float32)
            chunks.append(v.tobytes())
            p[f"{name}.{key}"] = torch.as_tensor(v)
        chunks.append(w.tobytes())
        p[f"{name}.conv.weight"] = torch.as_tensor(w)
    path = tmp_path / "yolov4.weights"
    path.write_bytes(b"".join(chunks))
    det = t_det.YoloDetector.from_darknet(_spec(64), str(path),
                                          device="cpu")
    frames = _rgb(_frames(2))
    with torch.no_grad():
        got = det.model(t_det.preprocess(frames, _spec(64)))
        want = ref.heads(p, frames, 64)
    _close(got, want, 64)
    with pytest.raises(ValueError, match="truncated"):
        path.write_bytes(b"".join(chunks)[:-4])
        t_det.load_darknet_weights(_spec(64), str(path))
