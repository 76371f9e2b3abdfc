"""The YOLOv3 cell (`drivers/detect_yolov3.py`, `reference/yolov3.py`, the
three `yolov3_*` readers) at tiny sizes: a copy of the cell at a 96 px
input with its published widths passes and its control fails, a run with
the detector broken underneath reports correct false, and the readers
split the detector's device time into convolutions and the rest by kernel
name."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.metrics import (step_mfu_pct, yolov3_conv_mfu_pct,
                               yolov3_nonconv_ms_per_step,
                               yolov3_step_mfu_pct)
from portbench.tests import tiny

CELL = "tiny-yolov3"
CONFIG = "yolov3-608-kcf-gray64-t128"


def tiny_yolov3(root, name=CELL):
    """The YOLOv3 cell at 240 x 320: all 75 convs, 80 classes, a 96 px
    input, 16 outputs, 16 track slots."""
    conf = json.loads((root / "portbench" / "configs" /
                       f"{CONFIG}.json").read_text())
    det = dict(conf["detector"], input_size=96, max_out=16)
    tiny.add_cell(root, name, CONFIG, "detect-720p-s128-yolov3",
                  {"detector": det}, tiny.TINY_SERVE,
                  dict(max_tracks=16, max_detections=16, roi_impl="pallas"))
    return name


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.checkout(tmp_path_factory.mktemp("bench"))
    tiny_yolov3(r)
    return r


def _driver(root, seed, device, calls=6):
    import importlib

    spec = run.load_cell(json.loads((root / "BENCHMARK.json").read_text()),
                         CELL, root)
    mod = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    drv = mod.Driver(spec["config"], spec["traffic"], seed, device)
    drv.setup()
    res = run.Reservoir(int(spec["traffic"]["checked_calls"]), seed)
    for _ in range(calls):
        drv.call(res.offer())
    drv.release()
    return drv


def _failed(checks):
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


def test_program_passes_and_control_fails(root):
    drv = _driver(root, 2 ** 31 + 7, torch.device("cpu"))
    assert _failed(drv.check()) == []
    assert _failed(drv.check("control")) != []


@pytest.mark.cuda
def test_control_fails_on_the_card(root, card):
    for seed in (21, 22):
        drv = _driver(root, seed, card)
        assert _failed(drv.check()) == []
        assert _failed(drv.check("control")) != []


def _one_shortcut_dropped(real):
    """YoloV3's forward with the add of stage 3's fourth residual unit
    left out (the unit's output replaces its input)."""
    from tpu_mot_torch.models import yolo

    def forward(self, x):
        b = self._blocks()
        x = next(b)(x)
        routes = []
        for stage, n_res in enumerate((1, 2, 8, 8, 4)):
            x = next(b)(x)
            for i in range(n_res):
                y = next(b)(x)
                y = next(b)(y)
                x = y if (stage, i) == (2, 3) else x + y
            routes.append(x)
        heads, branch = [], x
        for head, route in enumerate((None, routes[3], routes[2])):
            if route is not None:
                branch = torch.cat([yolo._upsample2(next(b)(branch)),
                                    route], dim=1)
            for _ in range(5):
                branch = next(b)(branch)
            heads.append(getattr(self, f"head{head}")(next(b)(branch)))
        return self._out(*heads)
    return forward


def _head2_at_head1s_stride(real):
    return property(lambda self: (32, 16, 16)[:len(self.anchors)])


FAULTS = [("YoloV3", "forward", _one_shortcut_dropped),
          ("YoloSpec", "strides", _head2_at_head1s_stride)]


@pytest.mark.parametrize("cls,attr,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, _, f in FAULTS])
def test_a_broken_detector_is_not_correct(root, cls, attr, fault,
                                          monkeypatch, capsys):
    from tpu_mot_torch.models import yolo

    owner = getattr(yolo, cls)
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    rc = run.main(["--workload", CELL, "--seed", "3000000023", "--seconds",
                   "1", "--trace", "0", "--device", "cpu", "--bench",
                   str(root / "BENCHMARK.json")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["det_mismatch_share"]["value"] > 0.01


def test_the_reference_loads_nothing_of_the_program(root):
    probe = ("import sys; sys.path.insert(0, '.');"
             "import portbench.reference.yolov3;"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'tpu_mot', 'tpu_mot_torch')];"
             "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


# Kernel names as an H100's traces print them (the run's breakdown).
CONV = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tile"
LAYOUT = "void cudnn::ops::nchwToNhwcKernel<float, float, float, false>"
ELEM = "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel"
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>"


def _record():
    ops = [(CONV, "models/yolo", "kernel", 0.200),
           (LAYOUT, "models/yolo", "kernel", 0.010),
           (ELEM, "models/yolo", "kernel", 0.080),
           (CAT, "models/yolo", "kernel", 0.004),
           ("Memcpy HtoD (Pageable -> Device)", "models/yolo", "gpu_memcpy",
            0.001),
           (ELEM, "models/detector", "kernel", 0.003),
           (ELEM, "ops/nms", "kernel", 0.002),
           (ELEM, "tracker/step", "kernel", 0.030),
           ("auction_kernel", "kernels/auction", "kernel", 0.001)]
    return {"calls": 2, "window_s": 0.7, "busy_s": 0.66,
            "step_flops_per_call": 128 * 140.266e9,
            "conv_flops_per_call": 128 * 140.266e9,
            "ops": [{"name": n, "module": m, "cat": c, "s": s}
                    for n, m, c, s in ops]}


def test_readers_split_convs_from_the_rest_by_kernel_name():
    rec = _record()
    # cuDNN's conv and layout kernels: 0.210 s over 2 calls.
    assert yolov3_conv_mfu_pct.read(rec) == pytest.approx(
        2 * 128 * 140.266e9 / (0.210 * 67e12) * 100)
    # models/yolo's own kernels and copy, decode, NMS: 0.090 s, 2 steps.
    assert yolov3_nonconv_ms_per_step.read(rec) == pytest.approx(45.0)
    assert yolov3_step_mfu_pct.read(rec) == step_mfu_pct.read(rec)
    assert yolov3_step_mfu_pct.read(rec) == pytest.approx(
        2 * 128 * 140.266e9 / (0.7 * 67e12) * 100)


def test_readers_report_nothing_without_their_facts():
    rec = _record()
    no_conv = dict(rec, ops=[o for o in rec["ops"]
                             if "at::native" in o["name"]])
    assert yolov3_conv_mfu_pct.read(no_conv) is None
    assert yolov3_nonconv_ms_per_step.read(no_conv) is None
    no_flops = {k: v for k, v in rec.items() if "flops" not in k}
    assert yolov3_conv_mfu_pct.read(no_flops) is None
    assert yolov3_step_mfu_pct.read(no_flops) is None
    assert yolov3_nonconv_ms_per_step.read(no_flops) == pytest.approx(45.0)
