"""The YOLOv4 cell (`drivers/detect_yolov4.py`, `reference/yolov4.py`, the
four `yolov4_*` readers) at tiny sizes: a copy of the cell at a 96 px
input with its published widths passes and its control fails, a run with
the detector broken underneath (a Mish block run as leaky ReLU, the grid
sensitivity dropped, the SPP concat in the reverse order) reports correct
false, and the readers split the detector's device time into convolutions
and the rest, and K7's time against its bytes, by kernel name."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.metrics._yolov3 import is_conv
from portbench.metrics import (step_mfu_pct, yolov4_conv_mfu_pct,
                               yolov4_epilogue_roofline_pct,
                               yolov4_nonconv_ms_per_step,
                               yolov4_step_mfu_pct)
from portbench.tests import tiny

CELL = "tiny-yolov4"
CONFIG = "yolov4-608-kcf-gray64-t128"


def tiny_yolov4(root, name=CELL):
    """The YOLOv4 cell at 240 x 320: all 110 convs, 80 classes, a 96 px
    input, 16 outputs, 16 track slots."""
    conf = json.loads((root / "portbench" / "configs" /
                       f"{CONFIG}.json").read_text())
    det = dict(conf["detector"], input_size=96, max_out=16)
    tiny.add_cell(root, name, CONFIG, "detect-720p-s128-yolov4",
                  {"detector": det}, tiny.TINY_SERVE,
                  dict(max_tracks=16, max_detections=16, roi_impl="pallas"))
    return name


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.checkout(tmp_path_factory.mktemp("bench"))
    tiny_yolov4(r)
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
    drv = _driver(root, 2 ** 31 + 9, torch.device("cpu"))
    assert _failed(drv.check()) == []
    assert _failed(drv.check("control")) != []


@pytest.mark.cuda
def test_control_fails_on_the_card(root, card):
    for seed in (23, 24):
        drv = _driver(root, seed, card)
        assert _failed(drv.check()) == []
        assert _failed(drv.check("control")) != []


def _one_mish_block_as_leaky(real):
    """Stage 2's second residual unit's 3x3 conv runs leaky ReLU."""
    def init(self, spec):
        real(self, spec)
        self.ConvBlock_14.act = "leaky"
    return init


def _no_grid_sensitivity(real):
    return property(lambda self: (1.0,) * len(self.anchors))


def _spp_reversed(real):
    from tpu_mot_torch.models import yolo

    def spp(x):
        return torch.cat([x] + [yolo.F.max_pool2d(x, k, 1, k // 2)
                                for k in (5, 9, 13)], dim=1)
    return spp


FAULTS = [("YoloV4", "__init__", _one_mish_block_as_leaky),
          ("YoloSpec", "scale_x_y", _no_grid_sensitivity),
          (None, "_spp", _spp_reversed)]


@pytest.mark.parametrize("cls,attr,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, _, f in FAULTS])
def test_a_broken_detector_is_not_correct(root, cls, attr, fault,
                                          monkeypatch, capsys):
    from tpu_mot_torch.models import yolo

    owner = yolo if cls is None else getattr(yolo, cls)
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    rc = run.main(["--workload", CELL, "--seed", "3000000024", "--seconds",
                   "1", "--trace", "0", "--device", "cpu", "--bench",
                   str(root / "BENCHMARK.json")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
    det = {k: c for k, c in res["checks"].items() if k.startswith("det_")}
    assert _failed(det), det


def test_the_reference_loads_nothing_of_the_program(root):
    probe = ("import sys; sys.path.insert(0, '.');"
             "import portbench.reference.yolov4;"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'flax', 'tpu_mot', 'tpu_mot_torch')];"
             "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


# Kernel names as an H100's traces print them (the run's breakdown).
CONV = "sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw_tile"
LAYOUT = "void cudnn::ops::nchwToNhwcKernel<float, float, float, false>"
K7_MISH = ("void (anonymous namespace)::epilogue_kernel<float4, false, 1>"
           "(float4*, float4 const*, float const*, float const*, float "
           "const*, long long, int, int, int)")
K7_LEAKY = ("void (anonymous namespace)::epilogue_kernel<float4, true, 0>"
            "(float4*, float4 const*, float const*, float const*, float "
            "const*, long long, int, int, int)")
POOL = ("void at::native::(anonymous namespace)::max_pool_forward_nchw"
        "<float, float>")
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>"
ELEM = "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel"


def _record():
    ops = [(CONV, "models/yolo", "kernel", 0.400),
           (LAYOUT, "models/yolo", "kernel", 0.010),
           (K7_MISH, "models/epilogue", "kernel", 0.030),
           (K7_LEAKY, "models/epilogue", "kernel", 0.010),
           (POOL, "models/yolo", "kernel", 0.004),
           (CAT, "models/yolo", "kernel", 0.004),
           (ELEM, "models/detector", "kernel", 0.001),
           (ELEM, "ops/nms", "kernel", 0.001),
           (ELEM, "tracker/step", "kernel", 0.014),
           ("auction_kernel", "kernels/auction", "kernel", 0.001)]
    return {"calls": 2, "window_s": 1.0, "busy_s": 0.95,
            "step_flops_per_call": 128 * 127.964e9,
            "conv_flops_per_call": 128 * 127.964e9,
            "epilogue_bytes_per_call": 124.633e9,
            "ops": [{"name": n, "module": m, "cat": c, "s": s}
                    for n, m, c, s in ops]}


def test_readers_split_convs_from_the_rest_by_kernel_name():
    rec = _record()
    # cuDNN's conv and layout kernels: 0.410 s over 2 calls.
    assert yolov4_conv_mfu_pct.read(rec) == pytest.approx(
        2 * 128 * 127.964e9 / (0.410 * 67e12) * 100)
    # K7, the pools, concat, decode, NMS: 0.050 s over 2 steps.
    assert yolov4_nonconv_ms_per_step.read(rec) == pytest.approx(25.0)
    assert yolov4_step_mfu_pct.read(rec) == step_mfu_pct.read(rec)
    assert yolov4_step_mfu_pct.read(rec) == pytest.approx(
        2 * 128 * 127.964e9 / (1.0 * 67e12) * 100)
    # K7's Mish and leaky launches, 0.040 s over 2 calls, against the
    # bytes at 3.35 TB/s
    assert yolov4_epilogue_roofline_pct.read(rec) == pytest.approx(
        124.633e9 / 3.35e12 / 0.020 * 100)


def test_readers_report_nothing_without_their_facts():
    rec = _record()
    no_k7 = dict(rec, ops=[o for o in rec["ops"]
                           if "epilogue_kernel" not in o["name"]])
    assert yolov4_epilogue_roofline_pct.read(no_k7) is None
    no_bytes = {k: v for k, v in rec.items() if "bytes" not in k}
    assert yolov4_epilogue_roofline_pct.read(no_bytes) is None
    no_conv = dict(rec, ops=[o for o in rec["ops"] if not is_conv(o)])
    assert yolov4_conv_mfu_pct.read(no_conv) is None
    assert yolov4_nonconv_ms_per_step.read(no_conv) is None
    no_flops = {k: v for k, v in rec.items() if "flops" not in k}
    assert yolov4_conv_mfu_pct.read(no_flops) is None
    assert yolov4_step_mfu_pct.read(no_flops) is None
