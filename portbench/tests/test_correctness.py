"""The comparison that decides `correct`, at tiny sizes: the program
passes, the control (the reference in TF32 in the program's place) fails,
and a run with the timed path broken underneath reports correct false,
once for each fault the cells can have."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run
from portbench.tests import tiny

CELLS = ("tiny-serve", "tiny-detect")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tiny.checkout(tmp_path_factory.mktemp("bench"))
    tiny.tiny_serve(r, "tiny-serve")
    tiny.tiny_detect(r, "tiny-detect")
    return r


def _driver(root, cell, seed, device, calls=6):
    import importlib

    spec = run.load_cell(json.loads((root / "BENCHMARK.json").read_text()),
                         cell, root)
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


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(root, cell):
    drv = _driver(root, cell, 2 ** 31 + 5, torch.device("cpu"))
    assert _failed(drv.check()) == []
    assert _failed(drv.check("control")) != []


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(root, cell, card):
    for seed in (11, 12, 13):
        drv = _driver(root, cell, seed, card)
        assert _failed(drv.check()) == []
        assert _failed(drv.check("control")) != []


def _state_unchanged(real):
    def step(banks, *a):
        return banks, real(banks, *a)[1]
    return step


def _half_streams(real):
    """Only the first half of the streams is stepped; the others get the
    first stream's results."""
    from tpu_mot_torch.tracker.bank import map_bank

    def step(banks, frames, dets, valid, cfg):
        s = frames.shape[0]
        h = (s + 1) // 2
        nb, out = real(map_bank(lambda x: x[:h], banks), frames[:h],
                       dets[:h], valid[:h], cfg)
        idx = torch.cat([torch.arange(h),
                         torch.zeros(s - h, dtype=torch.long)])
        return map_bank(lambda x: x[idx], nb), type(out)(*[x[idx]
                                                           for x in out])
    return step


def _answer_altered(real):
    def step(*a):
        nb, out = real(*a)
        return nb, out._replace(boxes=out.boxes + 0.5)
    return step


def _detections_altered(real):
    def detect(*a, **k):
        dets, valid, cls = real(*a, **k)
        return dets + torch.tensor([0.5, 0, 0, 0, 0]), valid, cls
    return detect


FAULTS = [("tiny-serve", "multi_stream_step", _state_unchanged),
          ("tiny-serve", "multi_stream_step", _half_streams),
          ("tiny-serve", "multi_stream_step", _answer_altered),
          ("tiny-detect", "multi_stream_step", _state_unchanged),
          ("tiny-detect", "multi_stream_step", _half_streams),
          ("tiny-detect", "multi_stream_step", _answer_altered),
          ("tiny-detect", "detect_batch", _detections_altered)]


@pytest.mark.parametrize("cell,where,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, _, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, cell, where, fault,
                                            monkeypatch, capsys):
    from tpu_mot_torch.models import detector
    from tpu_mot_torch.parallel import serve

    mod = serve if where == "multi_stream_step" else detector
    monkeypatch.setattr(mod, where, fault(getattr(mod, where)))
    rc = run.main(["--workload", cell, "--seed", "3000000019", "--seconds",
                   "1", "--trace", "0", "--device", "cpu", "--bench",
                   str(root / "BENCHMARK.json")])
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
