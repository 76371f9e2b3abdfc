"""The harness on the CPU: discovery by name, the generator, the window's
statistics, and what a run loads."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import gen, run
from portbench.tests import tiny


def _run(root, cell, *extra, seconds=3, trace=0):
    out = subprocess.run(
        [sys.executable, str(root / "portbench" / "run.py"), "--workload",
         cell, "--seed", "4000000007", "--seconds", str(seconds), "--trace",
         str(trace), "--device", "cpu", *extra],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
             "HOME": str(root), "TMPDIR": str(root)})
    return out


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny.checkout(tmp_path)
    cell = tiny.tiny_serve(root, "added-cell")
    (root / "portbench" / "metrics" / "traced_calls.py").write_text(
        "def read(rec):\n    return rec.get('calls') or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="traced_calls", unit="calls", better="higher",
        source="device_trace", layer="harness", moves="frames_per_s",
        workloads=[cell]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(root, cell, seconds=4, trace=1)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["traced_calls"]["value"] >= 1
    assert list(res)[-1] == "checks"


def test_generator_repeats_from_the_seed_and_differs_by_stream():
    kw = dict(n_frames=4, height=96, width=128, n_obj=6, min_size=24,
              max_size=40, max_speed=3.0, noise=0.01, max_dets=8,
              device="cpu")
    a = gen.render(2 ** 31 + 11, n_streams=3, **kw)
    b = gen.render(2 ** 31 + 11, n_streams=3, **kw)
    c = gen.render(2 ** 31 + 11, n_streams=2, **kw)
    d = gen.render(2 ** 31 + 12, n_streams=3, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # A stream is the same whatever the number of streams beside it.
    assert torch.equal(a.frames[:, :2], c.frames)
    assert not torch.equal(a.frames[:, 0], a.frames[:, 1])
    assert not torch.equal(a.frames, d.frames)
    assert a.frames.dtype == torch.uint8
    assert bool(a.valid[..., :6].all()) and not bool(a.valid[..., 6:].any())


def test_replay_turns_at_the_clip_ends():
    assert [gen.replay_index(i, 4) for i in range(9)] == [0, 1, 2, 3, 2, 1,
                                                          0, 1, 2]


def test_rate_and_tail_both_move_with_a_stall():
    calls = [(i * 0.03, i * 0.03 + 0.025, 256) for i in range(400)]
    base = run.window_metrics(calls, 0.0, calls[-1][1])
    stalled = list(calls)
    # One stalled call in ten: 200 ms instead of 25.
    shift = 0.0
    for i, (s, e, n) in enumerate(calls):
        s, e = s + shift, e + shift
        if i % 10 == 7:
            shift += 0.175
            e += 0.175
        stalled[i] = (s, e, n)
    hit = run.window_metrics(stalled, 0.0, stalled[-1][1])
    assert hit["frames_per_s"] < base["frames_per_s"] * 0.9
    assert hit["frame_ms_p95"] > base["frame_ms_p95"] * 4
    assert base["frame_ms_p95"] == pytest.approx(25.0)


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert run.percentile(vals, 95) == 95
    assert run.percentile([5.0], 95) == 5.0


def test_a_cpu_run_loads_no_jax_and_the_references_no_program(tmp_path):
    root = tiny.checkout(tmp_path)
    cell = tiny.tiny_serve(root)
    probe = (
        "import runpy, sys; sys.argv = ['run.py', '--workload', %r, "
        "'--seed', '7', '--seconds', '2', '--trace', '0', '--device', "
        "'cpu'];\n"
        "try:\n    runpy.run_path('portbench/run.py', run_name='__main__')\n"
        "except SystemExit as e:\n    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'tpu_mot'))\n"
        "assert not bad, bad\n"
        "assert 'tpu_mot_torch' in sys.modules\n") % cell
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    refs = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.tracker, portbench.reference.yolo;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tpu_mot', 'tpu_mot_torch')];"
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", refs], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    root = tmp_path / "bare"
    root.mkdir()
    import shutil
    shutil.copytree(tiny.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(tiny.REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    out = _run(root, "serve-1080p-s256")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
