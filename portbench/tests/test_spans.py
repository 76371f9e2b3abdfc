"""The program's spans in a traced run (`portbench/spans.py`), on a
hand-made timing capture."""

from __future__ import annotations

import copy
import json

import pytest

from portbench import run, spans, tracing
from portbench.tests import tiny


def _events(program_spans=True, planted=False, drift=0.0):
    """A hand-made timing capture (microseconds) on one thread: a call the
    reduction skips, a traced call holding the program's spans and three
    launches, each op starting at its launch, and the fetch's copy after
    it.  The card is idle over [100, 115], [125, 150], [160, 186],
    [190, 202] and [205, 210]; `drift` moves every device time."""
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "pid": 1, "tid": 7}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    evs = [x("user_annotation", "portbench.call", 0, 50),
           x("user_annotation", "portbench.call", 100, 100),
           x("user_annotation", "portbench.fetch", 200, 10),
           x("cuda_runtime", "cudaLaunchKernel", 115, 1, 1),
           x("kernel", "kalman_kernel", 115 + drift, 10, 1),
           x("cuda_runtime", "cudaLaunchKernel", 150, 1, 2),
           x("kernel", "fft_kernel", 150 + drift, 10, 2),
           x("cuda_runtime", "cudaLaunchKernel", 186, 1, 3),
           x("kernel", "copy_kernel", 186 + drift, 4, 3),
           x("cuda_runtime", "cudaMemcpyAsync", 202, 1, 4),
           x("gpu_memcpy", "Memcpy DtoH", 202 + drift, 3, 4)]
    if program_spans:
        evs += [x("user_annotation", "serve.step", 105, 90),
                x("user_annotation", "tracker.step", 106, 88),
                x("user_annotation", "tracker.predict", 110, 20),
                x("user_annotation", "tracker.kcf_detect", 130, 50),
                # Another thread's span is not the serving thread's.
                dict(x("user_annotation", "tracker.cost", 100, 110), tid=8)]
    if planted:
        # Starts 1 us before its launch (inside tracker.kcf_detect).
        evs += [x("cuda_runtime", "cudaLaunchKernel", 170, 1, 5),
                x("kernel", "early_kernel", 169, 1, 5)]
    return evs


def _record(evs):
    return spans.record_of(copy.deepcopy(evs))


@pytest.mark.parametrize("drift", [0.0, -2.0])
def test_idle_time_is_split_between_the_spans_the_host_was_in(drift):
    """Each idle interval goes to the spans the host was in, up to the
    launch that ended it: the same where the device's times run 2 us early
    (every op then starts before its launch)."""
    sp = _record(_events(drift=drift))
    by = sp["by_span"]
    assert list(by) == ["serve.step", "tracker.step", "tracker.predict",
                        "tracker.kcf_detect"]
    # [125, 150] crosses tracker.predict's end at 130: 5 + 20 us.
    assert by["tracker.predict"]["idle_s"] == pytest.approx(10e-6)
    assert by["tracker.kcf_detect"]["idle_s"] == pytest.approx(40e-6)
    assert by["tracker.step"]["idle_s"] == pytest.approx(14e-6)
    assert by["serve.step"]["idle_s"] == pytest.approx(2e-6)
    assert sp["idle_outside_s"] == pytest.approx(17e-6)
    total = sum(d["idle_s"] for d in by.values()) + sp["idle_outside_s"]
    assert total == pytest.approx(83e-6)
    assert sp["ops_before_launch"] == (4 if drift else 0)
    assert sp["before_launch_max_s"] == pytest.approx(-drift * 1e-6)
    assert by["tracker.step"]["self_s"] == pytest.approx(18e-6)
    assert by["tracker.step"]["host_s"] == pytest.approx(88e-6)
    assert all(d["n"] == 1 for d in by.values())
    assert "tracker.cost" not in by


def test_the_idle_under_the_spans_is_the_windows_idle():
    """Idle under the spans plus outside them is the idle time that
    `device_idle_pct` reads from the reduction of the same events."""
    evs = _events()
    rec = tracing.reduce(copy.deepcopy(evs), None)
    sp = _record(evs)
    idle = sum(d["idle_s"] for d in sp["by_span"].values())
    assert idle + sp["idle_outside_s"] == pytest.approx(
        rec["window_s"] - rec["busy_s"])


def test_an_op_goes_to_its_innermost_span_by_its_launch():
    sp = _record(_events())
    by = sp["by_span"]
    assert [by[n]["launches"] for n in by] == [0, 1, 1, 1]
    assert by["tracker.predict"]["device_s"] == pytest.approx(10e-6)
    assert by["tracker.kcf_detect"]["device_s"] == pytest.approx(10e-6)
    assert by["tracker.step"]["device_s"] == pytest.approx(4e-6)
    # The fetch's copy is launched outside every program span.
    assert sp["launches_outside"] == 1


def test_an_op_that_starts_before_its_launch_is_counted():
    sp = _record(_events(planted=True))
    assert sp["ops_before_launch"] == 1
    assert sp["before_launch_max_s"] == pytest.approx(1e-6)
    assert sp["by_span"]["tracker.kcf_detect"]["launches"] == 2


def test_a_capture_without_the_programs_spans_gives_no_spans():
    sp = _record(_events(program_spans=False))
    assert sp["by_span"] == {}
    assert sp["launches_outside"] == 4
    assert spans.record_of(_events()[:1])["by_span"] == {}


@pytest.mark.parametrize("planted", [False, True])
def test_the_programs_spans_change_nothing_the_benchmark_reads(planted):
    """The reduction, and so every metric of BENCHMARK.json read from it,
    is the same with the program's spans in the capture as without."""
    with_spans = tracing.reduce(copy.deepcopy(_events(True, planted)), None)
    without = tracing.reduce(copy.deepcopy(_events(False, planted)), None)
    assert with_spans == without
    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        read = run.metric_reader(m["name"])
        assert read(with_spans) == read(without), m["name"]


def test_the_table_has_a_line_a_span():
    rec = {"calls": 1, "spans": _record(_events())}
    lines = spans.table(rec).splitlines()
    assert [ln.split()[0] for ln in lines[1:5]] == [
        "serve.step", "tracker.step", "tracker.predict",
        "tracker.kcf_detect"]
    assert lines[5].startswith("(outside)")


def test_the_script_prints_the_spans_of_a_traced_run(tmp_path):
    """`spans.py` runs a traced run of a tiny cell on the CPU, prints run.py's
    result line and, on stderr, the record with the tracker's stages."""
    import subprocess
    import sys

    root = tiny.checkout(tmp_path)
    cell = tiny.tiny_serve(root)
    out = subprocess.run(
        [sys.executable, str(root / "portbench" / "spans.py"), "--workload",
         cell, "--seed", "4000000007", "--seconds", "4", "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
             "HOME": str(root), "TMPDIR": str(root)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
    line = next(ln for ln in out.stderr.splitlines()
                if ln.startswith("portbench: spans "))
    by = json.loads(line[len("portbench: spans "):])["spans"]["by_span"]
    assert list(by)[:2] == ["serve.step", "tracker.step"]
    assert by["tracker.kcf_train"]["n"] == by["tracker.step"]["n"] > 0
