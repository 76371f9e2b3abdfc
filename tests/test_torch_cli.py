"""The port's CLI (tpu_mot_torch.cli, `python -m tpu_mot_torch`) against
the JAX package's (tpu_mot.cli) on the CPU: both on the same MOT16-format
directory (tests/test_mot16_path.py's fixture), `mot` result files equal
(ids, and every box within 0.05 px), `eval`'s per-sequence and OVERALL
lines equal but for fps, `mot --synthetic --score` metrics equal, and
`video --det-stride 3` running.  The card's run (chip_smoke.py's cli phase)
is held to the JAX CLI's MOTA on the synthetic fixture at full size,
recorded in tests/golden/cli_jax_v1.json: `python tests/test_torch_cli.py
regen-cli-golden` rewrites it (JAX on the CPU, ~1 min).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tpu_mot import cli as j_cli  # noqa: E402
from tpu_mot_torch import cli as t_cli  # noqa: E402
from tpu_mot_torch.data import synthetic  # noqa: E402

CLI_GOLDEN = REPO / "tests" / "golden" / "cli_jax_v1.json"
SYNTH_ARGS = ["mot", "--synthetic", "--objects", "128", "--frames", "64",
              "--max-dets", "160", "--score"]
SMALL = ["--max-tracks", "16", "--max-dets", "16"]


@pytest.fixture(scope="module")
def mot_dir(tmp_path_factory):
    """tests/test_mot16_path.py:17-45's sequence directory (8 objects, 20
    frames of 240 x 320): img1/ JPEGs, det/det.txt, gt/gt.txt."""
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("MOT16-99")
    for d in ("img1", "det", "gt"):
        (root / d).mkdir()
    objs = synthetic.make_objects(8, 240, 320, np.random.default_rng(0),
                                  max_speed=2.0)
    frames, boxes, vis = synthetic.render_sequence(objs, 20, 240, 320,
                                                   seed=0)
    dets = synthetic.detections_from_gt(boxes, vis, seed=0,
                                        frame_hw=(240, 320))
    with open(root / "det" / "det.txt", "w") as f:
        for fi, d in enumerate(dets, start=1):
            for cx, cy, w, h, s in d:
                f.write(f"{fi},-1,{cx - w / 2:.2f},{cy - h / 2:.2f},"
                        f"{w:.2f},{h:.2f},{s:.3f},-1,-1,-1\n")
    with open(root / "gt" / "gt.txt", "w") as f:
        for fi in range(1, 21):
            for k in np.where(vis[fi - 1])[0]:
                cx, cy, w, h = boxes[fi - 1, k]
                f.write(f"{fi},{k + 1},{cx - w / 2:.2f},{cy - h / 2:.2f},"
                        f"{w:.2f},{h:.2f},1,1,1.0\n")
    for i, fr in enumerate(frames, start=1):
        cv2.imwrite(str(root / "img1" / f"{i:06d}.jpg"),
                    (fr * 255).astype(np.uint8))
    return root


def run_both(capsys, args, port_args=("--device", "cpu")):
    """(port's stdout lines, JAX's stdout lines) of one command."""
    assert t_cli.main(args + list(port_args)) == 0
    port = capsys.readouterr().out.splitlines()
    assert j_cli.main(args) == 0
    return port, capsys.readouterr().out.splitlines()


def json_lines(lines, drop=("fps",)):
    return [{k: v for k, v in json.loads(ln).items() if k not in drop}
            for ln in lines if ln.startswith("{")]


def test_mot_sequence_results_match_jax(mot_dir, tmp_path, capsys):
    res = {}
    for who, main, extra in (("port", t_cli.main, ["--device", "cpu"]),
                             ("jax", j_cli.main, [])):
        out = str(tmp_path / f"{who}.txt")
        assert main(["mot", "--seq", str(mot_dir), "--out", out, "--score",
                     *SMALL, *extra]) == 0
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("tracked 20 frames in ")
        assert lines[1] == f"wrote {out}"
        res[who] = (np.loadtxt(out, delimiter=",", ndmin=2),
                    json_lines(lines))
    (p, pm), (j, jm) = res["port"], res["jax"]
    assert p.shape == j.shape and p.shape[1] == 10
    np.testing.assert_array_equal(p[:, :2], j[:, :2])        # frame, id
    assert np.abs(p[:, 2:6] - j[:, 2:6]).max() <= 0.05
    np.testing.assert_array_equal(p[:, 6:], j[:, 6:])
    assert pm == jm and pm[0]["mota"] > 0.7


def test_eval_lines_match_jax(mot_dir, tmp_path, capsys):
    root = tmp_path / "train"
    root.mkdir()
    shutil.copytree(mot_dir, root / "SEQ-01")
    shutil.copytree(mot_dir, root / "SEQ-02")
    port, jax_ = run_both(capsys, ["eval", "--root", str(root), "--out-dir",
                                   str(tmp_path / "res"), *SMALL])
    assert [r["seq"] for r in json_lines(port)] == ["SEQ-01", "SEQ-02",
                                                     "OVERALL"]
    assert json_lines(port) == json_lines(jax_)
    assert (tmp_path / "res" / "SEQ-02.txt").is_file()


def test_mot_synthetic_metrics_match_jax(capsys):
    port, jax_ = run_both(capsys, ["mot", "--synthetic", "--objects", "6",
                                   "--frames", "24", "--score"])
    assert json_lines(port) == json_lines(jax_)
    assert port[0].startswith("tracked 24 frames in ")


def test_mot_synthetic_full_size_matches_golden(capsys):
    """The card's CLI run on the CPU: the metrics line of the JAX CLI's run
    (tests/golden/cli_jax_v1.json) exactly."""
    want = json.loads(CLI_GOLDEN.read_text())
    assert want["args"] == SYNTH_ARGS
    assert t_cli.main(SYNTH_ARGS + ["--device", "cpu"]) == 0
    assert json_lines(capsys.readouterr().out.splitlines()) == [
        want["metrics"]]


def test_video_strided_runs(tmp_path, capsys):
    pytest.importorskip("cv2")
    from tpu_mot_torch.utils.viz import write_video

    frames = (np.random.default_rng(0).random((6, 96, 128)) * 255).astype(
        np.uint8)
    path = str(tmp_path / "clip.mp4")
    write_video(path, [(f, []) for f in frames], fps=10)
    out_path = str(tmp_path / "annotated.mp4")
    assert t_cli.main(["video", "--input", path, "--model", "yolov2-tiny",
                       "--classes", "1", "--det-stride", "3", "--max-dets",
                       "8", "--max-tracks", "8", "--chunk", "6",
                       "--video-out", out_path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "detect+track 6 frames in " in out and os.path.isfile(out_path)


def test_python_m_and_no_card(tmp_path):
    """`python -m tpu_mot_torch` runs the CLI; without a card and without
    --device it fails instead of falling back to the CPU."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    ok = subprocess.run([sys.executable, "-m", "tpu_mot_torch", "mot",
                         "--synthetic", "--objects", "3", "--frames", "4",
                         "--device", "cpu", "--score"], cwd=tmp_path,
                        env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout.splitlines()[-1])["n_gt"] > 0
    import torch
    if torch.cuda.is_available():
        return
    bad = subprocess.run([sys.executable, "-m", "tpu_mot_torch", "mot",
                          "--synthetic", "--frames", "2"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode != 0 and "no CUDA card" in bad.stderr


def regen_cli_golden():
    """The JAX CLI's metrics line on SYNTH_ARGS -> CLI_GOLDEN."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert j_cli.main(SYNTH_ARGS) == 0
    metrics = json_lines(buf.getvalue().splitlines())
    assert len(metrics) == 1
    CLI_GOLDEN.write_text(json.dumps({
        "args": SYNTH_ARGS, "metrics": metrics[0],
        "source": "tpu_mot.cli on the CPU (JAX_PLATFORMS=cpu); "
                  "python tests/test_torch_cli.py regen-cli-golden"},
        indent=1) + "\n")
    print(f"wrote {CLI_GOLDEN}: {metrics[0]}")


if __name__ == "__main__":
    if sys.argv[1:] == ["regen-cli-golden"]:
        import jax
        jax.config.update("jax_platforms", "cpu")
        regen_cli_golden()
    else:
        sys.exit("usage: python tests/test_torch_cli.py regen-cli-golden")
