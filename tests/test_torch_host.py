"""The port's host side against the JAX package's on the CPU: the MOT file
readers and writer (data/mot.py), the native runtime (native/, built and
fallback backends), video ingest and drawing (data/video.py, utils/viz.py;
skipped without OpenCV, as tests/test_mot16_path.py does), the detection
and single-object metrics (utils/metrics.py) and checkpoints
(utils/checkpoint.py).  Every comparison is exact unless it says otherwise.
"""

import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_mot import native as j_native
from tpu_mot.data import mot as j_mot
from tpu_mot.utils import checkpoint as j_ckpt
from tpu_mot.utils import metrics as j_metrics
from tpu_mot_torch import interop
from tpu_mot_torch import native as t_native
from tpu_mot_torch.config import TrackerConfig
from tpu_mot_torch.data import mot as t_mot
from tpu_mot_torch.data import synthetic
from tpu_mot_torch.ops import assignment as t_assign
from tpu_mot_torch.tracker import bank as t_bank
from tpu_mot_torch.tracker import scan
from tpu_mot_torch.utils import checkpoint as t_ckpt
from tpu_mot_torch.utils import metrics as t_metrics
from test_torch_tracker import _jax_bank


@pytest.fixture(scope="module")
def mot_files(tmp_path_factory):
    """det.txt (with a garbage line, a short row and a frame gap) and a
    MOT16 gt.txt (inactive rows, other classes, low visibility)."""
    root = tmp_path_factory.mktemp("mot")
    rng = np.random.default_rng(0)
    det = root / "det.txt"
    with open(det, "w") as f:
        for fi in (1, 2, 4, 5):
            for _ in range(rng.integers(1, 6)):
                x, y, w, h = rng.uniform(0, 300, 4)
                f.write(f"{fi},-1,{x:.2f},{y:.2f},{w:.2f},{h:.2f},"
                        f"{rng.uniform(-1, 1):.3f},-1,-1,-1\n")
    gt = root / "gt.txt"
    with open(gt, "w") as f:
        for fi in range(1, 7):
            for k in range(5):
                x, y, w, h = rng.uniform(0, 300, 4)
                f.write(f"{fi},{k + 1},{x:.2f},{y:.2f},{w:.2f},{h:.2f},"
                        f"{int(rng.integers(0, 2))},"
                        f"{int(rng.choice([1, 2, 3, 7]))},"
                        f"{rng.uniform(0, 1):.2f}\n")
    return str(det), str(gt)


def test_mot_readers_match_jax(mot_files):
    det, gt = mot_files
    for kw in ({}, {"score_min": 0.0}):
        got, want = t_mot.load_mot_dets(det, **kw), j_mot.load_mot_dets(
            det, **kw)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for kw in ({}, {"min_visibility": 0.5}, {"pedestrian_only": False},
               {"n_frames": 9}):
        got, want = t_mot.load_mot_gt(gt, **kw), j_mot.load_mot_gt(gt, **kw)
        assert len(got) == len(want)
        for (gi, gb), (wi, wb) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gb, wb)
    b = np.random.default_rng(1).uniform(1, 50, (7, 4)).astype(np.float32)
    np.testing.assert_array_equal(t_mot.tlwh_to_cxcywh(b),
                                  j_mot.tlwh_to_cxcywh(b))
    np.testing.assert_array_equal(t_mot.cxcywh_to_tlwh(b),
                                  j_mot.cxcywh_to_tlwh(b))


def test_mot_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    tracks = [[(int(rng.integers(1, 99)), tuple(rng.uniform(5, 90, 4)),
                float(rng.random())) for _ in range(rng.integers(0, 4))]
              for _ in range(6)]
    t_mot.write_mot_results(str(tmp_path / "t" / "res.txt"), tracks)
    j_mot.write_mot_results(str(tmp_path / "j" / "res.txt"), tracks)
    assert ((tmp_path / "t" / "res.txt").read_text()
            == (tmp_path / "j" / "res.txt").read_text())


@pytest.fixture(params=["built", "fallback"])
def backend(request, monkeypatch):
    """The port's native module with its library (built by g++ into
    tpu_mot_torch/_build/) or with none (every entry point's Python
    fallback)."""
    if request.param == "built":
        if not t_native.ensure_built():
            pytest.skip("g++ unavailable: the native library was not built")
    else:
        monkeypatch.setattr(t_native, "_lib", None)
        monkeypatch.setattr(t_native, "_load", lambda: False)
        monkeypatch.setattr(t_native, "ensure_built", lambda *a: False)
        assert not t_native.available()
    return request.param


def test_native_entry_points_match_jax(backend, mot_files):
    j_native.ensure_built()
    rng = np.random.default_rng(3)
    for shape in [(5, 5), (12, 7), (7, 12), (40, 40), (1, 1), (3, 3)]:
        cost = rng.uniform(0, 2, shape)
        feasible = (rng.random(shape) > 0.3 if shape != (3, 3)
                    else np.zeros(shape, bool))
        np.testing.assert_array_equal(t_native.assign(cost, feasible),
                                      j_native.assign(cost, feasible))
        np.testing.assert_array_equal(
            t_native.assign(cost, feasible),
            t_assign.scipy_assign(cost, feasible))
    np.testing.assert_array_equal(t_native.parse_mot_csv(mot_files[0]),
                                  j_native.parse_mot_csv(mot_files[0]))
    bgr = rng.integers(0, 256, (17, 31, 3), np.uint8)
    np.testing.assert_array_equal(t_native.bgr_to_gray(bgr),
                                  j_native.bgr_to_gray(bgr))


def test_native_builds_into_the_build_dir():
    if not t_native.ensure_built():
        pytest.skip("g++ unavailable: the native library was not built")
    path = t_native.lib_path()
    assert path.is_file() and path.parent == t_native.BUILD_DIR
    assert t_native.build() == (path, 0.0)          # reused, not rebuilt
    ring = t_native.FrameRing(capacity=2, frame_bytes=16)
    frames = [np.full(16, i, np.uint8) for i in range(3)]
    assert ring.push(frames[0]) and ring.push(frames[1])
    assert not ring.push(frames[2]) and len(ring) == 2
    np.testing.assert_array_equal(ring.pop((16,)), frames[0])
    with pytest.raises(ValueError, match="geometry"):
        ring.pop((8,))


@pytest.mark.parametrize("impl", ["built", "fallback"])
def test_stream_scheduler_matches_jax(impl, monkeypatch):
    """tests/test_native.py's scheduler script on both packages: the same
    batches, freshness and counters."""
    if impl == "built" and not t_native.ensure_built():
        pytest.skip("g++ unavailable: the native library was not built")
    if impl == "fallback":
        monkeypatch.setattr(t_native, "ensure_built", lambda *a: False)
        monkeypatch.setattr(j_native, "ensure_built", lambda *a: False)

    def script(mod):
        sched = mod.StreamScheduler(3, frame_shape=(4, 6), capacity=2)
        f = lambda v: np.full((4, 6), v, np.uint8)   # noqa: E731
        out = [sched.push(0, f(1)), sched.push(1, f(2)), sched.gather(),
               sched.push(2, f(3)), sched.gather(), sched.push(0, f(10)),
               sched.push(2, f(30)), sched.gather(), sched.push(0, f(41)),
               sched.push(0, f(42)), sched.push(0, f(43)),
               sched.push(7, f(0)), sched.gather(), sched.gather()]
        return sched._native, out, sched.stats()

    t_nat, t_out, t_stats = script(t_native)
    j_nat, j_out, j_stats = script(j_native)
    assert t_nat == j_nat == (impl == "built")
    assert t_stats == j_stats
    for a, b in zip(t_out, j_out):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
        else:
            assert a == b


def test_stream_scheduler_threaded_producers():
    """tests/test_native.py:129 on the port: decoders on threads at uneven
    rates; complete batches, each stream's frames in order."""
    if not t_native.ensure_built():
        pytest.skip("g++ unavailable: the native library was not built")
    n_streams, n_frames = 4, 50
    sched = t_native.StreamScheduler(n_streams, frame_shape=(2, 2),
                                     capacity=n_frames)

    def producer(sid):
        for k in range(n_frames):
            frame = np.full((2, 2), (sid * n_frames + k) % 251, np.uint8)
            assert sched.push(sid, frame)
            time.sleep(0.0005 * (sid + 1))

    threads = [threading.Thread(target=producer, args=(s,))
               for s in range(n_streams)]
    for t in threads:
        t.start()
    seen = [[] for _ in range(n_streams)]
    deadline = time.monotonic() + 60.0
    while (not all(len(v) >= n_frames for v in seen)
           and time.monotonic() < deadline):
        got = sched.gather()
        if got is None:
            time.sleep(0.001)
            continue
        batch, fresh = got
        for s in range(n_streams):
            if fresh[s]:
                seen[s].append(int(batch[s, 0, 0]))
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for s in range(n_streams):
        assert seen[s][:n_frames] == [(s * n_frames + k) % 251
                                      for k in range(n_frames)]


def test_video_and_viz_match_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    from tpu_mot.data import video as j_video
    from tpu_mot.utils import viz as j_viz
    from tpu_mot_torch.data import video as t_video
    from tpu_mot_torch.utils import viz as t_viz

    rng = np.random.default_rng(4)
    frames = (rng.random((9, 48, 64)) * 255).astype(np.uint8)
    tracks = [[(3, (20.0, 20.0, 10.0, 12.0), 0.9, 2)],
              [(14, (30.0, 25.0, 8.0, 8.0), 0.5)]] * 4 + [[]]
    for i, (fr, tr) in enumerate(zip(frames[:3], tracks)):
        np.testing.assert_array_equal(t_viz.draw_tracks(fr, tr),
                                      j_viz.draw_tracks(fr, tr))
    assert t_viz.id_color(25) == j_viz.id_color(25)
    path = str(tmp_path / "v.mp4")
    t_viz.write_video(path, zip(frames, tracks), fps=10)
    got, want = t_video.read_video(path), j_video.read_video(path)
    assert got.shape == (9, 48, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_video.read_video(path, limit=4),
                                  want[:4])
    chunks = list(t_video.ChunkedVideoPipeline(got, chunk=4))
    assert [len(c) for c in chunks] == [4, 4, 1]
    np.testing.assert_array_equal(np.concatenate(chunks), got)
    assert cv2.imwrite(str(tmp_path / "a.png"), frames[0])

    def broken():
        yield frames[0]
        raise IOError("decode failed")

    with pytest.raises(IOError, match="decode failed"):
        list(t_video.ChunkedVideoPipeline(broken(), chunk=4))


def test_load_image_sequence_matches_jax(tmp_path):
    cv2 = pytest.importorskip("cv2")
    frames = (np.random.default_rng(5).random((4, 20, 30)) * 255).astype(
        np.uint8)
    for i, f in enumerate(frames, start=1):
        cv2.imwrite(str(tmp_path / f"{i:06d}.png"), f)
    (tmp_path / "notes.txt").write_text("not an image")
    for kw in ({}, {"limit": 2}, {"gray": False}):
        got = t_mot.load_image_sequence(str(tmp_path), **kw)
        np.testing.assert_array_equal(
            got, j_mot.load_image_sequence(str(tmp_path), **kw))
    np.testing.assert_array_equal(t_mot.load_image_sequence(str(tmp_path)),
                                  frames)


def test_detection_map_hand_cases():
    """tests/test_train.py:93's hand cases on the port."""
    dm = t_metrics.detection_map
    g = [30.0, 30.0, 10.0, 10.0]
    far = [80.0, 80.0, 10.0, 10.0]
    assert dm([([g], [0.9], [0])], [([g], [0])], num_classes=1)["map"] == 1
    assert dm([([g, far], [0.9, 0.8], [0, 0])], [([g], [0])], 1)["map"] == 1
    np.testing.assert_allclose(
        dm([([far, g], [0.9, 0.8], [0, 0])], [([g], [0])], 1)["map"], 0.5)
    np.testing.assert_allclose(
        dm([([g], [0.9], [0])], [([g, far], [0, 0])], 1)["map"], 0.5)
    m = dm([([g], [0.9], [0])], [([g, far], [0, 1])], 2)
    np.testing.assert_allclose(m["map"], 0.5)
    assert m["ap_per_class"] == [1.0, 0.0]
    np.testing.assert_allclose(
        dm([([g, g], [0.9, 0.8], [0, 0])], [([g], [0])], 1)["map"], 1.0)


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    preds, gts = [], []
    for _ in range(7):
        gb = rng.uniform(10, 90, (rng.integers(0, 6), 4))
        gc = rng.integers(0, 3, len(gb))
        jitter = gb + rng.normal(0, 3, gb.shape)
        extra = rng.uniform(10, 90, (rng.integers(0, 4), 4))
        pb = np.concatenate([jitter, extra])
        preds.append((pb, rng.random(len(pb)),
                      np.concatenate([gc, rng.integers(0, 3, len(extra))])))
        gts.append((gb, gc))
    for thr in (0.3, 0.5):
        assert (t_metrics.detection_map(preds, gts, 3, iou_thr=thr)
                == j_metrics.detection_map(preds, gts, 3, iou_thr=thr))
    gt = rng.uniform(20, 80, (50, 4))
    pr = gt + rng.normal(0, 8, gt.shape)
    assert (t_metrics.otb_precision(gt, pr, thresholds=(5.0, 20.0))
            == j_metrics.otb_precision(gt, pr, thresholds=(5.0, 20.0)))


def small_bank(device="cpu"):
    """A port bank after 6 frames of a small synthetic clip (every field
    populated, the KCF spectra complex)."""
    cfg = TrackerConfig(max_tracks=8, max_detections=8, frame_height=96,
                        frame_width=128)
    objs = synthetic.make_objects(4, 96, 128, np.random.default_rng(0))
    frames, boxes, vis = synthetic.render_sequence(objs, 6, 96, 128, seed=0)
    dets = synthetic.detections_from_gt(boxes, vis, seed=0,
                                        frame_hw=(96, 128))
    bank, _, _ = scan.track_sequence(frames, dets, cfg, device=device)
    return cfg, bank


def assert_banks_equal(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name == "kcf":
            for u, v in zip(x, y):
                assert torch.equal(u, v)
        else:
            assert torch.equal(x, y), name


def test_checkpoint_npz_round_trip(tmp_path):
    cfg, bank = small_bank()
    det = {"ConvBlock_0.conv.weight": torch.randn(4, 3, 3, 3),
           "head0.conv.bias": torch.randn(4)}
    path = str(tmp_path / "snap.npz")
    t_ckpt.save_pipeline(path, bank, det, cfg)
    with np.load(path) as data:
        assert "['bank'].kcf.xf.re" in data.files
        assert "['detector']['head0.conv.bias']" in data.files
    like = t_bank.empty_bank(cfg, device="cpu")
    got, got_det, got_cfg = t_ckpt.load_pipeline(
        path, like, {k: torch.zeros_like(v) for k, v in det.items()})
    assert_banks_equal(got, bank)
    assert all(torch.equal(got_det[k], det[k]) for k in det)
    assert got_cfg == cfg
    # The directory form, and resuming from it equals not stopping.
    t_ckpt.save_pipeline(str(tmp_path / "dir"), bank, det, cfg)
    got, got_det, got_cfg = t_ckpt.load_pipeline(str(tmp_path / "dir"),
                                                 like)
    assert_banks_equal(got, bank)
    assert got_cfg == cfg and torch.equal(got_det["head0.conv.bias"],
                                          det["head0.conv.bias"])


def test_jax_npz_bank_loads_into_the_port(tmp_path):
    """A TrackBank snapshot written by the JAX package's save_pytree (.npz)
    loads into the port with the same flat keys and equals
    interop.bank_from_jax of that bank; the port's snapshot loads into
    JAX's."""
    cfg, bank = small_bank()
    jbank = jax.tree.map(jnp.asarray, _jax_bank(interop.bank_to_numpy(bank)))
    path = str(tmp_path / "jax.npz")
    j_ckpt.save_pytree(path, {"bank": jbank})
    like = {"bank": t_bank.empty_bank(cfg, device="cpu")}
    got = t_ckpt.load_pytree(path, like)["bank"]
    assert_banks_equal(got, interop.bank_from_jax(jbank))
    assert_banks_equal(got, bank)
    t_ckpt.save_pytree(str(tmp_path / "port.npz"), {"bank": bank})
    back = j_ckpt.load_pytree(str(tmp_path / "port.npz"), {"bank": jbank})
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jbank)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_foreign_directories(tmp_path):
    """A JAX pickle directory (state.pkl) loads; an orbax directory, the
    JAX package's default, raises with a way out."""
    tree = {"a": np.arange(3, dtype=np.float32), "b": {"c": np.ones(2)}}
    os.makedirs(tmp_path / "pkl")
    import pickle
    with open(tmp_path / "pkl" / "state.pkl", "wb") as f:
        pickle.dump(tree, f)
    got = t_ckpt.load_pytree(str(tmp_path / "pkl"))
    assert torch.equal(got["a"], torch.arange(3, dtype=torch.float32))
    j_ckpt.save_pytree(str(tmp_path / "orbax"), tree)
    with pytest.raises(ValueError, match="orbax"):
        t_ckpt.load_pytree(str(tmp_path / "orbax"))
    with pytest.raises(FileNotFoundError):
        t_ckpt.load_pytree(str(tmp_path / "pkl" / "missing"))
