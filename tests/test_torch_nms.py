"""The port's NMS (tpu_mot_torch.ops.nms) against the JAX package's
(tpu_mot.ops.nms) fed the same boxes and scores: indices and valid flags
equal slot for slot, ties included (the top-K prefilter keeps the lower
index first among equal scores, as jax.lax.top_k does), for one frame and
for a batch of frames against per-frame JAX calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_detector import _nms_oracle
from tpu_mot.ops import nms as j_nms
from tpu_mot_torch.ops import nms as t_nms

torch.set_num_threads(1)


def run_both(name, boxes, scores, *args, classes=None, **kw):
    """(port (idx, valid), JAX (idx, valid)) of ops.nms.<name>; the port
    takes the whole batch when boxes has a leading axis, JAX each frame."""
    extra = () if classes is None else (classes,)
    got = getattr(t_nms, name)(torch.as_tensor(boxes), torch.as_tensor(scores),
                               *(torch.as_tensor(c) for c in extra), *args,
                               **kw)
    got = tuple(g.numpy() for g in got)
    fn = getattr(j_nms, name)
    if scores.ndim == 1:
        want = fn(jnp.asarray(boxes), jnp.asarray(scores),
                  *(jnp.asarray(c) for c in extra), *args, **kw)
        return got, tuple(np.asarray(w) for w in want)
    per = [fn(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
              *(jnp.asarray(c[b]) for c in extra), *args, **kw)
           for b in range(scores.shape[0])]
    return got, tuple(np.stack([np.asarray(p[i]) for p in per])
                      for i in range(2))


def assert_same(got, want):
    assert got[0].dtype == np.int32 and got[1].dtype == bool
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def random_boxes(rng, n, lo=50, hi=200, size=(10, 50)):
    return np.concatenate([rng.uniform(lo, hi, (n, 2)),
                           rng.uniform(*size, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("impl", ["nms", "fast_nms"])
def test_oracle_case(impl):
    """tests/test_detector.py:34-44's inputs."""
    rng = np.random.default_rng(0)
    boxes = random_boxes(rng, 40)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    got, want = run_both(impl, boxes, scores, 20, 0.5, 0.1)
    assert_same(got, want)
    if impl == "nms":
        assert got[0][got[1]].tolist() == _nms_oracle(boxes, scores, 0.5,
                                                      0.1)[:20]


@pytest.mark.parametrize("impl", ["nms", "fast_nms"])
@pytest.mark.parametrize("pre_top_k", [None, 100, 599, 600, 700])
def test_prefilter_at_under_over_n(impl, pre_top_k):
    """tests/test_detector.py:47-63's inputs, with pre_top_k under, at and
    over N = 600."""
    rng = np.random.default_rng(3)
    boxes = random_boxes(rng, 600, 50, 400, (10, 60))
    scores = rng.uniform(0, 1, 600).astype(np.float32)
    got, want = run_both(impl, boxes, scores, 16, 0.5, 0.1,
                         pre_top_k=pre_top_k)
    assert_same(got, want)


@pytest.mark.parametrize("pre_top_k", [None, 84])
def test_crowded_scene(pre_top_k):
    """tests/test_detector.py:66-98: the prefilter starves the output, and
    pre_top_k >= N restores exact greedy, in both packages alike."""
    rng = np.random.default_rng(4)
    clusters = []
    for cx in (100.0, 300.0):
        c = np.tile([cx, 100.0, 30.0, 30.0], (40, 1))
        c[:, :2] += rng.uniform(-1, 1, (40, 2))
        clusters.append(c)
    iso = np.array([[60.0, 300, 20, 20], [160, 300, 20, 20],
                    [260, 300, 20, 20], [360, 300, 20, 20]])
    boxes = np.concatenate(clusters + [iso]).astype(np.float32)
    scores = np.concatenate([rng.uniform(0.8, 0.9, 80),
                             np.full(4, 0.5)]).astype(np.float32)
    got, want = run_both("nms", boxes, scores, 4, 0.5, 0.1,
                         pre_top_k=pre_top_k)
    assert_same(got, want)
    assert int(got[1].sum()) == (2 if pre_top_k is None else 4)


@pytest.mark.parametrize("impl", ["greedy", "fast"])
def test_classwise(impl):
    """tests/test_detector.py:101-111, and a seeded multi-class frame."""
    boxes = np.array([[100.0, 100, 20, 20], [102.0, 100, 20, 20]], np.float32)
    scores = np.array([0.9, 0.8], np.float32)
    for cls, n_kept in (([0, 0], 1), ([0, 1], 2)):
        got, want = run_both("nms_classwise", boxes, scores, 4,
                             classes=np.array(cls, np.int32), impl=impl)
        assert_same(got, want)
        assert int(got[1].sum()) == n_kept
    rng = np.random.default_rng(9)
    boxes = random_boxes(rng, 300, 0, 300)
    got, want = run_both("nms_classwise", boxes,
                         rng.uniform(0, 1, 300).astype(np.float32), 32, 0.45,
                         0.2, classes=rng.integers(0, 5, 300).astype(np.int32),
                         impl=impl)
    assert_same(got, want)


@pytest.mark.parametrize("impl", ["nms", "fast_nms"])
@pytest.mark.parametrize("pre_top_k", [None, 200])
def test_exact_ties(impl, pre_top_k):
    """Scores on a grid of 0.1: many equal scores, under the prefilter
    (K = 64 of 200) and without it."""
    rng = np.random.default_rng(11)
    boxes = random_boxes(rng, 200, 50, 250)
    scores = (np.round(rng.uniform(0, 1, 200) * 10) / 10).astype(np.float32)
    scores[[3, 50, 120, 199]] = 0.9          # ties at the top
    got, want = run_both(impl, boxes, scores, 8, 0.3, 0.1,
                         pre_top_k=pre_top_k)
    assert_same(got, want)


@pytest.mark.parametrize("impl", ["nms", "fast_nms"])
def test_fast_nms_invariants_cases(impl):
    """tests/test_detector.py:308-346's inputs: five untruncated frames and
    well-separated boxes."""
    rng = np.random.default_rng(5)
    for _ in range(5):
        boxes = random_boxes(rng, 200, 50, 300)
        scores = rng.uniform(0, 1, 200).astype(np.float32)
        got, want = run_both(impl, boxes, scores, 200, 0.5, 0.1,
                             pre_top_k=200)
        assert_same(got, want)
    boxes = np.array([[50, 50, 10, 10], [150, 50, 10, 10], [50, 150, 10, 10]],
                     np.float32)
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    got, want = run_both(impl, boxes, scores, 4, 0.5, 0.1)
    assert_same(got, want)


@pytest.mark.parametrize("name,kw", [("nms", {}), ("fast_nms", {}),
                                     ("nms_classwise", dict(impl="greedy")),
                                     ("nms_classwise", dict(impl="fast"))])
def test_batch_equals_per_frame_jax(name, kw):
    """A batch of 3 frames in one call against JAX frame by frame; frame 1
    carries exact ties, frame 2 no score above the threshold."""
    rng = np.random.default_rng(21)
    boxes = np.stack([random_boxes(rng, 500, 0, 400) for _ in range(3)])
    scores = rng.uniform(0, 1, (3, 500)).astype(np.float32)
    scores[1] = np.round(scores[1] * 4) / 4
    scores[2] *= 0.1
    classes = rng.integers(0, 3, (3, 500)).astype(np.int32)
    got, want = run_both(name, boxes, scores, 24, 0.45, 0.3,
                         classes=classes if name == "nms_classwise" else None,
                         **kw)
    assert got[0].shape == (3, 24)
    assert_same(got, want)
    assert not got[1][2].any()
